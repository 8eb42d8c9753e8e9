"""The harness runs whatever model family a configuration names
(``spec.load_family``): a toy family under ``tests/families`` goes through
the real ``run_cell`` on the CPU, its result line is judged by the toy's
own numbers and limits, and an output altered by one entry comes out as
not correct.  ``cell.py`` itself knows no family."""

import ast
import os
import re
import time

import pytest

from benchmark.harness import cell as cell_lib
from benchmark.harness import spec

TOY_DIR = os.path.join(os.path.dirname(__file__), "families")
# the metrics as BENCHMARK.json would list them
BENCH = {
    "end_to_end": [
        {"name": "frames_per_s", "unit": "frames/s"},
        {"name": "batch_ms_p95", "unit": "ms"},
        {"name": "setup_s", "unit": "s"}],
    "per_layer": [
        {"name": "mfu.serve", "unit": "%"},
        {"name": "idle_share", "unit": "%"},
        {"name": "forward_ms.serve", "unit": "ms",
         "workloads": ["x_headline_b64"]}],
}


def toy_cell():
    return spec.Cell(
        name="toy_b16", chips=1,
        config={"name": "toy", "model": "toy", "dtype": "float32",
                "width": 48, "limits": {"max_gap": 1e-5,
                                        "launch_mismatch": 0}},
        mix={"name": "toy", "chunk": 16, "judge_chunks": 2},
        end_to_end=BENCH["end_to_end"],
        per_layer=[m for m in BENCH["per_layer"]
                   if spec._reports(m, "toy_b16")],
        family=spec.load_family("toy", TOY_DIR))


@pytest.mark.parametrize("trace", [False, True])
def test_a_toy_family_runs_and_is_correct(trace):
    cell = toy_cell()
    result = cell_lib.run_cell(cell, 2 ** 31 + 12345, 0.1, trace,
                               time.perf_counter(), device="cpu")
    assert result["correct"] is True, result["checks"]
    assert list(result["checks"]) == ["max_gap", "launch_mismatch"]
    assert result["checks"]["max_gap"]["limit"] == 1e-5
    assert 0 <= result["checks"]["max_gap"]["value"] <= 1e-5
    assert result["attempted"] > 0 and result["attempted"] % 16 == 0
    if trace:
        # no profiler on the CPU: only the context's own metric is read,
        # and not the metric of another family's cells
        assert set(result["metrics"]) == {"mfu.serve"}
        assert result["metrics"]["mfu.serve"]["value"] > 0
    else:
        assert set(result["metrics"]) == {"frames_per_s", "batch_ms_p95",
                                          "setup_s"}


def test_a_toy_output_altered_by_one_entry_is_not_correct(monkeypatch):
    cell = toy_cell()
    step = cell.family.ToySystem.step

    def altered(self, chunk):
        out = step(self, chunk)
        out[3, 5] += 1e-3
        return out
    monkeypatch.setattr(cell.family.ToySystem, "step", altered)
    result = cell_lib.run_cell(cell, 7, 0.1, False, time.perf_counter(),
                               device="cpu")
    assert result["correct"] is False
    assert result["checks"]["max_gap"]["value"] > 1e-5


@pytest.mark.parametrize("model, directory", [
    ("no-such-model", spec.FAMILIES), ("yolo11-seg", TOY_DIR)])
def test_an_unknown_model_names_the_path_it_looked_for(model, directory):
    path = os.path.join(directory, f"{model}.py")
    with pytest.raises(FileNotFoundError, match=re.escape(path)):
        spec.load_family(model, directory)


def test_cell_knows_no_family():
    path = os.path.join(spec.BENCH, "harness", "cell.py")
    source = open(path).read()
    for word in ("serving", "imgsz", "LetterboxSpec", "PortSystem",
                 "judge_lib", "Reference", "mask_operands", "k1_operands"):
        assert word not in source, word
    imported = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.ImportFrom) and node.module:
            imported |= {f"{node.module}.{a.name}" for a in node.names}
        elif isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
    bench = {n for n in imported if n.startswith("benchmark.")}
    assert bench <= {
        "benchmark.harness.spec", "benchmark.harness.system.Spans",
        "benchmark.harness.roofline.PEAK_FLOPS_PER_S",
        "benchmark.harness.trace.Profiler",
        "benchmark.harness.trace.warm_up"}, bench
