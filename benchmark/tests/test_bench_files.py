"""The benchmark's files: ``BENCHMARK.json`` keeps to its format, and
every configuration, traffic mix, model family and per-layer metric it
names is found by its name in a file of its own."""

import json
import os
import re

import pytest

from benchmark.harness import spec

with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert os.path.isfile(os.path.join(spec.ROOT, BENCH["command"][-1]))
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_bounds():
    every = [c["name"] for c in BENCH["configs"]] + WORKLOADS + [
        m["name"] for m in BENCH["end_to_end"]] + METRICS
    assert len(every) == len(set(every))
    for name in every:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_load(workload):
    cell = spec.load_cell(workload, BENCH)
    assert cell.chips == 1
    assert set(cell.config["limits"]) == set(cell.family.NUMBERS)
    assert cell.config["reduced"] == []
    assert os.path.isfile(os.path.join(spec.ROOT, cell.config["checkpoint"]))
    assert cell.family.make_chunk(spec.ROOT, cell, 2 ** 31 + 1, 1).frames \
        == 1
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_and_what_it_moves(metric):
    assert callable(spec.load_reader(metric))
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    for workload in m.get("workloads", WORKLOADS):
        cell = spec.load_cell(workload, BENCH)
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_config_files_name_their_source():
    for c in BENCH["configs"]:
        data = spec.load_json("configs", c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
