"""Nothing the benchmark runs loads JAX, Flax or the JAX package, and the
reference loads nothing of the program: module names compared by their
whole top-level name (the port's name begins with the JAX package's)."""

import ast
import json
import os
import subprocess
import sys

import pytest

from benchmark.harness.spec import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "lidar_object_detection_tpu"}
PROGRAM = "lidar_object_detection_tpu_torch"


def loaded_after(code: str):
    """The top-level names of the modules loaded by ``code`` in a fresh
    interpreter."""
    script = (f"import sys\nsys.path.insert(0, {ROOT!r})\n{code}\n"
              "import json\nprint(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_no_jax_and_nothing_of_the_program():
    names = loaded_after(
        "import benchmark.reference.system, benchmark.reference.fusion\n"
        "import benchmark.reference.decode, benchmark.reference.yolo\n"
        "import benchmark.reference.msgpack_reader")
    assert not names & (FORBIDDEN | {PROGRAM})
    assert "torch" in names


def test_a_run_loads_no_jax():
    names = loaded_after(
        "import time\n"
        "from benchmark.harness import cell, spec\n"
        "c = spec.load_cell('n_csv_tta_b64')\n"
        "r = cell.run_cell(c, 5, 0.1, False, time.perf_counter(), "
        "device='cpu', chunk=1)\n"
        "assert r['correct'], r")
    assert PROGRAM in names
    assert not names & FORBIDDEN


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(os.path.join(d, f) for d, _, files in os.walk(BENCH)
                 for f in files if f.endswith(".py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, BENCH) for p in SOURCES])
def test_sources_import_no_jax(path):
    names = set(_imports(path))
    assert not names & FORBIDDEN
    if os.sep + "reference" + os.sep in path:
        assert PROGRAM not in names
