"""Import hygiene of the PyTorch port and of ``chip_smoke.py``.

Neither may import JAX, Flax, ``msgpack``, PIL, pandas, matplotlib,
Open3D, OpenCV or anything of the JAX package: the card's machine serves
without them.  The import checks
run in a fresh interpreter; the source check reads every import statement
of the port, those inside functions too.  Module names are matched exactly
(or as a parent package), since the port's own name starts with the JAX
package's.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "PIL", "pandas",
             "matplotlib", "open3d", "cv2", "lidar_object_detection_tpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, json, sys
before = set(sys.modules)
for name in {modules!r}:
    importlib.import_module(name)
print(json.dumps(sorted(set(sys.modules) - before)))
"""


def _loaded_after(modules):
    """Modules that importing ``modules`` loads into a fresh interpreter."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(modules=list(modules))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def _forbidden(loaded):
    return sorted(m for m in loaded
                  if any(m == f or m.startswith(f + ".") for f in FORBIDDEN))


def _port_modules():
    root = os.path.join(REPO, "lidar_object_detection_tpu_torch")
    names = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), REPO)
                name = rel[:-3].replace(os.sep, ".")
                names.append(name[:-len(".__init__")]
                             if name.endswith(".__init__") else name)
    return sorted(names)


def _imported_names(path):
    """Every module an import statement of ``path`` names."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_port_imports_nothing_of_jax():
    modules = _port_modules()
    for name in ("ops.mask_assembly", "ops.nms", "utils.png", "data.calib",
                 "data.kitti360", "data.native", "models.stub",
                 "eval.erosion_study", "eval.store", "eval.xlsx",
                 "pipelines.runner", "pipelines.cli", "pipelines.overlay",
                 "ops.lap", "ops.hungarian", "ops.scatter", "viz.overlay",
                 "viz.export", "__main__", "data.poses", "ops.rotated_iou",
                 "ops.rotated_nms", "models.pointpillars",
                 "models.pointpillars.model", "models.pointpillars.voxelize",
                 "models.pointpillars.center", "models.pointpillars.decode",
                 "models.pointpillars.augment",
                 "models.pointpillars.weights", "pipelines.pointpillars",
                 "pipelines.quality", "pipelines.regen_artifacts",
                 "pipelines.yolo_distill", "models.yolo.serving",
                 "tools.forward_times"):
        assert f"lidar_object_detection_tpu_torch.{name}" in modules
    loaded = _loaded_after(modules)
    assert "torch" in loaded
    assert _forbidden(loaded) == []


def test_port_sources_name_nothing_of_jax():
    """No import statement of the port, at top level or inside a function,
    names a forbidden module."""
    root = os.path.join(REPO, "lidar_object_detection_tpu_torch")
    found = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                found[os.path.relpath(path, REPO)] = _forbidden(
                    _imported_names(path))
    assert "lidar_object_detection_tpu_torch/pipelines/cli.py" in found
    assert {k: v for k, v in found.items() if v} == {}


def test_chip_smoke_imports_nothing_of_jax():
    """chip_smoke.py's imports -- its top level and those inside its
    functions -- read from its source and imported, without running it."""
    modules = {"chip_smoke"} | _imported_names(
        os.path.join(REPO, "chip_smoke.py"))
    assert any(m.startswith("lidar_object_detection_tpu_torch")
               for m in modules)
    assert _forbidden(modules) == []
    assert _forbidden(_loaded_after(sorted(modules))) == []


def test_card_tests_import_nothing_of_jax():
    """The card's test files collect where JAX and Flax are missing."""
    for name in ("test_torch_cuda.py", "test_torch_cuda_precision.py",
                 "test_torch_cuda_stream.py",
                 "test_torch_cuda_pointpillars.py"):
        names = _imported_names(os.path.join(REPO, "tests", name))
        assert "chip_smoke" in names, name
        assert _forbidden(names) == [], name


LOADER_PROBE = """
import json, os
import numpy as np
from lidar_object_detection_tpu_torch.data import native
path = os.path.join({tmp!r}, "scan.bin")
np.arange(64, dtype=np.float32).tofile(path)
spec = native.CompactionSpec.build(np.eye(4), np.eye(3), 8, 8, 0.0, 50.0,
                                   4096)
native.load_scan_padded(path, 32)
native.load_scan_compacted(path, spec)
list(native.ScanPrefetcher([path], 32))
maps = [line.split()[-1] for line in open("/proc/self/maps")
        if line.rstrip().endswith(".so")]
print(json.dumps(sorted(set(m for m in maps if "lidar_loader" in m))))
"""


def test_port_loads_only_its_own_native_loader(tmp_path):
    """The port builds its loader from its own copy of the source into its
    build directory, and never maps the committed
    ``csrc/liblidar_loader.so`` or names the JAX package's ``csrc``."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", LOADER_PROBE.format(tmp=str(tmp_path))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mapped = json.loads(out.stdout.strip().splitlines()[-1])
    build = os.path.join(REPO, "lidar_object_detection_tpu_torch", "csrc",
                         "build")
    assert len(mapped) == 1 and mapped[0].startswith(build + os.sep)
    assert os.path.join(REPO, "csrc", "liblidar_loader.so") not in mapped
    with open(os.path.join(REPO, "lidar_object_detection_tpu_torch", "data",
                           "native.py")) as f:
        source = f.read()
    assert "liblidar_loader.so" in source and "make -C" not in source
    assert os.path.isfile(os.path.join(
        REPO, "lidar_object_detection_tpu_torch", "csrc", "lidar_loader.cpp"))
