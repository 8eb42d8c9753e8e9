"""Find a cell's parts by name: ``BENCHMARK.json`` at the root of the
checkout names each cell's configuration and traffic mix, which live in
``benchmark/configs/<name>.json`` and ``benchmark/traffic/<name>.json``;
the configuration's ``model`` names its family, the module
``benchmark/families/<model>.py`` that builds, feeds and judges the
system under test; a per-layer metric's reader is
``benchmark/metrics/<name>.py``.  Adding a cell, a mix, a metric or a
model family adds files and edits none.

A family module provides:

- ``make_system(root, cell, device, workdir, spans)``: the system under
  test, with ``step(chunk)`` (one chunk's work; what it returns is the
  family's), ``launches()`` (the program's kernel launches so far, by
  name) and ``build_info()``;
- ``make_chunk(root, cell, seed, chunk)``: the inputs a run sends again
  and again, made from the seed, with a ``frames`` count (``chunk`` > 0
  overrides the mix's size, for tests);
- ``PATH_KERNELS``, each launched once a chunk, and ``OFF_PATH_KERNELS``,
  never launched;
- ``sample(out)``: a dict of what the comparison needs of a chunk's
  output (``step``'s return), taken in the window without a copy; the
  harness moves its tensors to the host once the window has closed;
- ``operands(system, chunk)``: the chunk's output again once the window
  is over, for the readers of the kernels' operands;
- ``layer_context(cell, record)``: the family's fields of the per-layer
  readers' context (``model_flops_per_frame`` in every family);
- ``judge(root, cell, device, chunk, samples, launch_mismatch)``, run
  once the program is freed: ``(numbers, correct)``, a number for each
  key of the configuration's ``limits``, whose names are ``NUMBERS``;
- ``control_system`` (``make_system``'s signature) and ``FAULTS`` (name:
  a function that plants the fault through a ``setattr``), for
  ``benchmark/tests`` and ``benchmark/tools``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from types import ModuleType
from typing import Callable, Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
FAMILIES = os.path.join(BENCH, "families")


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH, kind, f"{name}.json")) as f:
        data = json.load(f)
    if data.get("name") != name:
        raise ValueError(f"benchmark/{kind}/{name}.json names itself "
                         f"{data.get('name')!r}")
    return data


def load_reader(name: str) -> Callable:
    """The ``read(ctx)`` function of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_family(model: str, directory: str = FAMILIES) -> ModuleType:
    """The module ``<directory>/<model>.py`` of the model family."""
    path = os.path.join(directory, f"{model}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no family for model {model!r}: {path} "
                                "does not exist")
    spec = importlib.util.spec_from_file_location(
        "benchmark_family_" + model.replace("-", "_").replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    family: ModuleType


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Dict = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, mix,
    the metrics it reports and its configuration's family."""
    if bench is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    config = load_json("configs", w["config"])
    return Cell(name=name, chips=int(w["chips"]), config=config,
                mix=load_json("traffic", w["traffic"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)],
                family=load_family(config["model"]))
