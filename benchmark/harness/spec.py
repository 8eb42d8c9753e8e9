"""Find a cell's parts by name: ``BENCHMARK.json`` at the root of the
checkout names each cell's configuration and traffic mix, which live in
``benchmark/configs/<name>.json`` and ``benchmark/traffic/<name>.json``;
a per-layer metric's reader is ``benchmark/metrics/<name>.py``.  Adding a
cell, a mix or a metric adds files and edits none."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")


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


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Dict = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, mix
    and the metrics it reports."""
    if bench is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json("configs", w["config"]),
                mix=load_json("traffic", w["traffic"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])
