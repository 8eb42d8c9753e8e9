"""One run of a cell: set-up, the measured window, the trace's reduction
and the comparison with the reference.  What is particular to a model
family (its system, its inputs, its kernels, its operands and its
comparison) comes from the cell's family module (``spec.py``).

Set-up (``setup_s``, from the start of the process to the window): the
family's system loads the configuration's checkpoint, the family makes
the chunk from the seed, and the chunk goes through the timed path twice,
which builds the kernels (``csrc/build`` inside the checkout caches them)
and warms every shape the window uses.

The window is a closed loop: one caller hands in the chunk again when the
previous run's outputs are back, until ``seconds`` have passed.
``frames_per_s`` is every frame of the window over its whole length;
``batch_ms_p95`` the 95th percentile of all its chunks' times from
hand-in to outputs.  A traced run (``trace``) times every chunk's layers
(``system.Spans``) and runs the profiler over ``PROFILED`` chunks after
``PROFILE_AFTER`` (``trace.Profiler``); its metrics are the cell's
per-layer ones, each read by its own reader in ``benchmark/metrics``.
The kernels' operands for the roofline shares are taken once the window
is over, by running the chunk again (the program's outputs do not depend
on what ran before).

Once the window has closed, the peak of device memory has been read and
the program is freed, the family's reference judges a sample of the
window's chunks drawn from the seed.
"""

from __future__ import annotations

import gc
import math
import statistics
import sys
import tempfile
import time
import types
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import spec
from benchmark.harness.roofline import PEAK_FLOPS_PER_S
from benchmark.harness.system import Spans
from benchmark.harness.trace import Profiler, warm_up

# the profiler starts once the sample of chunks for the comparison has
# filled, so that no chunk it traces allocates device memory anew
PROFILE_AFTER, PROFILED = 10, 3


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def p95(values: List[float]) -> float:
    """The 95th percentile, linear between the closest ranks."""
    xs = sorted(values)
    pos = 0.95 * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Reservoir:
    """A uniform sample of ``size`` of the window's chunks, drawn from the
    seed as they come."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([seed % 2 ** 64, 1])
        self.items: List[Dict] = []
        self.seen = 0

    def offer(self, make: Callable[[], Dict]) -> None:
        if len(self.items) < self.size:
            self.items.append(make())
        else:
            k = int(self.rng.integers(0, self.seen + 1))
            if k < self.size:
                self.items[k] = make()
        self.seen += 1


def launch_diff(before: Dict[str, int], after: Dict[str, int]):
    return {k: after[k] - before.get(k, 0) for k in after}


def launches_ok(family, diff: Dict[str, int]) -> bool:
    return all(diff.get(k, 0) == 1 for k in family.PATH_KERNELS) and not any(
        diff.get(k, 0) for k in family.OFF_PATH_KERNELS)


def to_host(tree):
    """``tree`` with every tensor in it as a numpy array, floating point
    ones narrower than float32 in float32."""
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point() and tree.element_size() < 4:
            tree = tree.float()
        return tree.cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(to_host(v) for v in tree)
    return tree


def run_window(system, family, chunk, seconds: float, seed: int,
               samples: int, spans: Optional[Spans] = None,
               profiler: Optional[Profiler] = None):
    """The closed loop.  Returns the window's record."""
    reservoir = Reservoir(samples, seed)
    latencies, launch_bad, profiled_chunks = [], 0, 0
    frames, k = 0, 0
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    start = time.perf_counter()
    while True:
        profiled = profiler is not None and \
            PROFILE_AFTER <= k < PROFILE_AFTER + PROFILED
        if profiled and k == PROFILE_AFTER:
            spans.active = False
            profiler.start()
        before = system.launches()
        t0 = time.perf_counter()
        out = system.step(chunk)
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        frames += chunk.frames
        if not launches_ok(family, launch_diff(before, system.launches())):
            launch_bad += 1
        if profiled:
            profiler.frames += chunk.frames
            profiled_chunks += 1
            if k == PROFILE_AFTER + PROFILED - 1:
                profiler.stop()
                spans.active = True
        if not profiled:
            reservoir.offer(lambda: dict(family.sample(out), index=k))
        k += 1
        # a traced window runs on until its profiled chunks are done
        if t1 - start >= seconds and (profiler is None or profiler.done):
            break
    return types.SimpleNamespace(
        window_s=t1 - start, chunks=k, frames=frames, latencies=latencies,
        launch_bad=launch_bad, samples=reservoir.items,
        profiled_chunks=profiled_chunks, operands=[],
        launches=system.launches())


def read_per_layer(cell, record, spans, summary) -> Dict:
    """Each per-layer metric of the cell by its reader; a reader that
    finds nothing to read gives None and its metric is left out."""
    ctx = types.SimpleNamespace(
        config=cell.config, mix=cell.mix, spans=spans.milliseconds(),
        trace=summary,
        # the window outside the profiled chunks, which the profiler slows
        frames=record.frames - (summary or {}).get("frames", 0),
        window_s=record.window_s - (summary or {}).get("window_s", 0.0),
        peak_flops_per_s=PEAK_FLOPS_PER_S[cell.config["dtype"]],
        **cell.family.layer_context(cell, record))
    out = {}
    for m in cell.per_layer:
        value = spec.load_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_info(count: int) -> Dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}


def smi_line() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi not read ({exc})"


def run_cell(cell: "spec.Cell", seed: int, seconds: float, trace: bool,
             t_start: float, device="cuda", chunk: int = 0,
             make_system: Optional[Callable] = None) -> Dict:
    """One run.  Returns the result line's object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, with ``trace``
    ``breakdown``, and ``checks`` last)."""
    root, family = spec.ROOT, cell.family
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    spans = Spans(dev) if trace else None
    with tempfile.TemporaryDirectory(prefix="bench-calib-") as workdir:
        marks = [("imports", time.perf_counter())]
        system = (make_system or family.make_system)(root, cell, dev,
                                                      workdir, spans)
        marks.append(("load", time.perf_counter()))
        data = family.make_chunk(root, cell, seed, chunk)
        marks.append(("traffic", time.perf_counter()))
        for _ in range(2):
            system.step(data)
            marks.append(("warm-up pass", time.perf_counter()))
        if trace and cuda:
            warm_up()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        if spans is not None:
            spans.events.clear()
            spans.host_ms.clear()
        setup_s = time.perf_counter() - t_start
        stamps = [t_start] + [t for _, t in marks]
        log("set-up s: " + ", ".join(
            f"{name} {b - a:.3f}" for (name, _), a, b in
            zip(marks, stamps, stamps[1:])) + f"; total {setup_s:.3f}")
        profiler = Profiler() if (trace and cuda) else None
        record = run_window(system, family, data, seconds, seed,
                            int(cell.mix["judge_chunks"]), spans, profiler)
        if cuda:
            torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        result = {"attempted": record.frames, "failed": 0}
        metrics: Dict[str, Dict] = {}
        if trace:
            t_trace = time.perf_counter()
            summary = profiler.summary() if profiler is not None else {}
            # the profiled chunks' kernel operands, from the chunk run
            # again once the window is over, so that the window keeps no
            # chunk's device tensors alive
            spans.active = False
            record.operands = [family.operands(system, data)] * \
                record.profiled_chunks
            metrics = read_per_layer(cell, record, spans, summary)
            log(f"trace read in {time.perf_counter() - t_trace} s")
            if summary:
                result["breakdown"] = summary["breakdown"]
                log(f"profiled {PROFILED} chunks: {summary['kernels']} "
                    f"kernels, busy {summary['busy_s']} s of "
                    f"{summary['window_s']} s")
                names = sorted(summary["device_time_by_name"].items(),
                               key=lambda kv: -kv[1])
                for name, secs in names[:25]:
                    log(f"  device op {secs * 1e3:.4f} ms  {name[:160]}")
        else:
            lat_ms = [x * 1e3 for x in record.latencies]
            values = {"frames_per_s": record.frames / record.window_s,
                      "batch_ms_p95": p95(lat_ms), "setup_s": setup_s}
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
            log(f"window {record.window_s} s, {record.chunks} chunks, "
                f"{record.frames} frames; chunk ms median "
                f"{statistics.median(lat_ms)} p95 {p95(lat_ms)} max "
                f"{max(lat_ms)}; setup {setup_s} s")
        build = system.build_info() if cuda else {}
        log(f"card: {smi_line() if cuda else 'cpu'}; peak device memory "
            f"{peak} bytes; kernel build {build}")
        log(f"kernel launches over the set-up and window: "
            f"{record.launches}; chunks off the path's launches: "
            f"{record.launch_bad} of {record.chunks}")
        samples = to_host(record.samples)
        launch_bad = record.launch_bad if cuda else 0
        if spans is not None:
            spans.events.clear()
        del system, record, spans, profiler
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    limits = cell.config["limits"]
    numbers, correct = family.judge(root, cell, dev, data, samples,
                                    launch_bad)
    correct = bool(correct) and all(numbers[k] <= v
                                    for k, v in limits.items())
    t_judge = time.perf_counter() - t_judge
    result["correct"] = correct
    result["metrics"] = metrics
    result["device"] = dict(device_info(cell.chips) if cuda else
                            {"platform": "cpu", "kind": "cpu", "count": 0},
                            memory_peak_bytes=peak)
    if trace and "breakdown" in result:
        result["device"].update(busy_s=summary["busy_s"],
                                window_s=summary["window_s"])
    result["checks"] = {k: {"value": numbers[k], "limit": v}
                        for k, v in limits.items()}
    log(f"judged chunks {[s['index'] for s in samples]} of the window "
        f"against the reference in {t_judge} s")
    for k, v in limits.items():
        log(f"check {k}: {numbers[k]} (limit {v})")
    return result
