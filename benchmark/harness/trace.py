"""The profiler over a few steady chunks of a traced run, and its
reduction: the device's busy time as the union of its intervals (kernels,
copies and sets, merged as ``chip_smoke.profile_once`` merges them), the
kernels launched, each device operation's time by name, and the idle gaps
named by what the host was doing.  Nothing is written to disk."""

from __future__ import annotations

import bisect
import time
from typing import Dict

import torch


def warm_up() -> None:
    """One short profile of a trivial operation: the first profile of a
    process loads and starts the device tracer, which takes seconds that
    would otherwise fall into the profiled chunks."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class Profiler:
    """``start()`` and ``stop()`` around the profiled chunks; both
    synchronise the card, so ``window_s`` spans the chunks' whole work."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.window_s = 0.0
        self.frames = 0
        self.done = False

    def start(self):
        torch.cuda.synchronize()
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.done = True

    def summary(self) -> Dict:
        return reduce_events(self.prof.events(), self.window_s, self.frames)


def _is_copy(name: str) -> bool:
    low = name.lower()
    return low.startswith("memcpy") or low.startswith("memset")


def _union(spans):
    """Merged (start, end) intervals of ``spans``, sorted."""
    merged = []
    for start, end in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _host_op_at(t, host, starts) -> str:
    """The innermost host operation running at ``t`` (microseconds)."""
    best, best_len = "python (between operations)", None
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 400), -1):
        start, end, name = host[j]
        if end >= t and (best_len is None or end - start < best_len):
            best, best_len = name, end - start
    return best


def reduce_events(events, window_s: float, frames: int) -> Dict:
    from torch.autograd import DeviceType

    device = [e for e in events if e.device_type == DeviceType.CUDA]
    if not device:
        return {}
    spans = [(e.time_range.start, e.time_range.end) for e in device]
    merged = _union(spans)
    busy_us = sum(end - start for start, end in merged)
    kernels = [e for e in device if not _is_copy(e.name)]
    by_name: Dict[str, float] = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e6
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.device_type == DeviceType.CPU
                  and not e.name.startswith("ProfilerStep"))
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = {}
    for (_, end), (start, _) in zip(merged, merged[1:]):
        name = _host_op_at((end + start) / 2, host, starts)
        gaps[name] = gaps.get(name, 0.0) + (start - end) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy_us / 1e6, "window_s": window_s,
            "frames": frames, "kernels": len(kernels),
            "device_time_by_name": by_name,
            "breakdown": {"device_ops": top(by_name), "idle_gaps": top(gaps)}}


def kernel_seconds(summary: Dict, pattern: str) -> float:
    """The device seconds of the operations whose name holds ``pattern``."""
    return sum(v for k, v in summary.get("device_time_by_name", {}).items()
               if pattern in k)
