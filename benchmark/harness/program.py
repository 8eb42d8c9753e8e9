"""The program's own spans (``utils/profiling.py`` of the port: ``span``,
``Tracer``) as the readers of ``h2d_ms.serve``, ``h2d_gbps.serve``,
``preprocess_ms.serve``, ``network_ms.serve``, ``detect_idle_ms.serve``
and ``fuse_idle_ms.serve`` take them, from ``ctx.program``:

- ``records``: the tracer's records of the traced window's chunks outside
  the profiled ones (each ``name``, ``chunk``, ``nbytes`` and
  ``device_ms``, the time between the span's CUDA events);
- ``ranges``: the program's ranges in the profiled chunks, ``(name,
  start_us, end_us)`` on the profiler's timeline, names with the
  program's prefix;
- ``device``: the device operations' intervals there (kernels, copies,
  sets; not the profiler's annotations);
- ``profiled_chunks``: how many chunks the profiler covered.

Without ``ctx.program`` (a program without the spans, or a run on the
CPU, where spans have no events) every reader gives None.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from benchmark.harness.trace import _union

PREFIX = "lidar::"


def context(records, events, profiled_chunks: int) -> Dict:
    """``ctx.program`` from the tracer's records and the profiler's
    events (``profile.events()``) of ``profiled_chunks`` chunks."""
    from torch.autograd import DeviceType

    ranges, device = [], []
    for e in events:
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            # the profiler mirrors a range onto the device as an
            # annotation: not an operation
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(PREFIX)):
                device.append(span)
        elif e.name.startswith(PREFIX):
            ranges.append((e.name, *span))
    return {"records": [{"name": r.name, "chunk": r.chunk,
                         "nbytes": r.nbytes, "device_ms": r.device_ms}
                        for r in records],
            "ranges": ranges, "device": device,
            "profiled_chunks": profiled_chunks}


def _program(ctx) -> Dict:
    return getattr(ctx, "program", None) or {}


def _timed(ctx, names: Iterable[str]) -> List[Dict]:
    names = set(names)
    return [r for r in _program(ctx).get("records", ())
            if r["name"] in names and r["device_ms"] is not None]


def ms_per_chunk(ctx, names: Iterable[str]) -> Optional[float]:
    """The mean over chunks of the spans ``names``' device ms summed in a
    chunk."""
    sums: Dict[int, float] = {}
    for r in _timed(ctx, names):
        sums[r["chunk"]] = sums.get(r["chunk"], 0.0) + r["device_ms"]
    return sum(sums.values()) / len(sums) if sums else None


def gbps(ctx, names: Iterable[str]) -> Optional[float]:
    """The spans ``names``' bytes over their device time, in GB/s."""
    timed = _timed(ctx, names)
    ms = sum(r["device_ms"] for r in timed)
    if not ms:
        return None
    return sum(r["nbytes"] for r in timed) / ms / 1e6


def idle_ms_per_chunk(ctx, name: str) -> Optional[float]:
    """Over the profiled chunks: the length of the program's range
    ``name`` less the union of device intervals inside it, summed over the
    range's occurrences, in ms a profiled chunk."""
    prog = _program(ctx)
    spans: List[Tuple[float, float]] = [
        (start, end) for n, start, end in prog.get("ranges", ())
        if n == PREFIX + name]
    if not spans or not prog.get("profiled_chunks"):
        return None
    busy = _union(prog.get("device", ()))
    idle_us = 0.0
    for start, end in spans:
        covered = sum(min(end, b) - max(start, a) for a, b in busy
                      if a < end and b > start)
        idle_us += (end - start) - covered
    return idle_us / 1e3 / prog["profiled_chunks"]
