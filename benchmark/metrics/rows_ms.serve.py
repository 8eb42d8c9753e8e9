"""``rows_ms.serve``: the chunk's ``frame_statistics`` calls, one a frame,
mean ms a chunk on the host clock."""

import statistics


def read(ctx):
    ms = ctx.spans.get("rows")
    return statistics.fmean(ms) if ms else None
