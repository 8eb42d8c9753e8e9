"""``decode_ms.serve``: the detector's decode (``YoloDetector.decode``:
DFL boxes, top-k, NMS by K5, the masks by K3 and K2, the hflip merge),
mean ms a chunk between CUDA events around the call."""

import statistics


def read(ctx):
    ms = ctx.spans.get("decode")
    return statistics.fmean(ms) if ms else None
