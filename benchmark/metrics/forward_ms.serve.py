"""``forward_ms.serve``: the detector's forward (``YoloDetector.forward``:
the frames' copy to the card, the letterbox and the network), mean ms a
chunk between CUDA events around the call, over the traced run's chunks
outside the profiled ones."""

import statistics


def read(ctx):
    ms = ctx.spans.get("forward")
    return statistics.fmean(ms) if ms else None
