"""``fusion_ms.serve``: ``FusionPipeline.fuse`` (the scans' and boxes'
copy to the card, projection, box filter, erosion, K1, best box), mean ms
a chunk between CUDA events around the call."""

import statistics


def read(ctx):
    ms = ctx.spans.get("fusion")
    return statistics.fmean(ms) if ms else None
