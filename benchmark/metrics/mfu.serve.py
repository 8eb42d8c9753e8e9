"""``mfu.serve``: the traced run's model FLOP/s over the dense peak of the
configuration's dtype, in %: the whole step's share of the card's peak.
The model's operations a frame are the family's
(``ctx.model_flops_per_frame``: for ``yolo11-seg``, 2 x the multiply-adds
of every convolution and linear layer of the published network at the
letterboxed input, for each view the configuration runs)."""


def read(ctx):
    if not ctx.window_s or not ctx.frames:
        return None
    flops = ctx.model_flops_per_frame * ctx.frames
    return flops / ctx.window_s / ctx.peak_flops_per_s * 100.0
