"""``mfu.serve``: the traced run's model FLOP/s over the dense peak of the
configuration's dtype, in %.  The model's operations are 2 x the
multiply-adds of every convolution and linear layer of the published
network at the letterboxed input, counted by the reference's own layers
(``reference.yolo.conv_flops``), for each view the configuration runs."""

import functools

import torch

from benchmark.reference.yolo import Yolo11Seg, conv_flops


@functools.lru_cache(maxsize=None)
def flops_per_view(scale, input_hw):
    with torch.device("meta"):
        model = Yolo11Seg(scale)
    return conv_flops(model, input_hw)


def read(ctx):
    if not ctx.window_s or not ctx.frames:
        return None
    flops = flops_per_view(ctx.config["scale"], tuple(ctx.input_hw)) \
        * ctx.views_per_frame * ctx.frames
    return flops / ctx.window_s / ctx.peak_flops_per_s * 100.0
