"""The port's own initializer of a PointPillars network, with Flax's
default distributions.

The JAX package's trainer initializes with ``model.init(PRNGKey(seed))``
(``lidar_object_detection_tpu/models/pointpillars/train.py:34-35``).  JAX's
random draws cannot be reproduced in PyTorch, so this draws from the same
distributions with a ``torch.Generator`` seeded by ``seed``:

* every ``Dense``, ``Conv`` and ``ConvTranspose`` kernel: Flax's
  ``lecun_normal``, a normal truncated at two standard deviations and
  scaled to variance 1 / fan_in, where fan_in is the kernel's input
  channels times its taps (Flax's fan-in for the transposed kernels as
  well, whose input channels lead PyTorch's layout);
* biases 0, but the center head's heatmap bias -2.19 (an initial sigmoid
  of about 0.1, ``center.py:60-62`` of the JAX package);
* BatchNorm scales 1 and biases 0, running means 0 and variances 1.

The draws are made on the CPU in the order of ``named_parameters`` and
copied to the model's device, so a seed gives the same bits on any
device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# Flax's variance_scaling divides the standard deviation by the standard
# deviation of a standard normal truncated to (-2, 2)
TRUNCATED_STD = 0.87962566103423978
HEAT_BIAS = -2.19


def _fan_in(module: nn.Module, weight: torch.Tensor) -> int:
    if isinstance(module, nn.ConvTranspose2d):     # (in, out, kh, kw)
        return weight.shape[0] * weight.shape[2] * weight.shape[3]
    return math.prod(weight.shape[1:])             # (out, in, ...) layouts


@torch.no_grad()
def initialize(model: nn.Module, seed: int = 0) -> nn.Module:
    """Initialize ``model``'s parameters and BatchNorm statistics in place
    from ``seed``; returns the model."""
    gen = torch.Generator().manual_seed(seed)
    modules = dict(model.named_modules())
    for name, param in model.named_parameters():
        stem, leaf = name.rsplit(".", 1)
        module = modules[stem]
        if leaf == "weight" and param.dim() >= 2:
            std = math.sqrt(1.0 / _fan_in(module, param)) / TRUNCATED_STD
            value = torch.empty(param.shape, dtype=torch.float32)
            nn.init.trunc_normal_(value, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=gen)
        elif leaf == "weight":                     # a BatchNorm scale
            value = torch.ones(param.shape)
        elif stem == "center_head.heat":
            value = torch.full(param.shape, HEAT_BIAS)
        else:
            value = torch.zeros(param.shape)
        param.copy_(value)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.zero_()
        elif name.endswith("running_var"):
            buf.fill_(1.0)
    return model
