"""The port's own initializer of a YOLO11 network, with Flax's default
distributions.

The JAX package's trainer initializes with ``model.init(PRNGKey(seed))``
(``lidar_object_detection_tpu/parallel/train.py:405-409``).  JAX's random
draws cannot be reproduced in PyTorch, so this draws from the same
distributions with a ``torch.Generator`` seeded by ``seed``, as the
PointPillars initializer does (:func:`..common.flax_default_init`):

* every convolution kernel, depthwise ones included: Flax's
  ``lecun_normal`` (a normal truncated at two standard deviations,
  variance 1 / fan_in, fan_in the kernel's input channels per group
  times its taps); the Proto's transposed kernel too, whose Flax
  parameter keeps PyTorch's (in, out, 2, 2) layout, so that Flax takes
  its fan-in as for any kernel, from the last two axes as (input, output)
  and the rest as taps: 2 * in * out;
* every bias 0;
* BatchNorm scales 1 and biases 0, running means 0 and variances 1.

The draws are made on the CPU in the order of ``named_parameters`` and
copied to the model's device, so a seed gives the same bits on any
device.
"""

from __future__ import annotations

from torch import nn

from lidar_object_detection_tpu_torch.models.common import flax_default_init


def initialize(model: nn.Module, seed: int = 0) -> nn.Module:
    """Initialize a :class:`.model.Yolo11` in place from ``seed``; returns
    the model."""
    fan_ins = {name: m.weight.shape[0] * m.weight.shape[1]
               * m.weight.shape[2] for name, m in model.named_modules()
               if isinstance(m, nn.ConvTranspose2d)}
    return flax_default_init(model, seed, fan_ins=fan_ins)
