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

from torch import nn

from lidar_object_detection_tpu_torch.models.common import flax_default_init

HEAT_BIAS = -2.19


def initialize(model: nn.Module, seed: int = 0) -> nn.Module:
    """A PointPillars network's initialization from ``seed``
    (:func:`..common.flax_default_init`, the center head's heatmap bias
    -2.19); returns the model."""
    return flax_default_init(model, seed, {"center_head.heat": HEAT_BIAS})
