"""Flax variables of a PointPillars checkpoint -> PyTorch state dict.

The port's modules carry the Flax module names (``pfn.linear``,
``backbone.block0_down.conv``, ``backbone.up1.bn``, ``head.cls``,
``center_head.trunk``, ...), so each variable path becomes a state-dict key
token by token; the leaves and layouts change:

  ``params/.../kernel`` of a Conv (HWIO)      -> ``weight`` (OIHW)
  ``params/backbone/up{1,2}/conv/kernel``     -> ``weight`` of
      ``ConvTranspose2d`` (in, out, kh, kw): HWIO permuted to IOHW and
      flipped in both spatial axes (Flax's ``ConvTranspose`` with
      ``transpose_kernel=False`` is an input-dilated convolution with the
      kernel as stored; ``conv_transpose2d`` is the adjoint of a
      convolution)
  ``params/pfn/linear/kernel`` (9, 64)        -> ``weight`` (64, 9)
  ``params/.../scale``, ``bias``              -> ``weight``, ``bias``
  ``batch_stats/.../mean``, ``var``           -> ``running_mean``,
                                                 ``running_var``
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# the transposed convolutions of Backbone2D (up-stride > 1)
TRANSPOSED = ("backbone.up1.conv", "backbone.up2.conv")


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _kernel(stem: str, t: torch.Tensor) -> torch.Tensor:
    if t.dim() == 2:                                    # Dense (in, out)
        return t.T
    if stem in TRANSPOSED:
        return t.permute(2, 3, 0, 1).flip(2, 3)         # (in, out, kh, kw)
    return t.permute(3, 2, 0, 1)                        # (out, in, kh, kw)


def pillars_state_from_flax(variables) -> Dict[str, torch.Tensor]:
    """Flax ``{"params", "batch_stats"}`` tree (numpy arrays, as
    ``utils.flax_msgpack.read_flax_msgpack`` gives them) -> a state dict
    for :class:`.model.PointPillars`."""
    sd: Dict[str, torch.Tensor] = {}
    for (collection, *path), value in _flatten(variables):
        *mods, leaf = path
        stem = ".".join(mods)
        t = torch.from_numpy(np.array(value))
        if collection == "batch_stats":
            key, t = f"{stem}.running_{leaf}", t
        elif leaf == "kernel":
            key, t = f"{stem}.weight", _kernel(stem, t)
        elif leaf == "scale":
            key = f"{stem}.weight"
        elif leaf == "bias":
            key = f"{stem}.bias"
        else:
            raise KeyError(f"unhandled variable {collection}/{'/'.join(path)}")
        if key in sd:
            raise ValueError(f"two flax variables map to {key}")
        sd[key] = t.contiguous()
    return sd
