"""Per-detection depth maps by a scatter-max on the device.

Counterpart of ``lidar_object_detection_tpu/ops/scatter.py``
(``scatter_depth_maps``), which replaces the reference's Python loop
(``seg_with_pointcloud.py:160-170``: for each car mask, every valid point
writes ``depthMap[y, x] = depth``).  Here every detection's map is one
``scatter_reduce_(..., "amax")`` into a ``-inf`` fill, with zeros where no
point landed.  A maximum does not depend on the order in which points
arrive, so the maps are exact on the card too, equal to the CPU's and to
JAX's.  (The reference's loop is last write wins; points of one car that
collide on a pixel differ by millimetres.)

Memory: the maps are (D, H, W) float32 per frame, 68 MB at 32 x 376 x
1408, beside a (D, P) float32 source of 16 MB at P = 131072; the runner
builds them a chunk of frames at a time.
"""

from __future__ import annotations

import torch


def scatter_depth_maps(u, v, depth, car_mask, valid, height: int,
                       width: int) -> torch.Tensor:
    """Per-detection depth maps of one frame or a batch.

    Args:
      u, v: (..., P) pixel coordinates (cast to int32 toward zero, then
        clipped to the image, as JAX does).
      depth: (..., P) depths.
      car_mask: (..., D, P) bool membership (``gather_mask_bits``).
      valid: (..., P) bool point validity.
      height, width: the image size.

    Returns:
      (..., D, H, W) float32 depth maps, the largest depth of the points
      that land on each pixel; zero where none does.
    """
    ui = u.to(torch.int32).clamp(0, width - 1)
    vi = v.to(torch.int32).clamp(0, height - 1)
    lin = (vi * width + ui).to(torch.int64)                  # (..., P)
    d = car_mask.shape[-2]
    neg = torch.tensor(float("-inf"), dtype=depth.dtype, device=depth.device)
    vals = torch.where(car_mask & valid[..., None, :], depth[..., None, :],
                       neg)                                  # (..., D, P)
    maps = torch.full((*vals.shape[:-1], height * width), float("-inf"),
                      dtype=depth.dtype, device=depth.device)
    index = lin[..., None, :].expand(*lin.shape[:-1], d, lin.shape[-1])
    maps.scatter_reduce_(-1, index, vals, reduce="amax", include_self=True)
    maps = torch.where(torch.isfinite(maps), maps, torch.zeros_like(maps))
    return maps.to(torch.float32).reshape(*vals.shape[:-1], height, width)
