"""Sharded execution of the fusion step.

Counterpart of ``lidar_object_detection_tpu/parallel/sharding.py``, its
two composable strategies over the (data, model) mesh:

* **Frame data-parallelism** (:func:`sharded_fuse_batch`): each rank
  fuses its frames of the batch (its rows over ``data``) and the outputs
  come back whole on every rank, in frame order, as a host read of JAX's
  global arrays gives them.  Frames are independent: K1 runs once per
  rank per call, on the rank's frames.
* **Point-axis sharding** (:func:`point_sharded_fuse_frame`): a scan's
  points split over ``model``; each rank projects its shard, gathers its
  packed words and counts them in the boxes with K1 (the twin on the
  CPU), then ONE all-reduce of the int32 (D, G) counts and (D,) totals
  crosses the ranks.  Per-point work never does, so the traffic is
  independent of the scan's size: the layout for multi-sweep scans of a
  million points or more.

The counts are exact integers, so both equal the unsharded
:func:`..fusion.associate.fuse_frame` bit for bit, on every device.  (JAX
sums its partial counts as float32 products; the port's K1 gives the
same integers.)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from lidar_object_detection_tpu_torch.config import FusionParams
from lidar_object_detection_tpu_torch.fusion.associate import (
    fuse_batch, fuse_frame)
from lidar_object_detection_tpu_torch.ops import erosion as erosion_lib
from lidar_object_detection_tpu_torch.parallel import collectives
from lidar_object_detection_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, axis_size, data_sharding, shard_rows)


def sharded_fuse_batch(mesh, batch_arrays: Sequence[torch.Tensor],
                       calib_arrays: Sequence[torch.Tensor],
                       params: FusionParams) -> Dict[str, torch.Tensor]:
    """``fuse_batch`` with the frame axis split over ``data``.

    Args:
      mesh: the (data, model) mesh.
      batch_arrays: (points, point_valid, mask_bits, det_valid,
        corners_cam0, box_valid), the whole batch on every rank, each with
        a leading frame axis that the data axis divides.
      calib_arrays: (velo_to_rect, cam_to_velo, intrinsics), replicated.

    Returns ``fuse_batch``'s dict for the whole batch on every rank.
    """
    local = [data_sharding(mesh, a) for a in batch_arrays]
    out = fuse_batch(*local, *calib_arrays, params=params)
    group = mesh.get_group(DATA_AXIS)
    return {k: collectives.all_gather_cat(v, group, 0)
            for k, v in out.items()}


def point_sharded_fuse_frame(mesh, points, point_valid, mask_bits,
                             det_valid, corners_cam0, box_valid,
                             velo_to_rect, cam_to_velo, intrinsics,
                             params: FusionParams) -> Dict[str, torch.Tensor]:
    """One frame with the point axis split over ``model``: the whole frame
    on every rank (points (P, 4) and point_valid (P,), P divided by the
    model axis; the rest as ``fuse_frame`` takes them).

    The packed mask image is whole on every rank, so erosion runs once,
    before the split (JAX's ``:71-74``).  Returns ``counts`` (D, G),
    ``total_points`` (D,), ``best_box``, ``points_inside`` and
    ``matched`` (D,), equal on every rank and to ``fuse_frame``'s.
    """
    n = axis_size(mesh, MODEL_AXIS)
    if points.shape[0] % n:
        raise ValueError("point count must divide the model axis")
    if params.erosion_enabled:
        mask_bits = erosion_lib.erode_packed(
            mask_bits, params.erosion_kernel_size, params.erosion_iterations)
        params = dataclasses.replace(params, erosion_enabled=False)
    i = mesh.get_local_rank(MODEL_AXIS)
    part = fuse_frame(shard_rows(points, 0, n, i),
                      shard_rows(point_valid, 0, n, i), mask_bits, det_valid,
                      corners_cam0, box_valid, velo_to_rect, cam_to_velo,
                      intrinsics, params)
    d, g = part["counts"].shape
    # the only traffic between the ranks: (D, G) + (D,) int32 per frame
    both = torch.cat([part["counts"].reshape(-1), part["total_points"]])
    collectives.all_reduce_(both, mesh.get_group(MODEL_AXIS))
    counts, total = both[:d * g].view(d, g), both[d * g:]

    best_count = counts.amax(dim=-1)
    best_idx = counts.argmax(dim=-1).to(torch.int32)
    matched = (best_count >= params.min_points) & (best_count > 0) \
        & det_valid
    return {
        "counts": counts,
        "total_points": total,
        "best_box": torch.where(matched, best_idx, -1),
        "points_inside": torch.where(matched, best_count, 0),
        "matched": matched,
    }
