"""The fused LiDAR-camera association step.

Counterpart of ``fuse_frame`` / ``fuse_batch`` in
``lidar_object_detection_tpu/fusion/associate.py`` (lines 134-243), which
replace the reference's per-frame hot path (``process_frame``,
V1_BBox_Pointwise_filtering.py:295-430; ``process_frames``,
cvs_erosion.py:298-379):

  1. project the Velodyne points into the rectified camera,
  2. the FOV/depth validity mask (V1:357),
  3. the GT-box visibility pre-filter (V1:96-115) and the cam0 -> velo
     corner transform (V1:41-52),
  4. optional erosion of the packed mask words (cvs_erosion.py:98-106),
  5. one packed membership word per point,
  6. inside-counts for every (detection, box) pair -- kernel K1 on CUDA
     tensors (``ops/inside_counts.py``), its plain twin on CPU tensors,
  7. the best box with the reference's first-wins and ``min_points``
     semantics.

Every step runs over the whole batch at once, frames on a leading axis
(the JAX package vmaps ``fuse_frame``): each is elementwise or a gather
per frame, so batching changes no output, and the inside-count is one
launch of K1 per batch.  ``fuse_frame`` is the batch of one frame.

The V4/V5 matchers of the JAX module are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch

from lidar_object_detection_tpu_torch.config import FusionParams
from lidar_object_detection_tpu_torch.geom import boxes as boxes_lib
from lidar_object_detection_tpu_torch.geom import projection as proj_lib
from lidar_object_detection_tpu_torch.ops import erosion as erosion_lib
from lidar_object_detection_tpu_torch.ops import masks as masks_lib
from lidar_object_detection_tpu_torch.ops.inside_counts import (
    inside_counts, inside_counts_plain)


def fuse_frame(points, point_valid, mask_bits, det_valid, corners_cam0,
               box_valid, velo_to_rect, cam_to_velo, intrinsics,
               params: FusionParams) -> Dict[str, torch.Tensor]:
    """Fuse one frame.

    Args:
      points: (P, 4) padded velodyne scan.
      point_valid: (P,) bool padding mask.
      mask_bits: (H, W) int32 packed instance masks (bit d = detection d).
      det_valid: (D,) bool detection mask.
      corners_cam0: (G, 8, 3) GT box corners in the cam0 frame.
      box_valid: (G,) bool box padding mask.
      velo_to_rect / cam_to_velo: (4, 4) calibration.
      intrinsics: (3, 3).
      params: FusionParams.

    Returns the JAX ``fuse_frame`` dict, with int32 words for the uint32
    ones.
    """
    out = fuse_batch(points[None], point_valid[None], mask_bits[None],
                     det_valid[None], corners_cam0[None], box_valid[None],
                     velo_to_rect, cam_to_velo, intrinsics, params)
    return {k: v[0] for k, v in out.items()}


def fuse_batch(batch_points, batch_point_valid, batch_mask_bits,
               batch_det_valid, batch_corners, batch_box_valid,
               velo_to_rect, cam_to_velo, intrinsics,
               params: FusionParams) -> Dict[str, torch.Tensor]:
    """:func:`fuse_frame` over a leading (B,) frame axis (calibration
    shared); each output gains that axis."""
    p = params
    points = batch_points
    dtype = points.dtype
    intrinsics = intrinsics.to(dtype)

    u, v, depth = proj_lib.project_velo_points(
        points, velo_to_rect.to(dtype), intrinsics)
    valid = proj_lib.point_validity(
        u, v, depth, p.width, p.height, p.depth_min, p.depth_max,
        batch_point_valid)

    corners_cam0, box_valid = batch_corners, batch_box_valid
    if not p.bbox_filter:
        vis = box_valid
    elif p.bbox_filter_mode == "rich":
        vis, _ = boxes_lib.corners_visibility_rich(
            corners_cam0, intrinsics, p.width, p.height,
            min_corners_in_view=p.bbox_rich_min_corners_in_view,
            depth_range=(p.bbox_corner_depth_min, p.bbox_rich_depth_max),
            min_projected_area=p.bbox_rich_min_area, box_mask=box_valid)
    else:
        vis = boxes_lib.corners_visibility(
            corners_cam0, intrinsics, p.width, p.height,
            min_corners=p.bbox_min_visible_corners,
            depth_min=p.bbox_corner_depth_min, box_mask=box_valid)
    corners_velo = boxes_lib.transform_corners(
        corners_cam0, cam_to_velo.to(dtype))

    mask_bits = batch_mask_bits
    if p.erosion_enabled:
        mask_bits = erosion_lib.erode_packed(
            mask_bits, p.erosion_kernel_size, p.erosion_iterations)

    det_valid = batch_det_valid
    det_word = masks_lib.detection_word(det_valid)                 # (B,)
    point_bits = masks_lib.gather_point_bits(mask_bits, u, v, valid)
    point_bits = point_bits & det_word[:, None]

    if p.count_impl == "auto":
        counts, total = inside_counts(points[..., :3], point_bits,
                                      corners_velo, vis, p.num_detections,
                                      p.count_chunk)
    elif p.count_impl == "plain":
        counts, total = inside_counts_plain(
            points[..., :3], point_bits, corners_velo, vis,
            p.num_detections, p.count_chunk)
    else:
        raise ValueError(f"count_impl must be 'auto' or 'plain', got "
                         f"{p.count_impl!r}")

    best_count = counts.amax(dim=-1)
    best_idx = counts.argmax(dim=-1).to(torch.int32)
    matched = (best_count >= p.min_points) & (best_count > 0) & det_valid
    best_box = torch.where(matched, best_idx, -1)
    inside_ct = torch.where(matched, best_count, 0)

    return {
        "u": u, "v": v, "depth": depth, "point_valid": valid,
        "box_visible": vis, "corners_velo": corners_velo,
        "point_bits": point_bits, "counts": counts,
        "total_points": total, "best_box": best_box,
        "points_inside": inside_ct, "matched": matched,
        "eroded_mask_bits": mask_bits,
    }
