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

Also here, batched over frames in the same way: ``point_inside_labels``
(the V2 analysis cloud's labels), the V4 greedy-IoU matcher
(V4_BBox_IoU_filtering.py:140-183) and the V5 Hungarian matcher
(V5_ProjectingBBoxes.py:277-416), whose assignment is one launch of the
``lap`` kernel per batch on CUDA tensors (``ops/lap.py``).
"""

from __future__ import annotations

from typing import Dict

import torch

from lidar_object_detection_tpu_torch.config import FusionParams
from lidar_object_detection_tpu_torch.geom import boxes as boxes_lib
from lidar_object_detection_tpu_torch.geom import projection as proj_lib
from lidar_object_detection_tpu_torch.ops import erosion as erosion_lib
from lidar_object_detection_tpu_torch.ops import masks as masks_lib
from lidar_object_detection_tpu_torch.ops.hungarian import hungarian
from lidar_object_detection_tpu_torch.ops.inside_counts import (
    inside_counts, inside_counts_plain)
from lidar_object_detection_tpu_torch.ops.lap import lap
from lidar_object_detection_tpu_torch.utils import profiling


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
    device = points.device
    if p.count_impl not in ("auto", "plain"):
        raise ValueError(f"count_impl must be 'auto' or 'plain', got "
                         f"{p.count_impl!r}")

    with profiling.span("fuse.project", device):
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
        with profiling.span("fuse.erode", device):
            mask_bits = erosion_lib.erode_packed(
                mask_bits, p.erosion_kernel_size, p.erosion_iterations)

    det_valid = batch_det_valid
    with profiling.span("fuse.gather", device):
        det_word = masks_lib.detection_word(det_valid)             # (B,)
        point_bits = masks_lib.gather_point_bits(mask_bits, u, v, valid)
        point_bits = point_bits & det_word[:, None]

    with profiling.span("fuse.count", device):
        count = inside_counts if p.count_impl == "auto" else \
            inside_counts_plain
        counts, total = count(points[..., :3], point_bits, corners_velo,
                              vis, p.num_detections, p.count_chunk)
        best_count = counts.amax(dim=-1)
        best_idx = counts.argmax(dim=-1).to(torch.int32)
        matched = (best_count >= p.min_points) & (best_count > 0) & \
            det_valid
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


def point_inside_labels(points, point_bits, corners_velo, best_box, matched,
                        num_detections: int) -> torch.Tensor:
    """Per-point inside/outside labels for the matched boxes, for the V2
    analysis cloud (V2_point_cloud_without_erosion.py:446-491).

    Takes a batch: points (B, P, >=3), point_bits (B, P) int32 words
    (``fuse_batch``'s), corners_velo (B, G, 8, 3), best_box (B, D) int32
    (-1 unmatched) and matched (B, D).  Returns (B, P) int32 words: bit d
    set iff the point belongs to detection d and lies inside its matched
    box.  The inside test is that of the fusion (``geom.boxes``), against
    the D matched boxes only.
    """
    g = corners_velo.shape[-3]
    safe = best_box.clamp(0, g - 1).to(torch.int64)
    best = torch.gather(corners_velo, 1,
                        safe[..., None, None].expand(-1, -1, 8, 3))
    weights = masks_lib.bit_weights(num_detections, points.device)
    words = []
    for b in range(points.shape[0]):
        inside = boxes_lib.points_in_oriented_boxes(
            points[b, :, :3], best[b], box_mask=matched[b])       # (P, D)
        member = masks_lib.unpack_point_bits(point_bits[b],
                                             num_detections)      # (D, P)
        both = member.T & inside
        words.append((both.to(torch.int64) * weights).sum(dim=1))
    return masks_lib.wrap_int32(torch.stack(words))


def greedy_iou_match(det_boxes, det_valid, corners_cam0, box_valid,
                     intrinsics, min_iou: float = 0.25):
    """V4: for each detection, the GT box of the best projected 2D IoU.

    Batched: det_boxes (B, D, 4) xyxy, det_valid (B, D), corners_cam0
    (B, G, 8, 3), box_valid (B, G) (the runner passes the visible boxes),
    intrinsics (3, 3).  Ties keep the lowest box index (the reference's
    strictly-greater update, V4:173); a match needs IoU strictly above
    ``min_iou``.  Returns (match_idx (B, D) int32, -1 when unmatched, and
    the best IoU (B, D)).
    """
    info = boxes_lib.project_boxes_to_2d(corners_cam0, intrinsics)
    gt_ok = info["valid"] & box_valid
    iou = boxes_lib.iou_2d_matrix(det_boxes, info["bbox"])       # (B, D, G)
    iou = torch.where(gt_ok[..., None, :], iou, torch.zeros_like(iou))
    best_iou = iou.amax(dim=-1)
    best_idx = iou.argmax(dim=-1).to(torch.int32)
    ok = (best_iou > min_iou) & det_valid
    return torch.where(ok, best_idx, -1), best_iou


def matching_scores(det_boxes, corners_cam0, intrinsics, weight_iou=0.5,
                    weight_center=0.3, weight_size=0.2, center_norm=1000.0):
    """The V5 pairwise score: 0.5 IoU + 0.3 centre + 0.2 size (V5:277-304).

    (..., D, 4) boxes against (..., G, 8, 3) corners.  Returns (score,
    iou, valid): (..., D, G), (..., D, G) and the boxes' projection
    validity (..., G).  The centre distance is ``sqrt(dx * dx + dy *
    dy)``, as XLA lowers ``jnp.linalg.norm``.
    """
    info = boxes_lib.project_boxes_to_2d(corners_cam0, intrinsics)
    iou = boxes_lib.iou_2d_matrix(det_boxes, info["bbox"])

    det_cx = (det_boxes[..., 0] + det_boxes[..., 2]) / 2
    det_cy = (det_boxes[..., 1] + det_boxes[..., 3]) / 2
    dx = det_cx[..., :, None] - info["center"][..., None, :, 0]
    dy = det_cy[..., :, None] - info["center"][..., None, :, 1]
    dist = torch.sqrt(dx * dx + dy * dy)
    center_score = torch.clamp(1.0 - dist / center_norm, min=0.0)

    det_area = ((det_boxes[..., 2] - det_boxes[..., 0])
                * (det_boxes[..., 3] - det_boxes[..., 1]))[..., :, None]
    gt_area = info["area"][..., None, :]
    both_pos = (det_area > 0) & (gt_area > 0)
    size_score = torch.where(
        both_pos,
        torch.minimum(det_area, gt_area) / torch.maximum(det_area, gt_area),
        torch.zeros((), dtype=iou.dtype, device=iou.device))

    score = (weight_iou * iou + weight_center * center_score
             + weight_size * size_score)
    return score, iou, info["valid"]


def hungarian_cost(det_boxes, det_valid, corners_cam0, box_valid,
                   intrinsics, weight_iou=0.5, weight_center=0.3,
                   weight_size=0.2, center_norm=1000.0):
    """V5's assignment problem, batched: the cost (B, D, max(G, D)), 2.0
    everywhere and ``1 - score`` in the first G columns, its column mask
    (the boxes that project and are real), and the (score, iou, gt_ok)
    that the gates read.  The rows' mask is ``det_valid``."""
    d, g = det_boxes.shape[-2], corners_cam0.shape[-3]
    score, iou, proj_valid = matching_scores(
        det_boxes, corners_cam0, intrinsics, weight_iou, weight_center,
        weight_size, center_norm)
    gt_ok = proj_valid & box_valid
    c = max(g, d)
    lead = det_boxes.shape[:-2]
    cost = torch.full((*lead, d, c), 2.0, dtype=torch.float32,
                      device=det_boxes.device)
    cost[..., :g] = 1.0 - score.to(torch.float32)
    col_mask = torch.zeros((*lead, c), dtype=torch.bool,
                           device=det_boxes.device)
    col_mask[..., :g] = gt_ok
    return cost, col_mask, score, iou, gt_ok


def hungarian_match(det_boxes, det_valid, corners_cam0, box_valid,
                    intrinsics, min_score: float = 0.3, min_iou: float = 0.15,
                    weight_iou=0.5, weight_center=0.3, weight_size=0.2,
                    center_norm=1000.0, solver: str = "lap"):
    """V5's assignment with its score and IoU gates (V5:360-368), batched:
    det_boxes (B, D, 4), det_valid (B, D), corners_cam0 (B, G, 8, 3),
    box_valid (B, G) (the runner passes every real box: V5 skips the
    visibility filter).

    The problem is :func:`hungarian_cost`'s.  ``solver`` "lap" is the
    serving solver (``ops/lap.py``: the kernel on CUDA tensors, one launch
    per batch), "exact" the dynamic oracle (``ops/hungarian.py``); they
    give the same assignment.

    Returns (match_idx (B, D) int32, -1 when a gate rejects the pair, and
    each detection's pair score and IoU (B, D), 0 where it has none).
    """
    g = corners_cam0.shape[-3]
    cost, col_mask, score, iou, gt_ok = hungarian_cost(
        det_boxes, det_valid, corners_cam0, box_valid, intrinsics,
        weight_iou, weight_center, weight_size, center_norm)
    if solver == "lap":
        col4row = lap(cost, det_valid, col_mask)
    elif solver == "exact":
        col4row = hungarian(cost, det_valid, col_mask)
    else:
        raise ValueError(f"solver must be 'lap' or 'exact', got {solver!r}")

    in_range = (col4row >= 0) & (col4row < g)
    safe = col4row.clamp(0, g - 1).to(torch.int64)
    zero = torch.zeros((), dtype=score.dtype, device=score.device)
    pair_score = torch.where(in_range, torch.gather(
        score, -1, safe[..., None])[..., 0], zero)
    pair_iou = torch.where(in_range, torch.gather(
        iou, -1, safe[..., None])[..., 0], zero)
    ok = (det_valid & in_range & torch.gather(gt_ok, -1, safe)
          & (pair_score >= min_score) & (pair_iou >= min_iou))
    return torch.where(ok, safe.to(torch.int32), -1), pair_score, pair_iou
