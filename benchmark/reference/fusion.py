# Adapted from lidar_object_detection_tpu_torch/fusion/associate.py:81-152, geom/projection.py:20-55, geom/boxes.py:29-88,108-122, ops/erosion.py:19-67, ops/masks.py:18-64 and ops/inside_counts.py:41-56 at 072d88e (one frame at a time, no kernel).
"""The LiDAR-camera fusion of one frame in plain PyTorch, for the
benchmark's reference.

The reference scripts' ``process_frame`` (V1_BBox_Pointwise_filtering.py
and cvs_erosion.py): project the Velodyne points into the rectified
camera (the devkit's ``cam2image``: divide by ``abs(depth)``, round half to
even), keep those inside the image between the depth limits, keep the GT
boxes with at least two corners in view, erode every mask with the 3 x 3
elliptical element (out-of-image neighbours count as foreground), give
each point the packed word of the masks it falls in, count each
detection's points inside each visible box (the oriented test of
V1:142-183 in a fixed operation order), and take each detection's best
box under the ``min_points`` gate, first box winning ties.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def cam2image(points_cam, intrinsics):
    proj = points_cam @ intrinsics.T
    depth = proj[..., 2]
    depth = torch.where(depth == 0, torch.full_like(depth, -1e-6), depth)
    u = torch.round(proj[..., 0] / depth.abs())
    v = torch.round(proj[..., 1] / depth.abs())
    return u, v, depth


def box_frame(corners):
    """(G, 8, 3) corners -> axes (G, 3, 3) and offsets (G, 3): a point p is
    inside iff 0 <= p . axes[k] + offsets[k] <= 1 for k = 0, 1, 2."""
    c0 = corners[..., 0, :]
    edges = torch.stack([corners[..., 1, :] - c0, corners[..., 3, :] - c0,
                         corners[..., 4, :] - c0], dim=-2)
    sq = (edges[..., 0] * edges[..., 0] + edges[..., 1] * edges[..., 1]
          + edges[..., 2] * edges[..., 2])
    axes = edges / sq[..., None]
    c = c0[..., None, :]
    offsets = -(c[..., 0] * axes[..., 0] + c[..., 1] * axes[..., 1]
                + c[..., 2] * axes[..., 2])
    return axes, offsets


def inside_boxes(points, axes, offsets):
    """(P, 3) points x (G, 3, 3) axes / (G, 3) offsets -> (P, G) bool."""
    x, y, z = points[:, 0, None], points[:, 1, None], points[:, 2, None]
    inside = None
    for k in range(3):
        a = axes[:, k, :]
        proj = (x * a[:, 0] + y * a[:, 1]) + z * a[:, 2] + offsets[:, k]
        ok = (proj >= 0) & (proj <= 1)
        inside = ok if inside is None else inside & ok
    return inside


# the 3 x 3 elliptical structuring element of cv2 is the cross
CROSS = ((-1, 0), (0, -1), (0, 1), (1, 0))


def erode(words):
    """(H, W) int32 packed masks eroded by the cross, every plane at once;
    out-of-image neighbours count as set."""
    h, w = words.shape
    padded = torch.full((h + 2, w + 2), -1, dtype=words.dtype,
                        device=words.device)
    padded[1:h + 1, 1:w + 1] = words
    out = words
    for dy, dx in CROSS:
        out = out & padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    return out


def fuse_frame(points, point_valid, mask_bits, det_valid, corners_cam0,
               box_valid, velo_to_rect, cam_to_velo, intrinsics, *,
               width: int, height: int, depth_min: float, depth_max: float,
               min_points: int, chunk: int = 16384) -> Dict[str, torch.Tensor]:
    """One frame's fused outputs: ``total_points`` (D,), ``best_box``
    (D,) (-1 unmatched), ``points_inside`` (D,), ``matched`` (D,) and
    ``box_visible`` (G,), from float32 inputs on one device."""
    num_det = det_valid.shape[0]
    xyz = points[:, :3]
    rect = xyz @ velo_to_rect[:3, :3].T + velo_to_rect[:3, 3]
    u, v, depth = cam2image(rect, intrinsics)
    valid = ((u >= 0) & (u < width) & (v >= 0) & (v < height)
             & (depth > depth_min) & (depth < depth_max) & point_valid)

    cu, cv, cdepth = cam2image(corners_cam0, intrinsics)        # (G, 8)
    seen = ((cdepth > 0.1) & (cu >= 0) & (cu < width) & (cv >= 0)
            & (cv < height))
    visible = (seen.sum(dim=-1) >= 2) & box_valid
    corners_velo = corners_cam0 @ cam_to_velo[:3, :3].T + cam_to_velo[:3, 3]

    words = erode(mask_bits)
    ui = u.to(torch.int32).clamp(0, width - 1)
    vi = v.to(torch.int32).clamp(0, height - 1)
    point_words = words.reshape(-1)[(vi * width + ui).long()]
    det_word = (det_valid.to(torch.int64) << torch.arange(
        num_det, dtype=torch.int64, device=points.device)).sum()
    det_word = (((det_word + 2 ** 31) % 2 ** 32) - 2 ** 31).to(torch.int32)
    point_words = torch.where(valid, point_words, 0) & det_word

    axes, offsets = box_frame(corners_velo)
    axes = torch.where(visible[:, None, None], axes, torch.zeros_like(axes))
    offsets = torch.where(visible[:, None], offsets,
                          torch.full_like(offsets, -2.0))
    planes = torch.arange(num_det, dtype=torch.int32, device=points.device)
    member = ((point_words[None, :] >> planes[:, None]) & 1).float()
    counts = torch.zeros((num_det, corners_cam0.shape[0]),
                         dtype=torch.float32, device=points.device)
    for start in range(0, xyz.shape[0], chunk):
        stop = min(start + chunk, xyz.shape[0])
        inside = inside_boxes(xyz[start:stop], axes, offsets).float()
        counts += member[:, start:stop] @ inside
    counts = counts.to(torch.int32)
    total = member.sum(dim=1).to(torch.int32)
    best_count = counts.amax(dim=-1)
    best_idx = counts.argmax(dim=-1).to(torch.int32)
    matched = (best_count >= min_points) & (best_count > 0) & det_valid
    return {"total_points": total,
            "best_box": torch.where(matched, best_idx, -1),
            "points_inside": torch.where(matched, best_count, 0),
            "matched": matched, "box_visible": visible}


def frame_rows(frame_id: int, fused: Dict[str, np.ndarray],
               det_valid: np.ndarray):
    """The master CSV's per-car rows of one frame (cvs_erosion.py:165-229):
    ``(frame, car_id, matched_bbox_id, total_points, points_inside_bbox,
    points_outside_bbox, inside_percentage, outside_percentage)``; cars
    with no points are skipped, and the box id counts the visible boxes
    only."""
    visible_pos = np.cumsum(fused["box_visible"]) - 1
    rows = []
    for car in range(fused["total_points"].shape[0]):
        total = int(fused["total_points"][car])
        if not det_valid[car] or total == 0:
            continue
        if fused["matched"][car]:
            inside = int(fused["points_inside"][car])
            pct = inside / total * 100.0
            rows.append((frame_id, car,
                         int(visible_pos[fused["best_box"][car]]), total,
                         inside, total - inside, round(pct, 2),
                         round(100.0 - pct, 2)))
        else:
            rows.append((frame_id, car, -1, total, 0, total, 0.0, 100.0))
    return rows
