"""Velodyne -> rectified-camera projection.

Counterpart of ``lidar_object_detection_tpu/geom/projection.py``: a 4x4
transform over the padded scan, the devkit's ``cam2image`` (intrinsic
multiply, divide by ``abs(depth)``, round to integer pixels) and the
validity mask of V1_BBox_Pointwise_filtering.py:357.

Devkit quirks kept:
* zero depths are replaced by ``-1e-6`` before the divide,
* the divisor is ``abs(depth)``,
* pixel coordinates are rounded half to even (``torch.round``), and kept
  in the input's float dtype.
"""

from __future__ import annotations

import torch


def cam2image(points_cam: torch.Tensor, intrinsics: torch.Tensor):
    """(..., 3) camera-frame points -> (u, v, depth), each (...,)."""
    proj = points_cam @ intrinsics.to(points_cam.dtype).T
    depth = proj[..., 2]
    depth = torch.where(depth == 0, torch.full_like(depth, -1e-6), depth)
    abs_depth = depth.abs()
    u = torch.round(proj[..., 0] / abs_depth)
    v = torch.round(proj[..., 1] / abs_depth)
    return u, v, depth


def project_velo_points(points: torch.Tensor, velo_to_rect: torch.Tensor,
                        intrinsics: torch.Tensor):
    """(P, 3 or 4) velodyne points -> (u, v, depth) in the rectified
    camera; a 4th (reflectance) channel is ignored."""
    xyz = points[..., :3]
    t = velo_to_rect.to(xyz.dtype)
    points_rect = xyz @ t[:3, :3].T + t[:3, 3]
    return cam2image(points_rect, intrinsics)


def point_validity(u, v, depth, width: int, height: int, depth_min: float,
                   depth_max: float, point_mask=None):
    """``(u >= 0) & (u < W) & (v >= 0) & (v < H) & (depth > dmin) &
    (depth < dmax)`` (V1:357), and the padding mask when given."""
    valid = ((u >= 0) & (u < width) & (v >= 0) & (v < height)
             & (depth > depth_min) & (depth < depth_max))
    if point_mask is not None:
        valid = valid & point_mask
    return valid
