"""3D box geometry on tensors.

Counterpart of ``lidar_object_detection_tpu/geom/boxes.py``:

* ``transform_corners`` -- ``transform_bboxes_to_velodyne`` (V1:41-52),
* ``box_frame`` / ``points_in_oriented_boxes`` -- ``oriented_point_in_bbox``
  (V1:142-183): project the point offsets on the three box edges and test
  [0, 1],
* ``corners_visibility`` -- ``filter_visible_bboxes`` (V1:96-115), and the
  richer ``is_bbox_in_camera_view`` (secondtest.py:277-359),
* ``iou_2d_matrix`` -- ``calculate_iou_2d`` (V4:118-137),
* ``project_boxes_to_2d`` -- ``project_3d_bbox_to_2d`` (V5:215-252), and
  ``points_in_aabb`` -- ``point_in_bbox`` (V1:118-139).

Corner order (V1:157-158): corners 0-3 bottom face, 4-7 top; edges
v1 = c1 - c0, v2 = c3 - c0, v3 = c4 - c0.

The inside test is written out as products and sums in a fixed order,
``(x * a_x + y * a_y) + z * a_z + offset``, each rounded on its own.  The
inside-count kernel (``csrc/inside_counts.cu``) does the same operations
in the same order, so the two agree bit for bit.
"""

from __future__ import annotations

import torch

from lidar_object_detection_tpu_torch.geom.projection import cam2image


def transform_corners(corners: torch.Tensor, transform: torch.Tensor):
    """Apply a 4x4 homogeneous transform to (..., 8, 3) corners."""
    t = transform.to(corners.dtype)
    return corners @ t[:3, :3].T + t[:3, 3]


def box_frame(corners: torch.Tensor):
    """(..., 8, 3) corners -> (axes (..., 3, 3), offsets (..., 3)).

    A point ``p`` is inside iff ``0 <= p . axes[k] + offsets[k] <= 1`` for
    all three axes, where ``axes[k] = v_k / (v_k . v_k)`` and
    ``offsets[k] = -c0 . axes[k]``.  A degenerate (zero-length) edge gives
    inf/nan projections, which never test inside.
    """
    c0 = corners[..., 0, :]
    edges = torch.stack([corners[..., 1, :] - c0,
                         corners[..., 3, :] - c0,
                         corners[..., 4, :] - c0], dim=-2)     # (..., 3, 3)
    sq = (edges[..., 0] * edges[..., 0] + edges[..., 1] * edges[..., 1]
          + edges[..., 2] * edges[..., 2])                     # (..., 3)
    axes = edges / sq[..., None]
    c = c0[..., None, :]
    offsets = -(c[..., 0] * axes[..., 0] + c[..., 1] * axes[..., 1]
                + c[..., 2] * axes[..., 2])                    # (..., 3)
    return axes, offsets


def masked_box_frame(corners: torch.Tensor, box_mask: torch.Tensor):
    """:func:`box_frame` with invalid boxes encoded so that no point ever
    tests inside: zero axes and offset -2 (the offset alone would not do:
    ``a . p - 2`` can land in [0, 1]).  Takes (..., G, 8, 3) corners and
    a (..., G) mask."""
    axes, offsets = box_frame(corners)
    axes = torch.where(box_mask[..., None, None], axes,
                       torch.zeros_like(axes))
    offsets = torch.where(box_mask[..., None], offsets,
                          torch.full_like(offsets, -2.0))
    return axes, offsets


def inside_from_frame(points: torch.Tensor, axes: torch.Tensor,
                      offsets: torch.Tensor):
    """(P, 3) points against (G, 3, 3) axes / (G, 3) offsets -> (P, G)
    bool, in the operation order the inside-count kernel uses."""
    x = points[:, 0, None]
    y = points[:, 1, None]
    z = points[:, 2, None]
    inside = None
    for k in range(3):
        a = axes[:, k, :]                                      # (G, 3)
        proj = (x * a[:, 0] + y * a[:, 1]) + z * a[:, 2] + offsets[:, k]
        ok = (proj >= 0) & (proj <= 1)
        inside = ok if inside is None else inside & ok
    return inside


def points_in_oriented_boxes(points: torch.Tensor, corners: torch.Tensor,
                             box_mask=None):
    """(P, 3) points x (G, 8, 3) corners -> (P, G) bool inside."""
    axes, offsets = box_frame(corners)
    inside = inside_from_frame(points, axes, offsets)
    if box_mask is not None:
        inside = inside & box_mask
    return inside


def points_in_aabb(points: torch.Tensor, corners: torch.Tensor,
                   box_mask=None):
    """Axis-aligned fallback test (``point_in_bbox``, V1:118-139):
    (P, 3) points x (G, 8, 3) corners -> (P, G) bool."""
    lo = corners.amin(dim=-2)                                  # (G, 3)
    hi = corners.amax(dim=-2)
    p = points[:, None, :]
    inside = ((p >= lo[None]) & (p <= hi[None])).all(dim=-1)
    if box_mask is not None:
        inside = inside & box_mask
    return inside


def corners_visibility(corners_cam0, intrinsics, width: int, height: int,
                       min_corners: int = 2, depth_min: float = 0.1,
                       box_mask=None):
    """A box is kept when >= ``min_corners`` of its 8 cam0-frame corners
    project in front of the camera (depth > 0.1) and inside the image."""
    u, v, depth = cam2image(corners_cam0, intrinsics)          # (G, 8)
    ok = ((depth > depth_min)
          & (u >= 0) & (u < width) & (v >= 0) & (v < height))
    visible = ok.sum(dim=-1) >= min_corners
    if box_mask is not None:
        visible = visible & box_mask
    return visible


REASON_VALID = 0
REASON_ALL_BEHIND = 1
REASON_NO_INTERSECTION = 2
REASON_TOO_SMALL = 3


def corners_visibility_rich(corners_cam0, intrinsics, width: int,
                            height: int, min_corners_in_view: int = 4,
                            depth_range=(0.1, 100.0),
                            min_projected_area: float = 100.0,
                            box_mask=None):
    """``is_bbox_in_camera_view`` (secondtest.py:277-359), batched.

    Returns (keep (G,) bool, reason (G,) int32 of REASON_* codes).
    """
    u, v, depth = cam2image(corners_cam0, intrinsics)          # (G, 8)
    dmin, dmax = depth_range
    valid_depth = (depth >= dmin) & (depth <= dmax)
    n_depth = valid_depth.sum(dim=-1)
    in_image = ((u >= 0) & (u < width) & (v >= 0) & (v < height)
                & valid_depth)
    n_view = in_image.sum(dim=-1)

    inf = torch.full_like(u, float("inf"))
    u_min = torch.where(valid_depth, u, inf).amin(dim=-1)
    u_max = torch.where(valid_depth, u, -inf).amax(dim=-1)
    v_min = torch.where(valid_depth, v, inf).amin(dim=-1)
    v_max = torch.where(valid_depth, v, -inf).amax(dim=-1)
    intersects = ~((u_max < 0) | (u_min >= width)
                   | (v_max < 0) | (v_min >= height))
    area = (u_max - u_min) * (v_max - v_min)

    any_depth = n_depth > 0
    enough_view = (n_view >= min_corners_in_view) | intersects
    big_enough = (n_depth < 2) | (area >= min_projected_area)
    keep = any_depth & enough_view & big_enough
    reason = torch.where(
        ~any_depth, REASON_ALL_BEHIND,
        torch.where(~enough_view, REASON_NO_INTERSECTION,
                    torch.where(~big_enough, REASON_TOO_SMALL,
                                REASON_VALID)))
    if box_mask is not None:
        keep = keep & box_mask
    return keep, reason.to(torch.int32)


def iou_2d_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor):
    """(..., N, 4) x (..., M, 4) xyxy -> (..., N, M) IoU, the leading axes
    a batch; zero where the intersection is empty or the union is zero."""
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    iw = torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0],
                                                             b[..., 0])
    ih = torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1],
                                                             b[..., 1])
    empty = (iw <= 0) | (ih <= 0)
    inter = torch.where(empty, torch.zeros_like(iw), iw * ih)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a + area_b - inter
    safe = torch.where(union > 0, union, torch.ones_like(union))
    return torch.where(union > 0, inter / safe, torch.zeros_like(union))


def project_boxes_to_2d(corners_cam0: torch.Tensor,
                        intrinsics: torch.Tensor):
    """``project_3d_bbox_to_2d`` (V5:215-252) over (..., G, 8, 3) corners.

    Returns a dict of (..., G)-shaped tensors: ``bbox`` (..., G, 4) xyxy
    of the corners with depth > 0, ``center`` (..., G, 2), ``size`` (...,
    G, 2), ``area``, ``avg_depth``, and ``valid`` (any corner with depth
    > 0).  A box with no such corner (the reference returns None there)
    gets zeros and ``valid=False``: the extremes start from +-inf, which
    only such a box keeps.
    """
    u, v, depth = cam2image(corners_cam0, intrinsics)          # (..., G, 8)
    pos = depth > 0
    valid = pos.any(dim=-1)
    inf = torch.full_like(u, float("inf"))
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    x_min = torch.where(valid, torch.where(pos, u, inf).amin(dim=-1), zero)
    x_max = torch.where(valid, torch.where(pos, u, -inf).amax(dim=-1), zero)
    y_min = torch.where(valid, torch.where(pos, v, inf).amin(dim=-1), zero)
    y_max = torch.where(valid, torch.where(pos, v, -inf).amax(dim=-1), zero)
    width = x_max - x_min
    height = y_max - y_min
    depth_sum = torch.where(pos, depth, zero).sum(dim=-1)
    depth_cnt = pos.sum(dim=-1).clamp(min=1)
    return {
        "bbox": torch.stack([x_min, y_min, x_max, y_max], dim=-1),
        "center": torch.stack([(x_min + x_max) / 2, (y_min + y_max) / 2],
                              dim=-1),
        "size": torch.stack([width, height], dim=-1),
        "area": width * height,
        "avg_depth": depth_sum / depth_cnt,
        "valid": valid,
    }
