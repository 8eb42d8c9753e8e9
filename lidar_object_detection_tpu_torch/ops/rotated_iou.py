"""Exact rotated BEV IoU by Sutherland-Hodgman clipping.

Counterpart of ``lidar_object_detection_tpu/ops/rotated_iou.py`` (lines
24-166): the polygon intersection of two rotated rectangles, vectorized
over every (a, b) pair.  The clip keeps JAX's gap-filled vertex buffer:
after each halfplane every invalid slot holds the previous valid vertex
(``torch.cummax`` in place of ``lax.cummax``), so the buffer doubles from 4
to 64 slots over the four clip edges and duplicate vertices add nothing to
the shoelace area.  The arithmetic is JAX's, in its order, with the
``1e-12`` guard on the intersection's denominator and IoU 0 unless the
union exceeds ``1e-9``.

:func:`rotated_iou_matrix` runs on tensors (any device) and is the oracle
of the rotated-NMS kernel (``ops/rotated_nms.py``);
:func:`rotated_iou_matrix_np` is the NumPy copy the host-side evaluation
uses.  The pairs are clipped a block of rows at a time: 512 x 512 pairs
at 64 slots would otherwise hold several 134 MB buffers at once.
"""

from __future__ import annotations

import numpy as np
import torch

# rows of boxes_a clipped together: 64 x 512 pairs x 64 slots x 2 floats
# is 17 MB a buffer
ROW_BLOCK = 64


def box7_to_bev_corners(boxes7):
    """(..., 7) -> (..., 4, 2) BEV corners, counter-clockwise."""
    x, y = boxes7[..., 0], boxes7[..., 1]
    w, l, yaw = boxes7[..., 3], boxes7[..., 4], boxes7[..., 6]
    c, s = torch.cos(yaw), torch.sin(yaw)
    # local corners (length along +x_local, width along +y_local), CCW
    lx = torch.stack([l / 2, -l / 2, -l / 2, l / 2], -1)
    ly = torch.stack([w / 2, w / 2, -w / 2, -w / 2], -1)
    gx = x[..., None] + lx * c[..., None] - ly * s[..., None]
    gy = y[..., None] + lx * s[..., None] + ly * c[..., None]
    return torch.stack([gx, gy], -1)


def _clip_halfplane(poly, p1, p2):
    """Clip rings (..., V, 2) (duplicate-padded) by the halfplane left of
    the directed edges p1 -> p2 (..., 2).  Returns (..., 2V, 2)."""
    v = poly.shape[-2]
    nxt = torch.roll(poly, -1, dims=-2)
    d = (p2 - p1)[..., None, :]
    rel = poly - p1[..., None, :]
    rel_n = nxt - p1[..., None, :]
    num = d[..., 0] * rel[..., 1] - d[..., 1] * rel[..., 0]   # >= 0 inside
    num_n = d[..., 0] * rel_n[..., 1] - d[..., 1] * rel_n[..., 0]
    inside = num >= 0
    inside_n = num_n >= 0
    denom = num - num_n
    t = num / torch.where(denom.abs() < 1e-12,
                          torch.full_like(denom, 1e-12), denom)
    x = poly + (nxt - poly) * t[..., None]

    cand = torch.stack([x, nxt], dim=-2).reshape(*poly.shape[:-2], 2 * v, 2)
    valid = torch.stack([inside != inside_n, inside_n],
                        dim=-1).reshape(*poly.shape[:-2], 2 * v)
    idx = torch.arange(2 * v, device=poly.device)
    marked = torch.where(valid, idx, -1)
    last = torch.cummax(marked, dim=-1).values
    wrap = marked.max(dim=-1, keepdim=True).values     # last valid overall
    fill = torch.where(last < 0, wrap, last).clamp(0, 2 * v - 1)
    out = torch.gather(cand, -2, fill[..., None].expand(*fill.shape, 2))
    # fully-clipped polygon -> all zeros (area 0)
    return torch.where((wrap >= 0)[..., None], out, torch.zeros_like(out))


def _shoelace(poly):
    nxt = torch.roll(poly, -1, dims=-2)
    return 0.5 * torch.abs(torch.sum(
        poly[..., 0] * nxt[..., 1] - nxt[..., 0] * poly[..., 1], dim=-1))


def _intersection_areas(ca, cb):
    """(n, 4, 2) x (m, 4, 2) CCW quads -> (n, m) intersection areas: each
    quad of ``ca`` clipped by the edges of each quad of ``cb``."""
    n, m = ca.shape[0], cb.shape[0]
    poly = ca[:, None].expand(n, m, 4, 2)
    for j in range(4):
        poly = _clip_halfplane(poly, cb[None, :, j].expand(n, m, 2),
                               cb[None, :, (j + 1) % 4].expand(n, m, 2))
    return _shoelace(poly)


def rotated_iou_matrix(boxes_a, boxes_b):
    """Exact BEV IoU between rotated boxes.

    Args:
      boxes_a: (N, 7); boxes_b: (M, 7) -- (x, y, z, w, l, h, yaw).
    Returns:
      (N, M) IoU of the rotated BEV rectangles; row i is box a_i clipped
      by each box of ``boxes_b``.
    """
    ca = box7_to_bev_corners(boxes_a)               # (N, 4, 2)
    cb = box7_to_bev_corners(boxes_b)               # (M, 4, 2)
    inter = torch.cat([_intersection_areas(ca[i:i + ROW_BLOCK], cb)
                       for i in range(0, ca.shape[0], ROW_BLOCK)]
                      or [ca.new_zeros((0, cb.shape[0]))])
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    union = area_a + area_b - inter
    return torch.where(union > 1e-9, inter / union, torch.zeros_like(inter))


def rotated_iou_matrix_np(boxes_a, boxes_b):
    """NumPy copy of :func:`rotated_iou_matrix` in float64, for the
    host-side evaluation (``evaluate_bev``, ``bev_average_precision``)."""
    a = np.asarray(boxes_a, np.float64).reshape(-1, 7)
    b = np.asarray(boxes_b, np.float64).reshape(-1, 7)
    n, m = len(a), len(b)
    if n == 0 or m == 0:
        return np.zeros((n, m))

    def corners(bx):
        x, y = bx[:, 0], bx[:, 1]
        w, l, yaw = bx[:, 3], bx[:, 4], bx[:, 6]
        c, s = np.cos(yaw), np.sin(yaw)
        lx = np.stack([l / 2, -l / 2, -l / 2, l / 2], -1)
        ly = np.stack([w / 2, w / 2, -w / 2, -w / 2], -1)
        gx = x[:, None] + lx * c[:, None] - ly * s[:, None]
        gy = y[:, None] + lx * s[:, None] + ly * c[:, None]
        return np.stack([gx, gy], -1)                # (K, 4, 2)

    ca = corners(a)[:, None]                         # (N, 1, 4, 2)
    cb = corners(b)[None]                            # (1, M, 4, 2)
    poly = np.broadcast_to(ca, (n, m, 4, 2)).copy()  # (N, M, V, 2)
    for j in range(4):
        p1 = cb[..., j, :]                           # (1, M, 2)
        p2 = cb[..., (j + 1) % 4, :]
        v = poly.shape[2]
        nxt = np.roll(poly, -1, axis=2)
        d = p2 - p1                                  # (1, M, 2)
        rel = poly - p1[:, :, None, :]
        rel_n = nxt - p1[:, :, None, :]
        num = d[:, :, None, 0] * rel[..., 1] - d[:, :, None, 1] * rel[..., 0]
        num_n = (d[:, :, None, 0] * rel_n[..., 1]
                 - d[:, :, None, 1] * rel_n[..., 0])
        inside = num >= 0
        inside_n = num_n >= 0
        denom = num - num_n
        t = num / np.where(np.abs(denom) < 1e-12, 1e-12, denom)
        x = poly + (nxt - poly) * t[..., None]
        cand = np.stack([x, nxt], axis=3).reshape(n, m, 2 * v, 2)
        valid = np.stack([inside != inside_n, inside_n],
                         axis=3).reshape(n, m, 2 * v)
        idx = np.arange(2 * v)
        marked = np.where(valid, idx, -1)
        last = np.maximum.accumulate(marked, axis=2)
        wrap = marked.max(axis=2, keepdims=True)
        fill = np.where(last < 0, wrap, last)
        poly = np.take_along_axis(
            cand, np.clip(fill, 0, 2 * v - 1)[..., None].repeat(2, -1),
            axis=2)
        poly = np.where((wrap >= 0)[..., None], poly, 0.0)
    nxt = np.roll(poly, -1, axis=2)
    inter = 0.5 * np.abs(np.sum(
        poly[..., 0] * nxt[..., 1] - nxt[..., 0] * poly[..., 1], axis=2))
    area_a = (a[:, 3] * a[:, 4])[:, None]
    area_b = (b[:, 3] * b[:, 4])[None, :]
    union = area_a + area_b - inter
    return np.where(union > 1e-9, inter / union, 0.0)
