"""Anchor grid, box decoding and BEV NMS for PointPillars, for inference.

Counterpart of ``lidar_object_detection_tpu/models/pointpillars/decode.py``
(lines 25-230; ``encode_boxes`` is training, ROADMAP Queue 1 item 7).
Boxes decode as in SECOND/PointPillars: center offsets scaled by the
anchor diagonal, log-ratio sizes, a yaw residual whose pi ambiguity the
direction classifier resolves.  Suppression is greedy NMS on the exact
rotated BEV IoU (``ops/rotated_nms.py``, a CUDA kernel on the card) or on
the boxes' axis-aligned BEV extent (``ops/nms.py``, kernel K5).

7-dof box layout everywhere: (x, y, z, w, l, h, yaw) in the velodyne
frame, w along the box's lateral axis, l longitudinal, yaw about +z.

Top-k takes tied scores lowest index first, as ``jax.lax.top_k`` does,
by a stable descending sort (``torch.topk`` on the card orders ties
arbitrarily): empty BEV regions give thousands of anchors the same logit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lidar_object_detection_tpu_torch.models.pointpillars.model import (
    PillarsConfig)
from lidar_object_detection_tpu_torch.ops.nms import nms
# the kernel on the card, the twin on the CPU (the JAX package's
# _rotated_nms); renamed here, since decode_predictions' flag takes the name
from lidar_object_detection_tpu_torch.ops.rotated_nms import (
    rotated_nms as _rotated_nms)


def top_k_lowest_index(values, k: int):
    """(values, indices) of the k largest of a 1-D tensor, descending,
    ties to the lowest index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(values, descending=True, stable=True)
    return vals[:k], idx[:k]


def anchor_grid(cfg: PillarsConfig, device="cpu"):
    """Dense anchors at the head resolution: (H, W, A, 7) float32, yaw in
    {0, pi/2}."""
    g = cfg.grid
    stride = cfg.out_stride
    h = g.ny // stride
    w = g.nx // stride
    cell = g.pillar_size * stride
    ys = g.y_range[0] + (np.arange(h) + 0.5) * cell
    xs = g.x_range[0] + (np.arange(w) + 0.5) * cell
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    aw, al, ah = cfg.anchor_size
    anchors = np.zeros((h, w, cfg.num_anchors, 7), np.float32)
    for a in range(cfg.num_anchors):
        anchors[..., a, 0] = gx
        anchors[..., a, 1] = gy
        anchors[..., a, 2] = cfg.anchor_z
        anchors[..., a, 3] = aw
        anchors[..., a, 4] = al
        anchors[..., a, 5] = ah
        anchors[..., a, 6] = (math.pi / 2) * (a % 2)
    return torch.from_numpy(anchors).to(device)


def decode_boxes(deltas, anchors):
    """Regression deltas (..., 7) + anchors -> boxes (..., 7)."""
    diag = torch.sqrt(anchors[..., 3] ** 2 + anchors[..., 4] ** 2)
    return torch.stack([
        deltas[..., 0] * diag + anchors[..., 0],
        deltas[..., 1] * diag + anchors[..., 1],
        deltas[..., 2] * anchors[..., 5] + anchors[..., 2],
        torch.exp(deltas[..., 3]) * anchors[..., 3],
        torch.exp(deltas[..., 4]) * anchors[..., 4],
        torch.exp(deltas[..., 5]) * anchors[..., 5],
        deltas[..., 6] + anchors[..., 6],
    ], dim=-1)


def bev_aabb(boxes7):
    """Axis-aligned BEV extent (x1, y1, x2, y2) of rotated boxes."""
    x, y = boxes7[..., 0], boxes7[..., 1]
    w, l, yaw = boxes7[..., 3], boxes7[..., 4], boxes7[..., 6]
    c, s = torch.abs(torch.cos(yaw)), torch.abs(torch.sin(yaw))
    ex = (l * c + w * s) / 2
    ey = (l * s + w * c) / 2
    return torch.stack([x - ex, y - ey, x + ex, y + ey], dim=-1)


def decode_candidates(outputs, cfg: PillarsConfig,
                      score_threshold: float = 0.3):
    """The SSD decode up to suppression, for ONE frame: every anchor's
    box7 (n, 7), score (n,) and class (n,), and the top min(512, n)
    candidates' indices, scores and validity (score > threshold)."""
    dev = outputs["cls"].device
    anchors = anchor_grid(cfg, dev)
    n = int(np.prod(outputs["cls"].shape[:-1]))
    cls = outputs["cls"].reshape(n, -1)
    scores_all = torch.sigmoid(cls.to(torch.float32)).max(dim=-1).values
    classes = torch.argmax(cls, dim=-1).to(torch.int32)
    deltas = outputs["box"].reshape(n, 7)
    dirs = torch.argmax(outputs["dir"].reshape(n, 2), dim=-1)
    boxes7 = decode_boxes(deltas.to(torch.float32), anchors.reshape(n, 7))
    # direction classifier resolves the pi ambiguity
    yaw = boxes7[..., 6] + torch.where(dirs == 1, math.pi, 0.0)
    yaw = torch.remainder(yaw + math.pi, 2 * math.pi) - math.pi
    boxes7 = torch.cat([boxes7[..., :6], yaw[..., None]], dim=-1)

    k = min(512, n)
    top_scores, top_idx = top_k_lowest_index(scores_all, k)
    cand_valid = top_scores > score_threshold
    return boxes7, classes, top_idx, top_scores, cand_valid


def decode_predictions(outputs, cfg: PillarsConfig,
                       score_threshold: float = 0.3,
                       iou_threshold: float = 0.5,
                       max_detections: int = 64,
                       rotated_nms: bool = False):
    """Raw heads of ONE frame -> final detections.

    Args:
      outputs: dict(cls (H, W, A, nc), box (H, W, A, 7), dir (H, W, A, 2)),
        or the center head's dict when ``cfg.head == "center"``
        (:func:`.center.decode_center`, NMS-free).
      rotated_nms: exact rotated-rectangle IoU suppression instead of the
        BEV-AABB approximation.

    Returns dict: boxes7 (M, 7), scores (M,), classes (M,), valid (M,).
    """
    if cfg.head == "center":
        from lidar_object_detection_tpu_torch.models.pointpillars.center \
            import decode_center
        return decode_center(outputs, cfg, score_threshold=score_threshold,
                             max_detections=max_detections)
    boxes7, classes, top_idx, top_scores, cand_valid = decode_candidates(
        outputs, cfg, score_threshold)
    if rotated_nms:
        keep_idx, keep_valid = _rotated_nms(
            boxes7[top_idx], top_scores, cand_valid, iou_threshold,
            max_detections)
    else:
        aabb = bev_aabb(boxes7[top_idx])
        keep_idx, keep_valid = nms(aabb, top_scores, cand_valid,
                                   iou_threshold, max_detections)
    keep_idx = keep_idx.long()
    sel = top_idx[keep_idx]
    return {
        "boxes7": boxes7[sel],
        "scores": torch.where(keep_valid, top_scores[keep_idx], 0.0),
        "classes": classes[sel],
        "valid": keep_valid,
    }


def corners_to_boxes7(corners):
    """Velodyne-frame (G, 8, 3) KITTI-360 corners -> (G, 7) boxes.

    The KITTI-360 corner layout: the orthogonal edges at c0 are c1
    (height), c2 (width) and c5 (length); yaw is the length edge's
    direction about +z.
    """
    corners = torch.as_tensor(corners)
    center = torch.mean(corners, dim=-2)
    hvec = corners[..., 1, :] - corners[..., 0, :]
    wvec = corners[..., 2, :] - corners[..., 0, :]
    lvec = corners[..., 5, :] - corners[..., 0, :]
    w = torch.linalg.norm(wvec, dim=-1)
    l = torch.linalg.norm(lvec, dim=-1)
    h = torch.linalg.norm(hvec, dim=-1)
    yaw = torch.atan2(lvec[..., 1], lvec[..., 0])
    return torch.stack([center[..., 0], center[..., 1], center[..., 2],
                        w, l, h, yaw], dim=-1)


def boxes7_to_corners(boxes7):
    """(..., 7) boxes -> (..., 8, 3) corners in the layout of
    :func:`corners_to_boxes7` (its inverse for upright boxes): c0 at
    -L/2, -W/2, -H/2 with c1 = c0+H, c2 = c0+W, c3 = c0+W+H, c5 = c0+L,
    c4 = c0+L+H, c7 = c0+L+W, c6 = c0+L+W+H."""
    b = torch.as_tensor(boxes7)
    c, s = torch.cos(b[..., 6]), torch.sin(b[..., 6])
    zero = torch.zeros_like(c)
    lhat = torch.stack([c, s, zero], dim=-1)               # length axis
    what = torch.stack([-s, c, zero], dim=-1)              # width axis
    zhat = torch.stack([zero, zero, torch.ones_like(c)], dim=-1)
    L = b[..., 4:5] * lhat
    W = b[..., 3:4] * what
    H = b[..., 5:6] * zhat
    c0 = b[..., :3] - 0.5 * (L + W + H)
    offsets = torch.stack([
        torch.zeros_like(c0), H, W, W + H, L + H, L, L + W + H, L + W,
    ], dim=-2)                                             # (..., 8, 3)
    return c0[..., None, :] + offsets
