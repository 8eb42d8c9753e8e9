"""PointPillars training loss: anchor assignment, then focal, smooth-L1 and
direction losses.

Counterpart of ``lidar_object_detection_tpu/models/pointpillars/loss.py``.
Assignment uses the exact rotated BEV IoU between anchors and GT boxes
(``PillarsConfig.assign_iou="rotated"``; positive >= 0.6, negative < 0.45,
ignored between -- the paper's car thresholds) or the axis-aligned
approximation (``"aabb"``).  The exact IoU is computed sparsely, as the
JAX package does: an AABB bound ranks every anchor for every GT, and only
the best K = 512 candidates of each GT are clipped
(:func:`_rotated_iou_topk`), on the card by one kernel launch for the whole
step (``ops/rotated_iou_pairs.py``).

Everything is batched over the frames on a leading axis, where the JAX
package ``vmap``s a one-frame function: (B, N, G) IoU matrices, one
assignment, one loss.  The anchor grid (N, 7) is an argument, so that a
trainer builds it once on its device.  The JAX module's
``rotated_iou_chunked`` has no counterpart: nothing calls it, and
``ops/rotated_iou.py`` already clips a block of rows at a time.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from lidar_object_detection_tpu_torch.geom.boxes import iou_2d_matrix
from lidar_object_detection_tpu_torch.models.common import global_sum
from lidar_object_detection_tpu_torch.models.pointpillars.decode import (
    anchor_grid, bev_aabb, encode_boxes)
from lidar_object_detection_tpu_torch.models.pointpillars.model import (
    PillarsConfig)
from lidar_object_detection_tpu_torch.ops.rotated_iou_pairs import (
    candidate_ious)

# candidates clipped exactly per GT (loss.py:47's k)
TOPK = 512


def iou_bound(anchors, gt_boxes7):
    """(B, G, N) upper bound of the rotated IoU of anchor n with GT g:
    the BEV-AABB intersection over ``area_a + area_g - intersection``
    (the rotated intersection cannot exceed the AABB one), from anchors
    (N, 7) and GT boxes (B, G, 7)."""
    a = bev_aabb(anchors)                                   # (N, 4)
    g = bev_aabb(gt_boxes7)[..., None, :]                   # (B, G, 1, 4)
    x1 = torch.maximum(a[:, 0], g[..., 0])
    y1 = torch.maximum(a[:, 1], g[..., 1])
    x2 = torch.minimum(a[:, 2], g[..., 2])
    y2 = torch.minimum(a[:, 3], g[..., 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    area_a = anchors[:, 3] * anchors[:, 4]
    area_g = (gt_boxes7[..., 3] * gt_boxes7[..., 4])[..., None]
    denom = torch.clamp(area_a + area_g - inter, min=1e-9)
    return inter / denom


def top_candidates(bound, k: int = TOPK):
    """(B, G, min(k, N)) int64: per GT the anchors of the largest bound,
    descending, ties to the lowest index (``jax.lax.top_k``'s order)."""
    k = min(k, bound.shape[-1])
    if bound.shape[-1] == 0 or bound.numel() == 0:
        return bound.new_zeros((*bound.shape[:-1], k), dtype=torch.int64)
    idx = torch.sort(bound, dim=-1, descending=True, stable=True).indices
    return idx[..., :k].contiguous()


def _rotated_iou_topk(anchors, gt_boxes7, gt_valid=None, k: int = TOPK):
    """Exact rotated IoU, dense (B, N, G), computed sparsely.

    Every pair whose AABB bound is out of the top ``k`` of its GT keeps
    IoU 0: the bound is below any threshold in use there, so the
    positive, negative and force-match decisions are those of the dense
    exact matrix.  The top-k candidates are clipped exactly
    (:func:`.ops.rotated_iou_pairs.candidate_ious`, one launch on the
    card) and scattered back.  The pairs of GTs that ``gt_valid`` (B, G)
    marks invalid are 0 (the kernel skips them; the assignment masks
    them): a zero-size GT's clip leaves the whole anchor, and its IoU
    ``inter / (area - inter)`` is the rounding of a difference of equals,
    which depends on the order of the shoelace sum.
    """
    b, g = gt_boxes7.shape[:2]
    n = anchors.shape[0]
    if gt_valid is None:
        gt_valid = torch.ones((b, g), dtype=torch.bool,
                              device=gt_boxes7.device)
    top_idx = top_candidates(iou_bound(anchors, gt_boxes7), k)  # (B, G, K)
    exact = torch.where(gt_valid[..., None],
                        candidate_ious(anchors, top_idx, gt_boxes7, gt_valid),
                        0.0)
    flat = top_idx * g + torch.arange(g, device=top_idx.device)[:, None]
    dense = torch.zeros((b, n * g), dtype=torch.float32,
                        device=gt_boxes7.device)
    dense.scatter_(1, flat.reshape(b, -1),
                   torch.clamp(exact, min=0.0).reshape(b, -1))
    return dense.reshape(b, n, g)


def assign_anchors(gt_boxes7, gt_valid, cfg: PillarsConfig, anchors=None,
                   pos_iou: float = 0.6, neg_iou: float = 0.45):
    """Per-anchor assignment of a batch of frames.

    Takes GT boxes (B, G, 7) and their mask (B, G); ``anchors`` (N, 7), by
    default ``anchor_grid(cfg)`` on the boxes' device.  Returns dict:
    matched (B, N) int64 (best GT per anchor), pos (B, N) bool, neg (B, N)
    bool.  Every valid GT with some overlap has its best anchor forced
    positive (the lowest-quality fallback), as in the JAX package.
    """
    if anchors is None:
        anchors = anchor_grid(cfg, gt_boxes7.device).reshape(-1, 7)
    if cfg.assign_iou == "rotated":
        iou = _rotated_iou_topk(anchors, gt_boxes7, gt_valid)
    else:
        iou = iou_2d_matrix(bev_aabb(anchors), bev_aabb(gt_boxes7))
    return assign_from_iou(iou, gt_valid, pos_iou, neg_iou)


def assign_from_iou(iou, gt_valid, pos_iou: float = 0.6,
                    neg_iou: float = 0.45):
    """:func:`assign_anchors`' decisions from a (B, N, G) IoU matrix."""
    n = iou.shape[1]
    iou = torch.where(gt_valid[:, None, :], iou, 0.0)        # (B, N, G)
    best_iou = iou.amax(dim=2)
    matched = iou.argmax(dim=2)
    pos = best_iou >= pos_iou
    best_anchor = iou.argmax(dim=1)                          # (B, G)
    # invalid or zero-IoU GTs go to a dummy slot past the anchors, so that
    # they cannot overwrite a real GT's force-match
    force_ok = gt_valid & (iou.amax(dim=1) > 0)
    idx = torch.where(force_ok, best_anchor, n)
    force = torch.zeros((iou.shape[0], n + 1), dtype=torch.bool,
                        device=iou.device)
    force.scatter_(1, idx, True)
    force = force[:, :-1]
    forced = torch.where(force[..., None], iou, -1.0).argmax(dim=2)
    matched = torch.where(force, forced, matched)
    pos = pos | force
    neg = (best_iou < neg_iou) & ~pos
    return {"matched": matched, "pos": pos, "neg": neg}


def focal_loss(logits, labels, alpha: float = 0.25, gamma: float = 2.0):
    p = torch.sigmoid(logits)
    ce = torch.clamp(logits, min=0) - logits * labels + torch.log1p(
        torch.exp(-torch.abs(logits)))
    p_t = p * labels + (1 - p) * (1 - labels)
    a_t = alpha * labels + (1 - alpha) * (1 - labels)
    return a_t * (1 - p_t) ** gamma * ce


def smooth_l1(x, beta: float = 1.0 / 9.0):
    ax = torch.abs(x)
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def pointpillars_loss(outputs, gt_boxes7, gt_classes, gt_valid,
                      cfg: PillarsConfig,
                      cls_weight: float = 1.0, box_weight: float = 2.0,
                      dir_weight: float = 0.2,
                      gt_pos_weight=None, anchors=None,
                      group=None) -> Dict[str, torch.Tensor]:
    """Batched loss.

    Args:
      outputs: dict(cls (B, H, W, A, nc), box (B, H, W, A, 7),
        dir (B, H, W, A, 2)).
      gt_boxes7: (B, MAX_GT, 7); gt_classes: (B, MAX_GT) int;
      gt_valid: (B, MAX_GT) bool.
      anchors: (N, 7), by default ``anchor_grid(cfg)`` on the outputs'
        device.
      group: the process group the batch is split over (None: this
        rank's batch): ``num_pos`` is then the whole batch's, and the
        loss and its parts this rank's share of the whole batch's.

    With ``cfg.head == "center"`` the outputs are the center heads and the
    loss is :func:`.center.center_loss` (the same keys).  Returns loss,
    cls, box, dir and num_pos.
    """
    if cfg.head == "center":
        from lidar_object_detection_tpu_torch.models.pointpillars.center \
            import center_loss
        return center_loss(outputs, gt_boxes7, gt_classes, gt_valid, cfg,
                           gt_pos_weight=gt_pos_weight, group=group)
    b = outputs["cls"].shape[0]
    nc = cfg.num_classes
    if anchors is None:
        anchors = anchor_grid(cfg, outputs["cls"].device).reshape(-1, 7)
    n = anchors.shape[0]

    cls_logits = outputs["cls"].reshape(b, n, nc).to(torch.float32)
    box_deltas = outputs["box"].reshape(b, n, 7).to(torch.float32)
    dir_logits = outputs["dir"].reshape(b, n, 2).to(torch.float32)

    with torch.no_grad():
        assign = assign_anchors(gt_boxes7, gt_valid, cfg, anchors)
    pos, neg, matched = assign["pos"], assign["neg"], assign["matched"]
    posf = pos.to(torch.float32)

    gt_per_anchor = torch.gather(gt_boxes7, 1,
                                 matched[..., None].expand(b, n, 7))
    cls_per_anchor = torch.gather(gt_classes.long(), 1, matched)

    # classification: focal over pos + neg anchors
    labels = (cls_per_anchor[..., None]
              == torch.arange(nc, device=matched.device)).to(torch.float32) \
        * posf[..., None]
    weights = (pos | neg).to(torch.float32)[..., None]
    num_pos = torch.clamp(global_sum(pos.sum(), group), min=1)
    cls_loss = torch.sum(focal_loss(cls_logits, labels) * weights) / num_pos

    # regression on positives (sin for the yaw channel)
    targets = encode_boxes(gt_per_anchor, anchors[None])
    diff = box_deltas - targets
    diff = torch.cat([diff[..., :6], torch.sin(diff[..., 6:])], dim=-1)
    box_loss = torch.sum(torch.sum(smooth_l1(diff), -1) * posf) / num_pos

    # direction: GT yaw in (-pi/2, pi/2] of the anchor's frame -> class
    dyaw = gt_per_anchor[..., 6] - anchors[None, :, 6]
    dir_target = torch.remainder(dyaw + math.pi, 2 * math.pi) - math.pi
    dir_cls = (torch.abs(dir_target) > math.pi / 2).long()
    dir_ce = -torch.gather(F.log_softmax(dir_logits, dim=-1), -1,
                           dir_cls[..., None])[..., 0]
    dir_loss = torch.sum(dir_ce * posf) / num_pos

    total = (cls_weight * cls_loss + box_weight * box_loss
             + dir_weight * dir_loss)
    return {"loss": total, "cls": cls_loss, "box": box_loss,
            "dir": dir_loss, "num_pos": num_pos}


__all__ = ["TOPK", "iou_bound", "top_candidates",
           "assign_anchors", "assign_from_iou", "focal_loss", "smooth_l1",
           "pointpillars_loss"]
