"""YOLO11-seg training step: the v8-family detection loss under
task-aligned assignment, the Segment head's mask loss, AdamW and an EMA of
the weights, on one card or over a (data, model) mesh.

Counterpart of ``lidar_object_detection_tpu/parallel/train.py:40-473``:

* :func:`task_aligned_assign` (TAL, TOOD / ultralytics): per GT the top-k
  anchors whose centres lie in the box, ranked by ``score^alpha *
  IoU^beta``; an anchor claimed by several GTs goes to the highest; soft
  targets normalized per GT.  It is a target construction: it runs under
  ``torch.no_grad`` on detached inputs, as JAX's under ``stop_gradient``.
* :func:`detection_loss` with the TAL assigner (``_tal_loss``: BCE with
  soft targets, IoU and distribution-focal losses on positives, plus
  :func:`segmentation_loss` when GT masks come) or the single-anchor
  ``"center"`` assigner.
* :class:`YoloTrainer` and its :meth:`~YoloTrainer.train_step`: the
  train-mode forward (BatchNorm with the batch's statistics, the running
  ones updated), the loss, the gradients by autograd (JAX's come from
  ``jax.value_and_grad``; no operation has a custom backward), optax's
  AdamW with a constant rate or a schedule (:mod:`.optim`), and the EMA
  ``e = d * e + (1 - d) * v`` over every variable, parameters and
  BatchNorm statistics, with ``d = min(decay, (1 + t) / (10 + t))``.

With a mesh (``YoloTrainer(..., mesh=...)``, :mod:`.mesh`) the step is
JAX's step on its mesh, where GSPMD inserts the reductions, and not
``DistributedDataParallel``'s: each rank takes its rows of the global
batch (``data``); train-mode BatchNorm takes the whole batch's
statistics, and the TAL, mask-loss and center-assigner normalisers are
the whole batch's (:mod:`..models.common`); each rank's loss is its share of
the whole batch's, so the gradients are summed over ``data``, not
averaged; AdamW, the schedule and the EMA then run alike on every rank.
:func:`param_shardings` is JAX's rule for the ``model`` axis: a conv
kernel whose Flax output axis the axis size divides is held in slices
along it, one a rank, with its AdamW moments and EMA entry; the forward
all-gathers it.  With ``mesh=None`` the trainer is the one-card trainer,
unchanged.

Ties follow JAX's rules: the argmax over GTs takes the first maximum,
TAL uses only the k-th value of its top-k, and the mask loss's top-k of
anchors is a stable descending sort, lowest index first, as
``jax.lax.top_k``.  Quotients floored into indices (the DFL bins, the
center assigner's cell) are IEEE divisions by device tensors: a CUDA
division by a Python scalar is a multiplication by its reciprocal.  The
BCE is optax's ``sigmoid_binary_cross_entropy``: ``-z log_sigmoid(x) -
(1 - z) log_sigmoid(-x)``.

``YoloTrainer(..., dtype=torch.bfloat16)`` is JAX's trainer with
``dtype=jnp.bfloat16``, mixed precision as Flax's ``dtype`` makes it: the
network computes in bfloat16 (``Yolo11(cfg, dtype)``, rounding where the
Flax modules round), the loss casts the heads to float32 before any
arithmetic, and the parameters, their gradients, AdamW's moments, the
BatchNorm statistics and the EMA stay float32.  A float32 step
(the default) runs in full float32 (TF32 off, ``full_float32``), a
bfloat16 one in ``mixed_precision`` (bfloat16 products summed in float32
besides); the backward runs in ``repeatable`` (cuDNN's deterministic
algorithms) too, so that a run on the card gives the same bits each
time.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from lidar_object_detection_tpu_torch.geom.boxes import iou_2d_matrix
from lidar_object_detection_tpu_torch.models.common import (
    global_sum, numerics, repeatable, split_batch)
from lidar_object_detection_tpu_torch.models.yolo.init import initialize
from lidar_object_detection_tpu_torch.models.yolo.model import (
    REG_MAX, STRIDES, Yolo11, YoloConfig)
from lidar_object_detection_tpu_torch.models.yolo.weights import (
    flax_kernel_axes, from_flax_variables, yolo_flax_from_state)
from lidar_object_detection_tpu_torch.parallel import collectives
from lidar_object_detection_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, axis_size, data_sharding)
from lidar_object_detection_tpu_torch.parallel.optim import (
    AdamWState, Schedule, adamw_state_dict, adamw_state_from_dict,
    adamw_update, rate_at)

LevelShapes = Sequence[Tuple[int, int]]


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _level_of(box_wh, strides=STRIDES):
    """A target's pyramid level by size: the level whose stride is closest
    to sqrt(area) / 4 (small boxes -> P3, large -> P5)."""
    s = torch.tensor(strides, dtype=torch.float32, device=box_wh.device)
    scale = torch.sqrt(torch.clamp(box_wh[..., 0] * box_wh[..., 1],
                                   min=1e-6)) / 4.0
    return torch.argmin(torch.abs(torch.log2(scale[..., None] / s)), dim=-1)


def _anchor_centers(level_shapes: LevelShapes, device="cpu",
                    strides=STRIDES):
    """Anchor centres in letterbox pixels, flattened over levels: (N, 2),
    and the anchors' strides (N,), float32."""
    pts, sts = [], []
    for (h, w), s in zip(level_shapes, strides):
        ys = (np.arange(h) + 0.5) * s
        xs = (np.arange(w) + 0.5) * s
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        pts.append(np.stack([gx.ravel(), gy.ravel()], -1))
        sts.append(np.full(h * w, s, np.float32))
    return (torch.from_numpy(np.concatenate(pts).astype(np.float32)).to(
        device), torch.from_numpy(np.concatenate(sts)).to(device))


def sigmoid_bce(logits, labels):
    """optax's ``sigmoid_binary_cross_entropy``: ``-z * log_sigmoid(x) -
    (1 - z) * log_sigmoid(-x)``, ``log_sigmoid(x) = min(x, 0) -
    log1p(exp(-|x|))`` (JAX's ``-softplus(-x)``)."""
    tail = torch.log1p(torch.exp(-torch.abs(logits)))
    log_p = torch.clamp(logits, max=0) - tail
    log_not_p = torch.clamp(-logits, max=0) - tail
    return -labels * log_p - (1.0 - labels) * log_not_p


@torch.no_grad()
def task_aligned_assign(cls_logits, pred_boxes, boxes, classes, valid,
                        level_shapes: LevelShapes, topk: int = 10,
                        alpha: float = 0.5, beta: float = 6.0):
    """Task-aligned assignment over a batch of frames.

    Args:
      cls_logits: (B, N, nc) raw class logits.
      pred_boxes: (B, N, 4) decoded xyxy predictions (letterbox px).
      boxes, classes, valid: (B, T, 4) GT xyxy, (B, T) int64 classes and
        (B, T) bool.

    Returns a dict of (B, N): ``assigned_gt`` int64, ``pos`` bool and
    ``norm_align`` float32, the soft target scale in [0, 1].
    """
    cls_logits, pred_boxes = cls_logits.detach(), pred_boxes.detach()
    tb = boxes.float()
    centers, _ = _anchor_centers(level_shapes, tb.device)
    b, n, _ = cls_logits.shape
    t = tb.shape[1]
    cx, cy = centers[:, 0], centers[:, 1]
    inside = ((cx >= tb[..., 0, None]) & (cx <= tb[..., 2, None])
              & (cy >= tb[..., 1, None]) & (cy <= tb[..., 3, None])
              & valid[..., None])                               # (B, T, N)
    iou = iou_2d_matrix(tb, pred_boxes)                         # (B, T, N)
    scores = torch.sigmoid(cls_logits.float())
    cls_t = torch.gather(scores, 2, classes[:, None, :].expand(
        b, n, t)).transpose(1, 2)                               # (B, T, N)
    align = torch.pow(cls_t, alpha) * torch.pow(torch.clamp(iou, min=0.0),
                                                beta)
    align = torch.where(inside, align, torch.zeros_like(align))

    k = min(topk, n)
    thresh = torch.topk(align, k, dim=-1).values[..., -1:]     # k-th value
    is_topk = (align >= torch.clamp(thresh, min=1e-9)) & inside & (align > 0)

    # an anchor belongs to the GT with the largest alignment
    masked = torch.where(is_topk, align, torch.full_like(align, -1.0))
    assigned_gt = torch.argmax(masked, dim=1)   # the first maximum
    pos = masked.amax(dim=1) > 0

    zero = torch.zeros_like(align)
    per_gt_align = torch.where(is_topk, align, zero).amax(-1, keepdim=True)
    per_gt_iou = torch.where(is_topk, iou, zero).amax(-1, keepdim=True)
    norm = align / torch.clamp(per_gt_align, min=1e-9) * per_gt_iou
    norm_align = torch.where(is_topk, norm, zero).amax(dim=1)
    return {"assigned_gt": assigned_gt, "pos": pos,
            "norm_align": torch.where(pos, norm_align,
                                      torch.zeros_like(norm_align))}


def _flat(levels, b, c):
    """Per-level (B, h, w, C) outputs -> (B, N, C)."""
    return torch.cat([o.reshape(b, -1, c) for o in levels], 1)


def _dfl(logp, tgt_ltrb, weights, norm):
    """Distribution-focal loss: cross-entropy of (B, N, 4, REG_MAX) log
    probabilities against the two integer bins around each target
    distance, weighted per anchor and normalized."""
    tgt = torch.clamp(tgt_ltrb, 0.0, REG_MAX - 1.01)
    tl = torch.floor(tgt)
    wr = tgt - tl
    wl = 1.0 - wr
    tl_i = tl.long()

    def gather(idx):
        return torch.gather(logp, -1, idx[..., None])[..., 0]

    dfl = -(gather(tl_i) * wl
            + gather(torch.clamp(tl_i + 1, max=REG_MAX - 1)) * wr)
    return torch.sum(dfl.mean(-1) * weights) / norm


def detection_loss(outputs, targets, num_classes: int,
                   level_shapes: LevelShapes, cls_weight: float = 0.5,
                   box_weight: float = 7.5, dfl_weight: float = 1.5,
                   assigner: str = "tal", seg_weight: float = 1.0,
                   group=None):
    """The loss of one batch: ``(total, parts)``.

    Args:
      outputs: :class:`Yolo11`'s raw outputs (box / cls, and coef / proto
        for the mask loss).
      targets: ``boxes`` (B, T, 4) xyxy in letterbox pixels, ``classes``
        (B, T) int64, ``valid`` (B, T) bool, and optionally ``masks`` (B,
        T, Hp, Wp) {0, 1} at prototype resolution.
      level_shapes: (h, w) per level.
      assigner: "tal", or "center" (one anchor per GT, at its centre's
        cell on the level of its size).
      group: the process group the batch is split over (None: this
        rank's batch): the normalisers are then the whole batch's, and the
        loss and its parts this rank's share of the whole batch's.
    """
    b = targets["boxes"].shape[0]
    box_flat = _flat(outputs["box"], b, 4 * REG_MAX)
    cls_flat = _flat(outputs["cls"], b, outputs["cls"][0].shape[-1])
    if assigner == "tal":
        seg = None
        if "masks" in targets and "coef" in outputs:
            seg = (outputs["proto"],
                   _flat(outputs["coef"], b, outputs["coef"][0].shape[-1]),
                   targets["masks"])
        return _tal_loss(box_flat, cls_flat, targets, num_classes,
                         level_shapes, cls_weight, box_weight, dfl_weight,
                         seg=seg, seg_weight=seg_weight, group=group)
    if assigner != "center":
        raise ValueError(f"assigner must be 'tal' or 'center', got "
                         f"{assigner!r}")
    return _center_loss(box_flat, cls_flat, targets, num_classes,
                        level_shapes, cls_weight, box_weight, dfl_weight,
                        group)


def _center_loss(box_flat, cls_flat, targets, num_classes, level_shapes,
                 cls_weight, box_weight, dfl_weight, group=None):
    """``detection_loss(..., assigner="center")``
    (``parallel/train.py:160-223`` of the JAX package)."""
    dev = box_flat.device
    b, n_anchors, _ = box_flat.shape
    strides = torch.tensor(STRIDES, dtype=torch.float32, device=dev)
    offsets = np.cumsum([0] + [h * w for h, w in level_shapes])[:-1]
    level_offset = torch.tensor(offsets, device=dev)
    level_h = torch.tensor([h for h, _ in level_shapes], device=dev)
    level_w = torch.tensor([w for _, w in level_shapes], device=dev)

    tb = targets["boxes"].float()
    center = (tb[..., :2] + tb[..., 2:]) / 2
    wh = tb[..., 2:] - tb[..., :2]
    lvl = _level_of(wh)                                        # (B, T)
    stride_t = strides[lvl]
    cell = torch.floor(center / stride_t[..., None]).long()
    lh, lw = level_h[lvl], level_w[lvl]
    cx = torch.minimum(torch.clamp(cell[..., 0], min=0), lw - 1)
    cy = torch.minimum(torch.clamp(cell[..., 1], min=0), lh - 1)
    anchor_idx = level_offset[lvl] + cy * lw + cx              # (B, T)
    tvalid = targets["valid"]
    fvalid = tvalid.float()
    n_valid = torch.clamp(global_sum(fvalid.sum(), group),
                          min=1.0)

    # classification: BCE over every anchor, one-hot (max) at assignments
    batch_ix = torch.arange(b, device=dev)[:, None]
    flat_ix = (batch_ix * n_anchors + anchor_idx) * num_classes \
        + targets["classes"]
    cls_target = torch.zeros(b * n_anchors * num_classes, device=dev)
    cls_target.scatter_reduce_(0, flat_ix.reshape(-1), fvalid.reshape(-1),
                               "amax")
    cls_loss = sigmoid_bce(cls_flat.float(), cls_target.reshape(
        b, n_anchors, num_classes)).sum() / n_valid

    # box regression at the assigned anchors
    pred_bins = box_flat[batch_ix, anchor_idx].float().reshape(
        b, -1, 4, REG_MAX)
    proj = torch.arange(REG_MAX, dtype=torch.float32, device=dev)
    pred_ltrb = torch.softmax(pred_bins, -1) @ proj
    ax = (cx.float() + 0.5) * stride_t
    ay = (cy.float() + 0.5) * stride_t
    tgt_ltrb = torch.stack([(ax - tb[..., 0]) / stride_t,
                            (ay - tb[..., 1]) / stride_t,
                            (tb[..., 2] - ax) / stride_t,
                            (tb[..., 3] - ay) / stride_t], -1)
    px1 = ax - pred_ltrb[..., 0] * stride_t
    py1 = ay - pred_ltrb[..., 1] * stride_t
    px2 = ax + pred_ltrb[..., 2] * stride_t
    py2 = ay + pred_ltrb[..., 3] * stride_t
    ix1 = torch.maximum(px1, tb[..., 0])
    iy1 = torch.maximum(py1, tb[..., 1])
    ix2 = torch.minimum(px2, tb[..., 2])
    iy2 = torch.minimum(py2, tb[..., 3])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    area_p = torch.clamp(px2 - px1, min=0) * torch.clamp(py2 - py1, min=0)
    area_t = torch.clamp(wh[..., 0], min=0) * torch.clamp(wh[..., 1], min=0)
    iou = inter / torch.clamp(area_p + area_t - inter, min=1e-9)
    box_loss = torch.sum((1.0 - iou) * fvalid) / n_valid

    dfl = _dfl(torch.log_softmax(pred_bins, -1), tgt_ltrb, fvalid, n_valid)
    total = cls_weight * cls_loss + box_weight * box_loss + dfl_weight * dfl
    return total, {"cls": cls_loss, "box": box_loss, "dfl": dfl}


def _tal_loss(box_flat, cls_flat, targets, num_classes, level_shapes,
              cls_weight, box_weight, dfl_weight, seg=None,
              seg_weight: float = 1.0, group=None):
    """The anchor-centric v8 loss under task-aligned assignment: BCE with
    soft (alignment-normalized) targets, IoU + DFL regression on positives
    weighted by the soft target, and the mask loss when ``seg`` is
    given."""
    b, n, nc = cls_flat.shape
    centers, strides_n = _anchor_centers(level_shapes, box_flat.device)
    stride3 = strides_n[None, :, None]

    bins = box_flat.reshape(b, n, 4, REG_MAX).float()
    proj = torch.arange(REG_MAX, dtype=torch.float32, device=bins.device)
    ltrb = torch.softmax(bins, -1) @ proj                     # (B, N, 4)
    pred_boxes = torch.cat([centers[None] - ltrb[..., :2] * stride3,
                            centers[None] + ltrb[..., 2:] * stride3], -1)

    assign = task_aligned_assign(cls_flat, pred_boxes, targets["boxes"],
                                 targets["classes"], targets["valid"],
                                 level_shapes)
    pos, soft, agt = (assign["pos"], assign["norm_align"],
                      assign["assigned_gt"])

    gt_boxes = torch.gather(targets["boxes"].float(), 1,
                            agt[..., None].expand(b, n, 4))
    gt_cls = torch.gather(targets["classes"], 1, agt)

    # classification: BCE with soft targets (ultralytics v8)
    labels = F.one_hot(gt_cls, nc).float() * soft[..., None]
    norm = torch.clamp(global_sum(soft.sum(), group), min=1.0)
    cls_loss = sigmoid_bce(cls_flat.float(), labels).sum() / norm

    # IoU loss on positives, weighted by the soft target
    ix1 = torch.maximum(pred_boxes[..., 0], gt_boxes[..., 0])
    iy1 = torch.maximum(pred_boxes[..., 1], gt_boxes[..., 1])
    ix2 = torch.minimum(pred_boxes[..., 2], gt_boxes[..., 2])
    iy2 = torch.minimum(pred_boxes[..., 3], gt_boxes[..., 3])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    area_p = (torch.clamp(pred_boxes[..., 2] - pred_boxes[..., 0], min=0)
              * torch.clamp(pred_boxes[..., 3] - pred_boxes[..., 1], min=0))
    area_g = ((gt_boxes[..., 2] - gt_boxes[..., 0])
              * (gt_boxes[..., 3] - gt_boxes[..., 1]))
    iou = inter / torch.clamp(area_p + area_g - inter, min=1e-9)
    w = soft * pos.float()
    box_loss = torch.sum((1.0 - iou) * w) / norm

    # DFL on positives
    tgt_ltrb = torch.cat([(centers[None] - gt_boxes[..., :2]) / stride3,
                          (gt_boxes[..., 2:] - centers[None]) / stride3], -1)
    dfl_loss = _dfl(torch.log_softmax(bins, -1), tgt_ltrb, w, norm)

    total = (cls_weight * cls_loss + box_weight * box_loss
             + dfl_weight * dfl_loss)
    parts = {"cls": cls_loss, "box": box_loss, "dfl": dfl_loss}
    if seg is not None:
        proto, coef_flat, gt_masks = seg
        seg_l = segmentation_loss(proto, coef_flat, assign, gt_masks,
                                  targets["boxes"], level_shapes,
                                  group=group)
        total = total + seg_weight * seg_l
        parts["seg"] = seg_l
    return total, parts


def segmentation_loss(proto, coef_flat, assign, gt_masks, gt_boxes,
                      level_shapes: LevelShapes, max_pos: int = 64,
                      group=None):
    """The Segment head's instance-mask loss (ultralytics v8-seg): for the
    ``max_pos`` anchors of largest soft target a frame (a stable
    descending sort, lowest index first among ties, as ``jax.lax.top_k``),
    the mask logits ``coef . proto`` at prototype resolution, BCE against
    the assigned GT mask inside its GT box, normalized by the box's area
    and weighted by the soft target.

    Args:
      proto: (B, Hp, Wp, nm) prototypes; coef_flat: (B, N, nm).
      assign: :func:`task_aligned_assign`'s dict.
      gt_masks: (B, T, Hp, Wp) {0, 1}; gt_boxes: (B, T, 4) letterbox px.
      group: as :func:`detection_loss`'s (the weights' sum is the whole
        batch's).
    """
    b, hp, wp, nm = proto.shape
    scale = hp / (level_shapes[0][0] * STRIDES[0])   # letterbox -> proto

    key = torch.where(assign["pos"], assign["norm_align"],
                      torch.full_like(assign["norm_align"], -1.0))
    top_w, top_i = torch.sort(key, dim=1, descending=True, stable=True)
    top_w, top_i = top_w[:, :max_pos], top_i[:, :max_pos]       # (B, K)
    k = top_i.shape[1]
    coef = torch.gather(coef_flat, 1, top_i[..., None].expand(b, k, nm))
    agt = torch.gather(assign["assigned_gt"], 1, top_i)

    # a plain product, outside any kernel in the JAX package too
    pred = torch.einsum("bkn,bhwn->bkhw", coef.float(), proto.float())
    batch_ix = torch.arange(b, device=proto.device)[:, None]
    tgt = gt_masks.float()[batch_ix, agt]                       # (B, K, h, w)
    boxes = torch.gather(gt_boxes.float(), 1,
                         agt[..., None].expand(b, k, 4)) * scale

    bce = sigmoid_bce(pred, tgt)
    xs = torch.arange(wp, dtype=torch.float32, device=proto.device)
    ys = torch.arange(hp, dtype=torch.float32, device=proto.device)[:, None]
    edge = [boxes[..., i, None, None] for i in range(4)]
    in_box = ((xs >= edge[0]) & (xs < edge[2]) & (ys >= edge[1])
              & (ys < edge[3])).float()
    area = torch.clamp(in_box.sum((-2, -1)), min=1.0)
    per_inst = (bce * in_box).sum((-2, -1)) / area
    w = (top_w > 0).float() * top_w
    return torch.sum(per_inst * w) / torch.clamp(
        global_sum(w.sum(), group), min=1.0)


# ---------------------------------------------------------------------------
# Train state + step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """The network (parameters and BatchNorm statistics), the optimizer's
    state, the step count, and the EMA of every variable (state-dict
    keyed; None when disabled)."""

    model: Yolo11
    opt_state: AdamWState
    step: int
    ema: Optional[Dict[str, torch.Tensor]] = None

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def param_shardings(mesh, model: Yolo11) -> Dict[str, Optional[int]]:
    """JAX's rule for the ``model`` axis, per parameter name: the dim a
    parameter is sliced along over ``model``, or None where it is
    replicated.  A 4-D kernel whose Flax kernel's last (output) axis the
    axis size tp divides, with tp > 1, is sliced along that axis: dim 0
    of a ``Conv2d`` weight (OIHW); dim 3 of the Proto's
    ``ConvTranspose2d`` weight, whose Flax kernel keeps torch's (in, out,
    2, 2) layout, so that its last axis is the kernel's width
    (:func:`..models.yolo.weights.flax_kernel_axes`).  Everything else is
    replicated."""
    tp = axis_size(mesh, MODEL_AXIS)
    rule = {}
    for name, p in model.named_parameters():
        dim = flax_kernel_axes(name)[-1] if p.dim() == 4 else None
        rule[name] = (dim if dim is not None and tp > 1
                      and p.shape[dim] % tp == 0 else None)
    return rule


class YoloTrainer:
    """YOLO11-seg training on ``device``, one batch per
    :meth:`train_step`.

    The network is initialized by :func:`..models.yolo.init.initialize`
    from ``seed`` (JAX's ``PRNGKey(seed)`` draws cannot be reproduced);
    :meth:`load` takes a checkpoint's variables instead.
    ``learning_rate`` is a float or a schedule of the update count
    (:func:`.optim.warmup_cosine_decay_schedule`).  A batch has the
    shapes the JAX trainer's compiled step takes: images of
    ``image_size`` and ``max_targets`` target slots a frame (:meth:`put`
    refuses others).

    With a ``mesh`` (:func:`.mesh.make_mesh`) the batch is the global
    batch, whose frames the ``data`` axis divides; :meth:`train_step`
    takes this rank's rows of it, and the trainer holds this rank's
    slices of the kernels :func:`param_shardings` names, with their AdamW
    moments and EMA entries.  Every rank calls :meth:`train_step`,
    :meth:`variables`, :meth:`ema_variables` and :meth:`opt_state_dict`
    together: they are collective.

    ``dtype`` is the network's compute dtype, float32 or bfloat16 (the
    JAX trainer's ``dtype``); the variables, gradients, moments and EMA
    are float32 either way, so a checkpoint's trees have the float32
    trainer's layout.
    """

    def __init__(self, cfg: YoloConfig, image_size=(192, 640),
                 max_targets: int = 32,
                 learning_rate: Union[float, Schedule] = 1e-3,
                 weight_decay: float = 5e-4, seg_weight: float = 1.0,
                 ema_decay: float = 0.0, seed: int = 0, device="cuda",
                 mesh=None, dtype: torch.dtype = torch.float32):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' was asked for, but CUDA is not "
                               "available; pass device='cpu' to train on the "
                               "CPU")
        self.cfg = cfg
        self.image_size = tuple(image_size)
        self.max_targets = max_targets
        self.level_shapes = tuple((image_size[0] // s, image_size[1] // s)
                                  for s in STRIDES)
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.seg_weight = seg_weight
        self.ema_decay = float(ema_decay)
        self.dtype = dtype
        # Yolo11's constructor draws PyTorch's own init, which initialize
        # overwrites: keep the caller's global generator untouched
        with torch.random.fork_rng(devices=[]):
            model = initialize(Yolo11(cfg, dtype), seed).to(self.device)
        self.mesh = mesh
        self.data_group = self.model_group = None
        self.shard_dims: Dict[str, int] = {}
        if mesh is not None:
            self.data_group = mesh.get_group(DATA_AXIS)
            self.model_group = mesh.get_group(MODEL_AXIS)
            self.shard_dims = {k: d for k, d in param_shardings(
                mesh, model).items() if d is not None}
            self._keep_own_slices(model)
            split_batch(model, self.data_group)
        self.state = TrainState(
            model=model,
            opt_state=AdamWState.zeros(dict(model.named_parameters())),
            step=0, ema=self._ema_copy(model))

    @property
    def model(self) -> Yolo11:
        return self.state.model

    def _keep_own_slices(self, model) -> None:
        """Replace each sharded parameter by this rank's slice of it."""
        modules = dict(model.named_modules())
        with torch.no_grad():
            for name, dim in self.shard_dims.items():
                stem, leaf = name.rsplit(".", 1)
                full = getattr(modules[stem], leaf)
                setattr(modules[stem], leaf, torch.nn.Parameter(
                    self._own(full, name).clone()))

    def _own(self, full: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's slice of the full tensor of parameter ``name``
        (the tensor itself where it is replicated)."""
        dim = self.shard_dims.get(name)
        if dim is None:
            return full
        return collectives.own_slice(full, dim, self.model_group)

    def full_tree(self, tree: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """A name-keyed tree (parameters, gradients, moments, a state
        dict) with each sharded entry gathered over ``model`` whole
        (collective)."""
        if not self.shard_dims:
            return tree
        return {k: collectives.all_gather_cat(v, self.model_group,
                                              self.shard_dims[k])
                if k in self.shard_dims else v for k, v in tree.items()}

    def _ema_copy(self, model) -> Optional[Dict[str, torch.Tensor]]:
        if self.ema_decay <= 0:
            return None
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    # -- the step ------------------------------------------------------------

    def forward(self, images):
        """The network's forward on ``images``, its sharded kernels
        all-gathered over ``model`` first."""
        if not self.shard_dims:
            return self.model(images)
        params = self.state.params()
        names = list(self.shard_dims)
        full = collectives.gather_shards(
            [params[k] for k in names], [self.shard_dims[k] for k in names],
            self.model_group)
        return torch.func.functional_call(self.model, dict(zip(names, full)),
                                          (images,))

    def loss(self, images, targets):
        """The train-mode forward (BatchNorm statistics updated) and
        ``(total, parts)`` on device tensors (:meth:`put`; with a mesh,
        this rank's rows, :meth:`local_batch`): with a mesh, this rank's
        share of the global batch's loss and parts."""
        self.model.train()
        with numerics(self.dtype):
            out = self.forward(images)
            return detection_loss(out, targets, self.cfg.num_classes,
                                  self.level_shapes,
                                  seg_weight=self.seg_weight,
                                  group=self.data_group)

    def gradients(self, loss) -> Dict[str, torch.Tensor]:
        """The gradients of the parameters this rank holds; with a mesh,
        of the global batch's loss: the shares' gradients summed over
        ``data`` in one all-reduce."""
        params = self.state.params()
        with numerics(self.dtype), repeatable():
            grads = torch.autograd.grad(loss, list(params.values()))
        if self.data_group is not None:
            grads = collectives.all_reduce_coalesced(grads, self.data_group)
        return dict(zip(params, grads))

    def rate(self) -> float:
        """The learning rate of the next update."""
        return rate_at(self.learning_rate, self.state.opt_state.count)

    def update(self, grads: Dict[str, torch.Tensor]) -> None:
        """AdamW on the parameters, the step count, then the EMA."""
        state = self.state
        state.opt_state = adamw_update(state.params(), grads,
                                       state.opt_state, self.rate(),
                                       self.weight_decay)
        state.step += 1
        if state.ema is not None:
            self.update_ema()

    @torch.no_grad()
    def update_ema(self) -> None:
        """``e = e * d + v * (1 - d)`` over every variable, ``d =
        min(decay, (1 + t) / (10 + t))`` in float32 at the new step t (a
        warm-up: early steps follow the weights)."""
        t = self.state.step
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        d = torch.minimum(f32(self.ema_decay), f32(1.0 + t) / f32(10.0 + t))
        keep = 1 - d
        for key, v in self.model.state_dict().items():
            e = self.state.ema[key]
            e.copy_(e * d + v.to(e.dtype) * keep)

    def put(self, images, targets) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """A batch on the device (with a mesh, the global batch):
        images (B, H, W, 3) float32 in [0, 1], whatever the compute dtype
        (the first convolution casts them, as Flax's does);
        targets (B, T, ...) ``boxes`` float32, ``classes`` int64,
        ``valid`` bool and ``masks`` float32 (numpy arrays or tensors)."""
        dtypes = {"boxes": torch.float32, "classes": torch.int64,
                  "valid": torch.bool, "masks": torch.float32}
        as_t = lambda a: a if torch.is_tensor(a) else torch.from_numpy(
            np.asarray(a))
        images = as_t(images).to(self.device, torch.float32)
        targets = {k: as_t(v).to(self.device, dtypes[k])
                   for k, v in targets.items()}
        got = tuple(images.shape[1:3]), targets["boxes"].shape[1]
        if got != (self.image_size, self.max_targets):
            raise ValueError(f"the trainer takes {self.image_size} images "
                             f"and {self.max_targets} targets a frame, got "
                             f"{got[0]} and {got[1]}")
        return images, targets

    def local_batch(self, images, targets):
        """This rank's rows of a global batch (:meth:`put`'s), split over
        ``data``; the batch itself without a mesh."""
        if self.mesh is None:
            return images, targets
        return (data_sharding(self.mesh, images),
                {k: data_sharding(self.mesh, v) for k, v in targets.items()})

    def train_step(self, images, targets) -> Dict[str, Any]:
        """One optimizer step: the loss and its parts of the (global)
        batch before the update, as device tensors, and the new step."""
        images, targets = self.local_batch(*self.put(images, targets))
        loss, parts = self.loss(images, targets)
        self.update(self.gradients(loss))
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in parts.items()}}
        if self.data_group is not None:
            keys = list(metrics)
            metrics = dict(zip(keys, collectives.all_reduce_coalesced(
                [metrics[k] for k in keys], self.data_group)))
        return {**metrics, "step": self.state.step}

    # -- checkpoints ---------------------------------------------------------

    def variables(self) -> dict:
        """The Flax ``{"params", "batch_stats"}`` tree, numpy arrays (the
        full tree on every rank)."""
        return yolo_flax_from_state(self.full_tree(self.model.state_dict()),
                                    self.cfg.segment)

    def ema_variables(self) -> Optional[dict]:
        if self.state.ema is None:
            return None
        return yolo_flax_from_state(self.full_tree(self.state.ema),
                                    self.cfg.segment)

    def opt_state_dict(self) -> dict:
        """``optax.adamw``'s state as flax's ``to_state_dict`` lays it out
        (:func:`.optim.adamw_state_dict`), the full moments."""
        opt = self.state.opt_state
        full = AdamWState(count=opt.count, mu=self.full_tree(opt.mu),
                          nu=self.full_tree(opt.nu))
        return adamw_state_dict(
            full, lambda tree: yolo_flax_from_state(
                tree, self.cfg.segment)["params"],
            schedule=callable(self.learning_rate))

    def _own_tree(self, tree: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        return {k: self._own(v, k).contiguous() for k, v in tree.items()}

    def load(self, variables: dict, step: int = 0,
             ema_variables: Optional[dict] = None) -> None:
        """Take a Flax variables tree (a checkpoint's), the step count and,
        where the EMA is on, the EMA's tree (``variables`` when None);
        with a mesh, this rank keeps its slices."""
        self.model.load_state_dict(
            self._own_tree(from_flax_variables(variables)), strict=True)
        self.state.step = int(step)
        if self.state.ema is not None:
            src = self._own_tree(from_flax_variables(ema_variables
                                                     or variables))
            # copies: on the CPU ``to`` would return the caller's arrays,
            # which the EMA's updates would then write into
            self.state.ema = {k: src[k].to(self.device, v.dtype, copy=True)
                              for k, v in self.state.ema.items()}

    def load_opt_state(self, tree: dict) -> None:
        """Take an optimizer state in :meth:`opt_state_dict`'s layout."""
        opt = adamw_state_from_dict(
            tree, lambda moments: from_flax_variables({"params": moments}),
            self.device)
        self.state.opt_state = AdamWState(
            count=opt.count, mu=self._own_tree(opt.mu),
            nu=self._own_tree(opt.nu))
