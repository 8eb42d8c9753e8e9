"""CenterPoint-style center-heatmap head on the pillar backbone.

Counterpart of ``lidar_object_detection_tpu/models/pointpillars/center.py``:
a 3 x 3 trunk and 1 x 1 heatmap and regression heads (``CenterHead``,
lines 39-72), decoded without NMS -- a cell is a detection where it is the
3 x 3 maximum of its class heatmap, and the best peaks by score are
decoded (``decode_center``, lines 251-288) -- and trained on gaussian-splat
heatmap targets with a penalty-reduced focal loss and an L1 regression at
the GT center cells (lines 74-249: ``gaussian_radius``,
``render_center_targets``, ``penalty_reduced_focal``, ``center_loss``,
``gt_point_counts``, ``starve_weights``).  The training functions take
the frames on a leading axis, where the JAX package ``vmap``s one frame.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lidar_object_detection_tpu_torch.models.common import (
    Conv2d, global_sum, true_div)
from lidar_object_detection_tpu_torch.models.pointpillars.decode import (
    top_k_lowest_index)


class CenterHead(nn.Module):
    """heat: (B, H, W, nc) center logits; reg: (B, H, W, 8) = (off_x,
    off_y, z, log w, log l, log h, sin yaw, cos yaw).  NCHW in,
    channels-last out."""

    def __init__(self, cfg):
        super().__init__()
        from lidar_object_detection_tpu_torch.models.pointpillars.model \
            import ConvBN

        c = cfg.up_channels * len(cfg.backbone_channels)
        self.trunk = ConvBN(c, cfg.up_channels, 3, 1,
                            momentum=cfg.bn_momentum)
        self.heat = Conv2d(cfg.up_channels, cfg.num_classes, 1)
        self.reg = Conv2d(cfg.up_channels, 8, 1)

    def forward(self, x, train: bool = False):
        x = self.trunk(x, train)
        return {"heat": self.heat(x).permute(0, 2, 3, 1),
                "reg": self.reg(x).permute(0, 2, 3, 1)}


def _head_cell(cfg) -> float:
    return cfg.grid.pillar_size * cfg.out_stride


def _head_shape(cfg):
    return cfg.grid.ny // cfg.out_stride, cfg.grid.nx // cfg.out_stride


# gaussian window half-size in cells (WINDOW_R of the JAX module)
WINDOW_R = 16
WINDOW = 2 * WINDOW_R + 1


def gaussian_radius(l_cells, w_cells, min_overlap: float = 0.7):
    """CornerNet radius: the largest center shift (in cells) that keeps
    the IoU with the true box above ``min_overlap``, the least over the
    three displacement cases."""
    h, w = l_cells, w_cells
    a1 = 1.0
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 - torch.sqrt(torch.clamp(b1 ** 2 - 4 * a1 * c1, min=0.0))) \
        / (2 * a1)
    a2 = 4.0
    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 - torch.sqrt(torch.clamp(b2 ** 2 - 4 * a2 * c2, min=0.0))) \
        / (2 * a2)
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (-b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0.0))) \
        / (2 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)


def render_center_targets(gt_boxes7, gt_classes, gt_valid, cfg):
    """GT boxes of a batch -> dense heatmap targets and per-GT regression
    targets.

    Takes (B, G, 7), (B, G) and (B, G).  Returns dict: heat (B, H, W, nc),
    the max of the GTs' gaussians, exactly 1 at the center cells; ind
    (B, G) int64, the flattened H*W center cell of each GT (0 if not
    masked); reg (B, G, 8); mask (B, G) bool, valid with the center
    inside the grid.
    """
    g0 = cfg.grid
    cell = _head_cell(cfg)
    h, w = _head_shape(cfg)
    nc = cfg.num_classes
    b, gmax = gt_boxes7.shape[:2]
    dev = gt_boxes7.device

    cx = true_div(gt_boxes7[..., 0] - g0.x_range[0], cell)  # (B, G) cells
    cy = true_div(gt_boxes7[..., 1] - g0.y_range[0], cell)
    ix = torch.floor(cx).to(torch.int64)
    iy = torch.floor(cy).to(torch.int64)
    inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    mask = gt_valid & inside

    l_cells = true_div(gt_boxes7[..., 4], cell)
    w_cells = true_div(gt_boxes7[..., 3], cell)
    radius = torch.clamp(gaussian_radius(l_cells, w_cells), 1.0, WINDOW_R)
    sigma = (2 * radius + 1) / 6.0                           # (B, G)

    d = torch.arange(-WINDOW_R, WINDOW_R + 1, device=dev)
    dyy, dxx = torch.meshgrid(d, d, indexing="ij")           # (W, W)
    val = torch.exp(-(dxx ** 2 + dyy ** 2)
                    / (2 * sigma[..., None, None] ** 2))     # (B, G, W, W)
    wy = iy[..., None, None] + dyy
    wx = ix[..., None, None] + dxx
    ok = (mask[..., None, None] & (wx >= 0) & (wx < w)
          & (wy >= 0) & (wy < h))
    val = torch.where(ok, val, 0.0)
    # out-of-bounds and masked cells go to a scratch cell past the map
    flat = torch.where(ok, wy * w + wx, h * w)
    cls = torch.clamp(gt_classes.long(), 0, nc - 1)
    index = (flat * nc + cls[..., None, None]).reshape(b, -1)
    heat = torch.zeros((b, (h * w + 1) * nc), dtype=torch.float32,
                       device=dev)
    heat.scatter_reduce_(1, index, val.reshape(b, -1).to(torch.float32),
                         "amax")
    heat = heat[:, :h * w * nc].reshape(b, h, w, nc)

    ind = torch.where(mask, iy * w + ix, 0)
    reg = torch.stack([
        cx - ix.to(torch.float32),
        cy - iy.to(torch.float32),
        gt_boxes7[..., 2],
        torch.log(torch.clamp(gt_boxes7[..., 3], min=1e-3)),
        torch.log(torch.clamp(gt_boxes7[..., 4], min=1e-3)),
        torch.log(torch.clamp(gt_boxes7[..., 5], min=1e-3)),
        torch.sin(gt_boxes7[..., 6]),
        torch.cos(gt_boxes7[..., 6]),
    ], dim=-1)
    return {"heat": heat, "ind": ind, "reg": reg, "mask": mask}


def penalty_reduced_focal(logits, targets, alpha: float = 2.0,
                          beta: float = 4.0, pos_weight=None):
    """CornerNet focal: positives are the cells whose target is 1, the
    gaussian tail (to the 4th power) down-weights the negatives near
    centers; ``pos_weight`` (targets' shape) scales the positive term."""
    p = torch.sigmoid(logits.to(torch.float32))
    p = torch.clamp(p, 1e-6, 1 - 1e-6)
    pos = (targets >= 1.0 - 1e-6).to(torch.float32)
    pos_loss = -((1 - p) ** alpha) * torch.log(p) * pos
    if pos_weight is not None:
        pos_loss = pos_loss * pos_weight
    neg_loss = (-((1 - targets) ** beta) * (p ** alpha) * torch.log(1 - p)
                * (1 - pos))
    return pos_loss + neg_loss


def center_loss(outputs, gt_boxes7, gt_classes, gt_valid, cfg,
                heat_weight: float = 1.0, reg_weight: float = 2.0,
                gt_pos_weight=None, group=None):
    """Batched CenterPoint loss, the keys of
    :func:`.loss.pointpillars_loss` (``dir`` is 0).  ``gt_pos_weight``
    (B, G) >= 1 weights each GT's positive heatmap cell and regression
    term (:func:`starve_weights`); ``group`` as
    :func:`.loss.pointpillars_loss`'s."""
    targets = render_center_targets(gt_boxes7, gt_classes, gt_valid, cfg)
    heat_logits = outputs["heat"].to(torch.float32)
    b = heat_logits.shape[0]
    h, w = _head_shape(cfg)
    nc = cfg.num_classes
    num_pos = torch.clamp(global_sum(targets["mask"].sum(),
                                                 group),
                          min=1).to(torch.float32)

    pw_map = None
    gt_w = None
    if gt_pos_weight is not None:
        gt_w = torch.clamp(gt_pos_weight.to(torch.float32), min=1.0)
        cls = torch.clamp(gt_classes.long(), 0, nc - 1)
        wmap = torch.ones((b, (h * w + 1) * nc), dtype=torch.float32,
                          device=gt_w.device)
        wmap.scatter_reduce_(1, targets["ind"] * nc + cls,
                             torch.where(targets["mask"], gt_w, 1.0), "amax")
        pw_map = wmap[:, :h * w * nc].reshape(b, h, w, nc)

    heat_l = torch.sum(penalty_reduced_focal(
        heat_logits, targets["heat"], pos_weight=pw_map)) / num_pos

    reg_map = outputs["reg"].to(torch.float32).reshape(b, h * w, 8)
    pred = torch.gather(reg_map, 1, targets["ind"][..., None].expand(
        *targets["ind"].shape, 8))
    l1 = torch.sum(torch.abs(pred - targets["reg"]), dim=-1)
    reg_w = targets["mask"].to(torch.float32)
    if gt_w is not None:
        reg_w = reg_w * gt_w
    reg_l = torch.sum(l1 * reg_w) / num_pos

    total = heat_weight * heat_l + reg_weight * reg_l
    return {"loss": total, "cls": heat_l, "box": reg_l,
            "dir": torch.zeros((), dtype=torch.float32,
                               device=heat_logits.device),
            "num_pos": num_pos}


def gt_point_counts(points, valid, gt_boxes7, gt_valid):
    """(B, G) float32 in-box point counts: the rotated BEV footprint and
    the z extent, points (B, P, >=3), boxes (B, G, 7) with the length
    along the box's local +x."""
    xy = points[..., :2]
    z = points[..., 2]
    dx = xy[..., 0][:, :, None] - gt_boxes7[:, None, :, 0]   # (B, P, G)
    dy = xy[..., 1][:, :, None] - gt_boxes7[:, None, :, 1]
    yaw = gt_boxes7[..., 6][:, None, :]
    c, s = torch.cos(yaw), torch.sin(yaw)
    lx = dx * c + dy * s
    ly = -dx * s + dy * c
    dz = z[:, :, None] - gt_boxes7[:, None, :, 2]
    inside = ((torch.abs(lx) <= gt_boxes7[:, None, :, 4] / 2)
              & (torch.abs(ly) <= gt_boxes7[:, None, :, 3] / 2)
              & (torch.abs(dz) <= gt_boxes7[:, None, :, 5] / 2)
              & valid[:, :, None])
    return inside.sum(dim=1).to(torch.float32) * gt_valid


def starve_weights(points, valid, gt_boxes7, gt_valid, cfg):
    """``1 + starve_weight * exp(-count / starve_n0)``: about 1 +
    starve_weight for an empty box, 1 for a dense one."""
    counts = gt_point_counts(points, valid, gt_boxes7, gt_valid)
    return 1.0 + cfg.starve_weight * torch.exp(-counts / cfg.starve_n0)


def decode_center(outputs, cfg, score_threshold: float = 0.3,
                  max_detections: int = 64, **_ignored):
    """Raw center heads of ONE frame -> detections, NMS-free: the 3 x 3
    peaks (``max_pool2d`` pads with -inf, as JAX's ``reduce_window``),
    then the top ``max_detections`` by score, ties to the lowest index.
    Returns the dict of :func:`.decode.decode_predictions`."""
    heat = torch.sigmoid(outputs["heat"].to(torch.float32))   # (H, W, nc)
    h, w, nc = heat.shape
    hmax = F.max_pool2d(heat.permute(2, 0, 1)[None], 3, stride=1,
                        padding=1)[0].permute(1, 2, 0)
    peak = torch.where(heat >= hmax, heat, 0.0)

    flat = peak.reshape(-1)                                  # H*W*nc
    k = min(max_detections, flat.shape[0])
    scores, idx = top_k_lowest_index(flat, k)
    cls = (idx % nc).to(torch.int32)
    cell = idx // nc
    iy = cell // w
    ix = cell % w

    reg = outputs["reg"].to(torch.float32).reshape(h * w, 8)
    r = reg[cell]                                            # (K, 8)
    csize = _head_cell(cfg)
    g0 = cfg.grid
    x = g0.x_range[0] + (ix.to(torch.float32) + r[:, 0]) * csize
    y = g0.y_range[0] + (iy.to(torch.float32) + r[:, 1]) * csize
    boxes7 = torch.stack([
        x, y, r[:, 2],
        torch.exp(r[:, 3]), torch.exp(r[:, 4]), torch.exp(r[:, 5]),
        torch.atan2(r[:, 6], r[:, 7]),
    ], dim=-1)
    valid = scores > score_threshold
    return {"boxes7": boxes7, "scores": torch.where(valid, scores, 0.0),
            "classes": cls, "valid": valid}


__all__ = ["CenterHead", "decode_center", "center_loss",
           "render_center_targets", "gaussian_radius",
           "penalty_reduced_focal", "gt_point_counts", "starve_weights"]
