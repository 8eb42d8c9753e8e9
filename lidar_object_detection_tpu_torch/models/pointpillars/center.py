"""CenterPoint-style center-heatmap head on the pillar backbone, for
inference.

Counterpart of ``lidar_object_detection_tpu/models/pointpillars/center.py``
(``CenterHead``, ``_head_cell``, ``_head_shape``, lines 39-72, and
``decode_center``, lines 251-288): a 3 x 3 trunk and 1 x 1 heatmap and
regression heads, decoded without NMS -- a cell is a detection where it is
the 3 x 3 maximum of its class heatmap, and the best peaks by score are
decoded.  The loss and the target rendering are training, ROADMAP Queue 1
item 7.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

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
        self.trunk = ConvBN(c, cfg.up_channels, 3, 1)
        self.heat = nn.Conv2d(cfg.up_channels, cfg.num_classes, 1)
        self.reg = nn.Conv2d(cfg.up_channels, 8, 1)

    def forward(self, x):
        x = self.trunk(x)
        return {"heat": self.heat(x).permute(0, 2, 3, 1),
                "reg": self.reg(x).permute(0, 2, 3, 1)}


def _head_cell(cfg) -> float:
    return cfg.grid.pillar_size * cfg.out_stride


def _head_shape(cfg):
    return cfg.grid.ny // cfg.out_stride, cfg.grid.nx // cfg.out_stride


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


__all__ = ["CenterHead", "decode_center"]
