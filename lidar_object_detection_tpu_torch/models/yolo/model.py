"""YOLO11 detection / instance-segmentation network as a PyTorch module.

Counterpart of ``lidar_object_detection_tpu/models/yolo/model.py``: the
published YOLO11 graph (backbone 0-10, FPN/PAN head 11-22, Segment or
Detect head at 23) with the per-scale depth/width table.  Layers live in
``self.model`` under their ultralytics indices, so the state dict's keys
are ultralytics' (``model.0.conv.weight``,
``model.23.proto.cv1.bn.running_mean``).

The network runs NCHW inside; its public input and outputs are NHWC, as in
the JAX package: ``forward`` takes (B, H, W, 3) in [0, 1] and returns
``{"box", "cls", "coef"}`` lists of (B, h, w, C) per level and
``"proto"`` (B, H/4, W/4, nm); with ``YoloConfig(segment=False)`` (the
detection-only head of the KITTI 2D evaluation) only ``"box"`` and
``"cls"``.

``Yolo11(cfg, dtype=torch.bfloat16)`` is the JAX package's ``Yolo11(cfg,
dtype=jnp.bfloat16)``: float32 parameters, the network computing in
bfloat16 (:mod:`.blocks`), the head's biased 1 x 1 convolutions taking
the product in bfloat16 and then adding the bias in bfloat16, the
outputs bfloat16.  float32 (the default) is the float32 network
unchanged.  A serving network cast whole (``model.to(torch.bfloat16)``,
``YoloDetector``) is another thing: its parameters are bfloat16.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
from torch import nn

from lidar_object_detection_tpu_torch.models.common import (
    Conv2d, set_compute_dtype)
from lidar_object_detection_tpu_torch.models.yolo import blocks as B

SCALES = {
    # name: (depth, width, max_channels) -- YOLO11 scale table
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}

STRIDES = (8, 16, 32)
REG_MAX = 16
HEAD_INDEX = 23


@dataclasses.dataclass(frozen=True)
class YoloConfig:
    scale: str = "x"
    num_classes: int = 80
    nm: int = 32       # mask coefficients
    npr: int = 256     # prototype channels before width scaling
    segment: bool = True

    @property
    def depth(self) -> float:
        return SCALES[self.scale][0]

    @property
    def width(self) -> float:
        return SCALES[self.scale][1]

    @property
    def max_channels(self) -> int:
        return SCALES[self.scale][2]

    def ch(self, c: int) -> int:
        return B.make_divisible(min(c, self.max_channels) * self.width, 8)

    def reps(self, n: int) -> int:
        return max(round(n * self.depth), 1)

    @property
    def c3k(self) -> bool:
        """m/l/x scales use C3k inner blocks everywhere."""
        return self.scale in ("m", "l", "x")


class DetectHead(nn.Module):
    """Detect: per level, cv2 -> 4 * REG_MAX box bins and cv3 (YOLO11's
    depthwise variant) -> class logits, at ultralytics' key names."""

    def __init__(self, cfg: YoloConfig, level_channels):
        super().__init__()
        nc = cfg.num_classes
        c2 = max(16, level_channels[0] // 4, REG_MAX * 4)
        c3 = max(level_channels[0], min(nc, 100))
        self.cv2 = nn.ModuleList(nn.Sequential(
            B.ConvBNAct(c, c2, 3), B.ConvBNAct(c2, c2, 3),
            Conv2d(c2, 4 * REG_MAX, 1)) for c in level_channels)
        self.cv3 = nn.ModuleList(nn.Sequential(
            nn.Sequential(B.dw_conv(c, c, 3), B.ConvBNAct(c, c3, 1)),
            nn.Sequential(B.dw_conv(c3, c3, 3), B.ConvBNAct(c3, c3, 1)),
            Conv2d(c3, nc, 1)) for c in level_channels)

    def forward(self, feats):
        boxes = [m(x) for m, x in zip(self.cv2, feats)]
        classes = [m(x) for m, x in zip(self.cv3, feats)]
        return boxes, classes


class SegmentHead(DetectHead):
    """Detect + mask coefficients (cv4) + Proto; ultralytics' Segment is a
    Detect, so the detection half keeps the same key names."""

    def __init__(self, cfg: YoloConfig, level_channels):
        super().__init__(cfg, level_channels)
        c4 = max(level_channels[0] // 4, cfg.nm)
        self.cv4 = nn.ModuleList(nn.Sequential(
            B.ConvBNAct(c, c4, 3), B.ConvBNAct(c4, c4, 3),
            Conv2d(c4, cfg.nm, 1)) for c in level_channels)
        self.proto = B.Proto(level_channels[0], cfg.ch(cfg.npr), cfg.nm)

    def forward(self, feats):
        boxes, classes = super().forward(feats)
        coeffs = [m(x) for m, x in zip(self.cv4, feats)]
        return boxes, classes, coeffs, self.proto(feats[0])


class Yolo11(nn.Module):
    """Full YOLO11(-seg) network, computing in ``dtype`` (Flax's)."""

    def __init__(self, cfg: YoloConfig = YoloConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        ch, n2, c3k = cfg.ch, cfg.reps(2), cfg.c3k
        layers = {
            0: B.ConvBNAct(3, ch(64), 3, 2),
            1: B.ConvBNAct(ch(64), ch(128), 3, 2),
            2: B.C3k2(ch(128), ch(256), n2, c3k, 0.25),
            3: B.ConvBNAct(ch(256), ch(256), 3, 2),
            4: B.C3k2(ch(256), ch(512), n2, c3k, 0.25),
            5: B.ConvBNAct(ch(512), ch(512), 3, 2),
            6: B.C3k2(ch(512), ch(512), n2, True, 0.5),
            7: B.ConvBNAct(ch(512), ch(1024), 3, 2),
            8: B.C3k2(ch(1024), ch(1024), n2, True, 0.5),
            9: B.SPPF(ch(1024), ch(1024), 5),
            10: B.C2PSA(ch(1024), ch(1024), n2),
            13: B.C3k2(ch(1024) + ch(512), ch(512), n2, c3k, 0.5),
            16: B.C3k2(ch(512) + ch(512), ch(256), n2, c3k, 0.5),
            17: B.ConvBNAct(ch(256), ch(256), 3, 2),
            19: B.C3k2(ch(256) + ch(512), ch(512), n2, c3k, 0.5),
            20: B.ConvBNAct(ch(512), ch(512), 3, 2),
            22: B.C3k2(ch(512) + ch(1024), ch(1024), n2, True, 0.5),
            HEAD_INDEX: (SegmentHead if cfg.segment else DetectHead)(
                cfg, (ch(256), ch(512), ch(1024))),
        }
        self.model = nn.ModuleDict({str(i): m for i, m in layers.items()})
        set_compute_dtype(self, dtype)

    def forward(self, x) -> Dict[str, List[torch.Tensor]]:
        m = self.model
        x = x.permute(0, 3, 1, 2)
        for i in range(4):
            x = m[str(i)](x)
        x = m["4"](x)
        s4 = x
        x = m["6"](m["5"](x))
        s6 = x
        x = m["10"](m["9"](m["8"](m["7"](x))))
        s10 = x
        x = m["13"](torch.cat([B.upsample2x(x), s6], dim=1))
        s13 = x
        p3 = m["16"](torch.cat([B.upsample2x(x), s4], dim=1))
        p4 = m["19"](torch.cat([m["17"](p3), s13], dim=1))
        p5 = m["22"](torch.cat([m["20"](p4), s10], dim=1))
        heads = m[str(HEAD_INDEX)]((p3, p4, p5))
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        out = {"box": [nhwc(t) for t in heads[0]],
               "cls": [nhwc(t) for t in heads[1]]}
        if self.cfg.segment:
            out["coef"] = [nhwc(t) for t in heads[2]]
            out["proto"] = nhwc(heads[3])
        return out
