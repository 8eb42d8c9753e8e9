"""The PointPillars network as PyTorch modules, for inference.

Counterpart of ``lidar_object_detection_tpu/models/pointpillars/model.py``
(lines 26-245): the pillar feature net (per-point linear, masked
BatchNorm, ReLU, pillar max-pool into a dense BEV image), the 2D backbone
(three strided blocks, each upsampled to stride 2 and concatenated) and
the SSD head (class, 7-dof box and direction per anchor); the center head
is in :mod:`.center`.

Layouts are JAX's at the public forward: points (B, P, 4) in, heads
channels-last out -- SSD ``(B, H, W, A, nc)``, ``(B, H, W, A, 7)``,
``(B, H, W, A, 2)`` -- so that the per-anchor reshapes of the channel axis
are the JAX package's.  Inside, the backbone runs NCHW.  Module names
follow the Flax tree (``pfn.linear``, ``backbone.block0_down.conv``,
``head.cls``, ...), so :func:`.weights.pillars_state_from_flax` maps each
variable path straight to a state-dict key.

Evaluation only: BatchNorm uses the running statistics, in Flax's order
(:class:`MaskedBatchNorm` its own, ``(x - mean) * rsqrt(var + eps)`` then
``* scale + bias``; the backbone's :class:`BatchNormEval`).  Training is
ROADMAP Queue 1 item 7.  The forward runs in full float32, TF32 off
(``full_float32``), as the JAX package computes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lidar_object_detection_tpu_torch.models.pointpillars.voxelize import (
    PillarGridConfig, point_features, scatter_bev)
from lidar_object_detection_tpu_torch.models.yolo.blocks import (
    BatchNormEval)
from lidar_object_detection_tpu_torch.models.yolo.detector import (
    full_float32)

BN_EPS = 1e-3   # the Flax modules' epsilon


@dataclasses.dataclass(frozen=True)
class PillarsConfig:
    """The JAX package's ``PillarsConfig`` without its training fields
    (BatchNorm momentum, the assignment IoU, the center loss's weights)."""

    grid: PillarGridConfig = PillarGridConfig()
    embed_dim: int = 64
    backbone_channels: Tuple[int, ...] = (64, 128, 256)
    backbone_layers: Tuple[int, ...] = (3, 5, 5)
    up_channels: int = 128
    num_classes: int = 1          # car
    num_anchors: int = 2          # 0 / 90 degree anchor rotations
    # anchor geometry (w, l, h) and z-center -- KITTI car anchor
    anchor_size: Tuple[float, float, float] = (1.6, 3.9, 1.56)
    anchor_z: float = -1.0
    # detection head family: "ssd" (anchor-based) or "center" (:mod:`.center`)
    head: str = "ssd"

    @property
    def out_stride(self) -> int:
        return 2   # head runs at stride-2 BEV resolution

    @staticmethod
    def kitti360_surround() -> "PillarsConfig":
        """Full-surround grid for KITTI-360 multi-sweep clouds: +-102.4 m
        square at 0.32 m pillars (640 x 640 BEV, 204,800 anchors at the
        stride-2 head), z from -5 to 1.5 m."""
        return PillarsConfig(
            grid=PillarGridConfig(x_range=(-102.4, 102.4),
                                  y_range=(-102.4, 102.4),
                                  z_range=(-5.0, 1.5),
                                  pillar_size=0.32))


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm + ReLU -- the Flax ``ConvBN``.

    ``transpose`` is Flax's ``ConvTranspose`` with ``SAME`` padding and
    ``transpose_kernel=False``, taken here only with kernel == stride: an
    input-dilated convolution, whose output pixel ``s*i + r`` is input
    pixel ``i`` times kernel tap ``k - 1 - r``.  ``ConvTranspose2d`` puts
    tap ``r`` there, so :mod:`.weights` flips the kernel in both spatial
    axes.
    """

    def __init__(self, c_in: int, c_out: int, k: int = 3, s: int = 1,
                 transpose: bool = False):
        super().__init__()
        if transpose:
            if k != s:
                raise ValueError(f"a transposed ConvBN takes kernel == "
                                 f"stride, got {k} and {s}")
            self.conv = nn.ConvTranspose2d(c_in, c_out, k, stride=s,
                                           bias=False)
        else:
            self.conv = nn.Conv2d(c_in, c_out, k, stride=s, padding=k // 2,
                                  bias=False)
        self.bn = BatchNormEval(c_out, eps=BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class MaskedBatchNorm(nn.Module):
    """The pillar feature net's BatchNorm over (N, C) point rows, in
    evaluation: ``(x - mean) * rsqrt(var + eps)``, then ``* scale +
    bias`` (the JAX module's order; its masked batch statistics serve
    training only)."""

    def __init__(self, c: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        y = (x - self.running_mean) * torch.rsqrt(self.running_var
                                                  + self.eps)
        return y * self.weight + self.bias


class PillarFeatureNet(nn.Module):
    """Per-point linear + masked BN + ReLU, then the pillar max-pool into
    the dense (B, ny, nx, C) BEV image."""

    def __init__(self, cfg: PillarsConfig):
        super().__init__()
        self.cfg = cfg
        self.linear = nn.Linear(9, cfg.embed_dim, bias=False)
        self.bn = MaskedBatchNorm(cfg.embed_dim)

    def forward(self, points, valid):
        grid = self.cfg.grid
        b, p = points.shape[0], points.shape[1]
        feats, ids, in_grid = point_features(
            points.reshape(b * p, points.shape[-1]), valid.reshape(b * p),
            grid, batch=b)
        x = F.relu(self.bn(self.linear(feats)))
        return scatter_bev(x, ids, in_grid, grid, batch=b)


class Backbone2D(nn.Module):
    """Top-down conv pyramid + upsampled concat (PointPillars section
    2.2), NCHW in and out."""

    def __init__(self, cfg: PillarsConfig):
        super().__init__()
        c_in = cfg.embed_dim
        for b, (ch, n_layers) in enumerate(zip(cfg.backbone_channels,
                                               cfg.backbone_layers)):
            self.add_module(f"block{b}_down", ConvBN(c_in, ch, 3, 2))
            for i in range(n_layers):
                self.add_module(f"block{b}_conv{i}", ConvBN(ch, ch, 3, 1))
            up = (1, 2, 4)[b]
            self.add_module(f"up{b}", ConvBN(ch, cfg.up_channels, up, up,
                                             transpose=up > 1))
            c_in = ch
        self.layers = cfg.backbone_layers

    def forward(self, x):
        ups = []
        for b, n_layers in enumerate(self.layers):
            x = getattr(self, f"block{b}_down")(x)
            for i in range(n_layers):
                x = getattr(self, f"block{b}_conv{i}")(x)
            ups.append(getattr(self, f"up{b}")(x))
        return torch.cat(ups, dim=1)


def _channels_last(x, *trailing):
    """(B, C, H, W) -> (B, H, W, *trailing)."""
    b, _, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h, w, *trailing)


class SSDHead(nn.Module):
    def __init__(self, cfg: PillarsConfig):
        super().__init__()
        c = cfg.up_channels * len(cfg.backbone_channels)
        a, nc = cfg.num_anchors, cfg.num_classes
        self.a, self.nc = a, nc
        self.cls = nn.Conv2d(c, a * nc, 1)
        self.box = nn.Conv2d(c, a * 7, 1)
        self.dir = nn.Conv2d(c, a * 2, 1)

    def forward(self, x):
        return {"cls": _channels_last(self.cls(x), self.a, self.nc),
                "box": _channels_last(self.box(x), self.a, 7),
                "dir": _channels_last(self.dir(x), self.a, 2)}


class PointPillars(nn.Module):
    """Full network: padded scans (B, P, 4) or (P, 4) and their masks ->
    the raw heads, channels-last.  Decoding is :mod:`.decode`."""

    def __init__(self, cfg: PillarsConfig = PillarsConfig()):
        super().__init__()
        self.cfg = cfg
        self.pfn = PillarFeatureNet(cfg)
        self.backbone = Backbone2D(cfg)
        if cfg.head == "center":
            from lidar_object_detection_tpu_torch.models.pointpillars.center \
                import CenterHead
            self.center_head = CenterHead(cfg)
        else:
            self.head = SSDHead(cfg)

    def forward(self, points, valid, train: bool = False):
        if train:
            raise NotImplementedError(
                "PointPillars training is not ported yet (ROADMAP Queue 1 "
                "item 7); the port runs inference only")
        if points.dim() == 2:
            points, valid = points[None], valid[None]
        with full_float32():
            bev = self.pfn(points, valid)
            x = self.backbone(bev.permute(0, 3, 1, 2).contiguous())
            if self.cfg.head == "center":
                return self.center_head(x)
            return self.head(x)
