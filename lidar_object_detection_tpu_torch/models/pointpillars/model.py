"""The PointPillars network as PyTorch modules, for inference and training.

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

BatchNorm is Flax's, in Flax's order: ``(x - mean) * (rsqrt(var + eps) *
scale) + bias`` (:class:`MaskedBatchNorm`: ``(x - mean) * rsqrt(var +
eps)``, then ``* scale + bias``).  ``forward(..., train=False)`` uses the
running statistics.  ``train=True`` uses the batch's and updates the
running ones, as Flax's ``nn.BatchNorm`` does (:class:`BatchNorm`), not as
``torch.nn.BatchNorm2d`` does: the biased variance ``E[x^2] - E[x]^2``
clipped at 0, and ``running = m * running + (1 - m) * batch`` with m =
``bn_momentum``.  The forward runs in full float32, TF32 off
(``full_float32``), as the JAX package computes.

``PointPillars(cfg, dtype=torch.bfloat16)`` is the JAX package's
``PointPillars(cfg, dtype=jnp.bfloat16)``: float32 parameters and
statistics, the layers computing in bfloat16 (:mod:`..common`'s
``Conv2d``, ``ConvTranspose2d``, ``Linear``: input, kernel and bias cast
at the call, a bias added after the product), both BatchNorms
normalizing in float32 and returning bfloat16, the pillar scatter in
float32 and the BEV cast back to bfloat16, the heads bfloat16; the
forward then runs in ``mixed_precision``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lidar_object_detection_tpu_torch.models.common import (
    BatchNorm, Conv2d, ConvTranspose2d, Linear, _update_running, batch_sum,
    global_sum, numerics, set_compute_dtype)
from lidar_object_detection_tpu_torch.models.pointpillars.voxelize import (
    PillarGridConfig, point_features, scatter_bev)

BN_EPS = 1e-3   # the Flax modules' epsilon


@dataclasses.dataclass(frozen=True)
class PillarsConfig:
    """The JAX package's ``PillarsConfig``, field for field."""

    grid: PillarGridConfig = PillarGridConfig()
    embed_dim: int = 64
    backbone_channels: Tuple[int, ...] = (64, 128, 256)
    backbone_layers: Tuple[int, ...] = (3, 5, 5)
    up_channels: int = 128
    num_classes: int = 1          # car
    num_anchors: int = 2          # 0 / 90 degree anchor rotations
    # BatchNorm running-average momentum (Flax's convention: the share of
    # the old running value kept per training step)
    bn_momentum: float = 0.9
    # anchor geometry (w, l, h) and z-center -- KITTI car anchor
    anchor_size: Tuple[float, float, float] = (1.6, 3.9, 1.56)
    anchor_z: float = -1.0
    # anchor-assignment IoU: the exact "rotated" BEV IoU or the "aabb"
    # approximation (:mod:`.loss`)
    assign_iou: str = "rotated"
    # detection head family: "ssd" (anchor-based) or "center" (:mod:`.center`)
    head: str = "ssd"
    # center head: GTs with few in-box points get their positive terms
    # weighted by up to 1 + starve_weight (0 disables), weight = 1 +
    # starve_weight * exp(-count / starve_n0) (:func:`.center.starve_weights`)
    starve_weight: float = 0.0
    starve_n0: float = 20.0

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
                 transpose: bool = False, momentum: float = 0.9):
        super().__init__()
        if transpose:
            if k != s:
                raise ValueError(f"a transposed ConvBN takes kernel == "
                                 f"stride, got {k} and {s}")
            self.conv = ConvTranspose2d(c_in, c_out, k, stride=s,
                                        bias=False)
        else:
            self.conv = Conv2d(c_in, c_out, k, stride=s, padding=k // 2,
                               bias=False)
        self.bn = BatchNorm(c_out, eps=BN_EPS, momentum=momentum)

    def forward(self, x, train: bool = False):
        return F.relu(self.bn(self.conv(x), train))


class MaskedBatchNorm(nn.Module):
    """The pillar feature net's BatchNorm over (N, C) point rows:
    ``(x - mean) * rsqrt(var + eps)``, then ``* scale + bias`` (the JAX
    module's order).  In training the mean and the biased variance are
    weighted by ``mask`` (two passes over the rows, n = max(sum(mask),
    1)), summed over the ranks of ``batch_group`` when the batch is split
    over them (:func:`..common.batch_sum`), and the running
    statistics update as :class:`BatchNorm`'s.  The statistics and the
    normalization are float32 and the output has the input's dtype
    (Flax's ``astype(self.dtype)``)."""

    def __init__(self, c: int, eps: float = BN_EPS, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.batch_group = None     # as BatchNorm's

    def forward(self, x, mask=None, train: bool = False):
        dtype = x.dtype
        if train:
            w = mask.to(torch.float32)[:, None]
            group = self.batch_group
            n = torch.clamp(global_sum(w.sum(), group), min=1.0)
            x = x.float()
            mean = batch_sum((x * w).sum(dim=0), group) / n
            var = batch_sum(
                (((x - mean) ** 2) * w).sum(dim=0), group) / n
            _update_running(self, mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x.float() - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(dtype)


class PillarFeatureNet(nn.Module):
    """Per-point linear + masked BN + ReLU, then the pillar max-pool into
    the dense (B, ny, nx, C) BEV image."""

    def __init__(self, cfg: PillarsConfig):
        super().__init__()
        self.cfg = cfg
        self.linear = Linear(9, cfg.embed_dim, bias=False)
        self.bn = MaskedBatchNorm(cfg.embed_dim, momentum=cfg.bn_momentum)

    def forward(self, points, valid, train: bool = False):
        grid = self.cfg.grid
        b, p = points.shape[0], points.shape[1]
        feats, ids, in_grid = point_features(
            points.reshape(b * p, points.shape[-1]), valid.reshape(b * p),
            grid, batch=b)
        x = F.relu(self.bn(self.linear(feats), in_grid, train))
        return scatter_bev(x.float(), ids, in_grid, grid, batch=b)


class Backbone2D(nn.Module):
    """Top-down conv pyramid + upsampled concat (PointPillars section
    2.2), NCHW in and out."""

    def __init__(self, cfg: PillarsConfig):
        super().__init__()
        c_in = cfg.embed_dim
        m = cfg.bn_momentum
        for b, (ch, n_layers) in enumerate(zip(cfg.backbone_channels,
                                               cfg.backbone_layers)):
            self.add_module(f"block{b}_down", ConvBN(c_in, ch, 3, 2,
                                                     momentum=m))
            for i in range(n_layers):
                self.add_module(f"block{b}_conv{i}",
                                ConvBN(ch, ch, 3, 1, momentum=m))
            up = (1, 2, 4)[b]
            self.add_module(f"up{b}", ConvBN(ch, cfg.up_channels, up, up,
                                             transpose=up > 1, momentum=m))
            c_in = ch
        self.layers = cfg.backbone_layers

    def forward(self, x, train: bool = False):
        ups = []
        for b, n_layers in enumerate(self.layers):
            x = getattr(self, f"block{b}_down")(x, train)
            for i in range(n_layers):
                x = getattr(self, f"block{b}_conv{i}")(x, train)
            ups.append(getattr(self, f"up{b}")(x, train))
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
        self.cls = Conv2d(c, a * nc, 1)
        self.box = Conv2d(c, a * 7, 1)
        self.dir = Conv2d(c, a * 2, 1)

    def forward(self, x):
        return {"cls": _channels_last(self.cls(x), self.a, self.nc),
                "box": _channels_last(self.box(x), self.a, 7),
                "dir": _channels_last(self.dir(x), self.a, 2)}


class PointPillars(nn.Module):
    """Full network: padded scans (B, P, 4) or (P, 4) and their masks ->
    the raw heads, channels-last, computing in ``dtype`` (Flax's).
    Decoding is :mod:`.decode`."""

    # the BEV's cast and the forward's scope (set_compute_dtype)
    compute_dtype = None

    def __init__(self, cfg: PillarsConfig = PillarsConfig(),
                 dtype: torch.dtype = torch.float32):
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
        set_compute_dtype(self, dtype)

    def forward(self, points, valid, train: bool = False):
        """``train=True`` normalizes with the batch's statistics and
        updates the running ones (Flax's ``mutable=["batch_stats"]``)."""
        if points.dim() == 2:
            points, valid = points[None], valid[None]
        with numerics(self.compute_dtype):
            bev = self.pfn(points, valid, train)
            if self.compute_dtype is not None:
                bev = bev.to(self.compute_dtype)
            x = self.backbone(bev.permute(0, 3, 1, 2).contiguous(), train)
            if self.cfg.head == "center":
                return self.center_head(x, train)
            return self.head(x)
