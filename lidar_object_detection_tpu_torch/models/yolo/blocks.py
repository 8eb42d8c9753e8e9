"""YOLO11 building blocks as PyTorch modules (NCHW).

Counterpart of ``lidar_object_detection_tpu/models/yolo/blocks.py``.  The
blocks follow the published YOLO11 architecture: Conv + BN + SiLU,
C3k2 / C3k / Bottleneck CSP blocks, SPPF, C2PSA position-sensitive
attention, and the Proto head with its 2x transposed-conv upsample.

Submodule names follow the ultralytics state dict (``cv1``, ``m.0``,
``conv`` / ``bn``), so :func:`models.yolo.weights.from_flax_variables`
yields a state dict with ultralytics' keys.  BatchNorm evaluates with
running statistics in the Flax form, ``(x - mean) * (gamma *
rsqrt(var + eps)) + beta``, the multiplier rounded as the JAX package's
jitted forward rounds it, so folded and unfolded weights round as the JAX
package serves them.  A module in training mode (``Yolo11.train()``)
normalizes with the batch's statistics and moves the running ones, as
Flax's ``apply(..., train=True, mutable=["batch_stats"])`` does
(:class:`..common.BatchNorm`); ``nn.Module`` starts in training mode, so a
serving network is put in eval mode (``YoloDetector`` does).

A network given a compute dtype (``Yolo11(cfg, dtype=torch.bfloat16)``,
Flax's ``dtype``) keeps float32 parameters and rounds where the Flax
blocks with ``dtype=bfloat16`` round: each convolution casts its input
and kernel (:class:`..common.Conv2d`), BatchNorm normalizes in float32
and returns bfloat16, SiLU is ``x * sigmoid(x)`` in bfloat16
(:func:`..common.flax_silu`), residual adds, concatenations and pools
stay in bfloat16, the attention's scores are float32 sums of bfloat16
products, and the Proto's upsample adds its bias after the product.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lidar_object_detection_tpu_torch.models.common import (
    BatchNorm, Conv2d, ConvTranspose2d, flax_silu)


class ConvBNAct(nn.Module):
    """Conv2d (no bias) + BatchNorm + SiLU -- ultralytics ``Conv``.  The
    BatchNorm takes the batch's statistics in training mode (ultralytics'
    and the JAX package's momentum, 0.97 in Flax's convention)."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1,
                 g: int = 1, act: bool = True):
        super().__init__()
        self.conv = Conv2d(c_in, c_out, k, s, k // 2, groups=g, bias=False)
        self.bn = BatchNorm(c_out)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x), self.training)
        if not self.act:
            return x
        return F.silu(x) if self.conv.compute_dtype is None else flax_silu(x)


def dw_conv(c_in: int, c_out: int, k: int = 3, s: int = 1,
            act: bool = True) -> ConvBNAct:
    """Depthwise ``Conv``: groups = gcd(c_in, c_out)."""
    return ConvBNAct(c_in, c_out, k, s, g=math.gcd(c_in, c_out), act=act)


class Bottleneck(nn.Module):
    """cv1 (k1) -> cv2 (k2), with a residual when the widths agree."""

    def __init__(self, c_in: int, c_out: int, shortcut: bool = True,
                 k: Sequence[int] = (3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c_out * e)
        self.cv1 = ConvBNAct(c_in, c_, k[0])
        self.cv2 = ConvBNAct(c_, c_out, k[1])
        self.add = shortcut and c_in == c_out

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3k(nn.Module):
    """CSP block with 3 convs and ``n`` inner bottlenecks (kernel ``k``)."""

    def __init__(self, c_in: int, c_out: int, n: int = 2,
                 shortcut: bool = True, e: float = 0.5, k: int = 3):
        super().__init__()
        c_ = int(c_out * e)
        self.cv1 = ConvBNAct(c_in, c_, 1)
        self.cv2 = ConvBNAct(c_in, c_, 1)
        self.cv3 = ConvBNAct(2 * c_, c_out, 1)
        self.m = nn.ModuleList(
            Bottleneck(c_, c_, shortcut, (k, k), 1.0) for _ in range(n))

    def forward(self, x):
        a = self.cv1(x)
        for block in self.m:
            a = block(a)
        return self.cv3(torch.cat([a, self.cv2(x)], dim=1))


class C3k2(nn.Module):
    """YOLO11's C2f-style split block; inner blocks are C3k or plain
    Bottlenecks."""

    def __init__(self, c_in: int, c_out: int, n: int = 1, c3k: bool = False,
                 e: float = 0.5, shortcut: bool = True):
        super().__init__()
        self.c = int(c_out * e)
        self.cv1 = ConvBNAct(c_in, 2 * self.c, 1)
        self.cv2 = ConvBNAct((2 + n) * self.c, c_out, 1)
        self.m = nn.ModuleList(
            C3k(self.c, self.c, 2, shortcut) if c3k
            else Bottleneck(self.c, self.c, shortcut, (3, 3), 0.5)
            for _ in range(n))

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[:, :self.c], y[:, self.c:]]
        for block in self.m:
            parts.append(block(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained 5x5 max-pools."""

    def __init__(self, c_in: int, c_out: int, k: int = 5):
        super().__init__()
        c_ = c_in // 2
        self.cv1 = ConvBNAct(c_in, c_, 1)
        self.cv2 = ConvBNAct(4 * c_, c_out, 1)
        self.k = k

    def forward(self, x):
        outs = [self.cv1(x)]
        for _ in range(3):
            outs.append(F.max_pool2d(outs[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(outs, dim=1))


class Attention(nn.Module):
    """PSA attention: qkv 1x1 conv, per-head softmax attention over the
    flattened spatial axis, depthwise positional conv on v."""

    def __init__(self, dim: int, num_heads: int = 8,
                 attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim ** -0.5
        h = num_heads * (2 * self.key_dim + self.head_dim)
        self.qkv = ConvBNAct(dim, h, 1, act=False)
        self.proj = ConvBNAct(dim, dim, 1, act=False)
        self.pe = ConvBNAct(dim, dim, 3, g=dim, act=False)
        self.dim = dim

    def forward(self, x):
        b, _, h, w = x.shape
        n = h * w
        kd = self.key_dim
        # channels per head are contiguous, as in the NHWC reshape of the
        # JAX block: (b, C, h, w) -> (b, n, heads, 2kd + hd)
        qkv = self.qkv(x).permute(0, 2, 3, 1).reshape(
            b, n, self.num_heads, 2 * kd + self.head_dim)
        q, k, v = qkv[..., :kd], qkv[..., kd:2 * kd], qkv[..., 2 * kd:]
        attn = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
            * self.scale
        attn = attn.softmax(dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        out = out.reshape(b, h, w, self.dim).permute(0, 3, 1, 2)
        pe = self.pe(v.reshape(b, h, w, self.dim).permute(0, 3, 1, 2))
        return self.proj(out + pe)


class PSABlock(nn.Module):
    """Attention + 2-layer conv FFN, both residual."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.attn = Attention(dim, num_heads)
        self.ffn = nn.Sequential(ConvBNAct(dim, dim * 2, 1),
                                 ConvBNAct(dim * 2, dim, 1, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn(x)


class C2PSA(nn.Module):
    """C2-style wrapper around ``n`` PSA blocks (YOLO11 layer 10)."""

    def __init__(self, c_in: int, c_out: int, n: int = 1, e: float = 0.5):
        super().__init__()
        self.c = int(c_out * e)
        self.cv1 = ConvBNAct(c_in, 2 * self.c, 1)
        self.cv2 = ConvBNAct(2 * self.c, c_out, 1)
        self.m = nn.Sequential(*(PSABlock(self.c, max(self.c // 64, 1))
                                 for _ in range(n)))

    def forward(self, x):
        y = self.cv1(x)
        a, b = y[:, :self.c], y[:, self.c:]
        return self.cv2(torch.cat([a, self.m(b)], dim=1))


class Proto(nn.Module):
    """Segmentation prototype head: conv -> 2x transposed-conv upsample ->
    conv -> 1x1 to ``nm`` mask channels.  The upsample is
    ``ConvTranspose2d(c, c, 2, 2)``; its (in, out, 2, 2) weight is the
    layout the JAX package keeps.  With a compute dtype it is the JAX
    block's einsum, rounded, and then the bias added
    (:class:`..common.ConvTranspose2d`)."""

    def __init__(self, c_in: int, c_hidden: int = 256, nm: int = 32):
        super().__init__()
        self.cv1 = ConvBNAct(c_in, c_hidden, 3)
        self.upsample = ConvTranspose2d(c_hidden, c_hidden, 2, 2, 0,
                                        bias=True)
        self.cv2 = ConvBNAct(c_hidden, c_hidden, 3)
        self.cv3 = ConvBNAct(c_hidden, nm, 1)

    def forward(self, x):
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


def upsample2x(x):
    """Nearest-neighbour 2x upsample (the head's ``nn.Upsample``), as a
    broadcast: its gradient is a sum over the copies, where an indexed
    repeat's would add them with atomics on the card, in no fixed
    order."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2).reshape(
        b, c, 2 * h, 2 * w)


def make_divisible(v: float, divisor: int = 8) -> int:
    """ultralytics ``make_divisible``: round up to a multiple."""
    return int(math.ceil(v / divisor) * divisor)
