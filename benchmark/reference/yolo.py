# Adapted from lidar_object_detection_tpu_torch/models/yolo/blocks.py:42-242, model.py:37-180 and weights.py:45-127 at 072d88e (float32 only; the Flax-key mapping frozen).
"""YOLO11-seg in plain PyTorch, for the benchmark's reference.

The published YOLO11 graph (backbone 0-10, FPN/PAN head 11-22, Segment
head at 23) at Ultralytics' scale table, with submodules at the
ultralytics state-dict names, so a flax checkpoint of the repository
(``params/layer2/m0/cv1/conv/kernel``) loads key by key.  It computes in
float32: BatchNorm in its textbook form ``(x - mean) * (gamma *
rsqrt(var + eps)) + beta`` with the running statistics, SiLU as
``F.silu``, nearest 2x upsampling, no kernel of the program.

``precision`` rounds the operands of every convolution and product to a
lower format first, for the control of the benchmark's comparison:
``"tf32"`` (10 mantissa bits, as the tensor cores read float32 in TF32)
or ``"fp8"`` (e4m3 with one scale per tensor, its largest magnitude at
448).  ``"fp32"`` rounds nothing.

:func:`conv_flops` counts 2 x the multiply-adds of every convolution and
linear layer of a forward, the way Ultralytics' published GFLOPs count
them.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

SCALES = {
    # name: (depth, width, max_channels) -- Ultralytics' yolo11-seg.yaml
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}
STRIDES = (8, 16, 32)
REG_MAX = 16
HEAD_INDEX = 23
PRECISIONS = ("fp32", "tf32", "fp8")


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` (float32) rounded to ``precision`` and back to float32."""
    if precision == "fp32":
        return x
    if precision == "tf32":
        # round to nearest even at the 13 low mantissa bits
        bits = x.contiguous().view(torch.int32)
        lsb = (bits >> 13) & 1
        rounded = (bits + 0xFFF + lsb) & ~0x1FFF
        finite = torch.isfinite(x)
        return torch.where(finite, rounded.view(torch.float32), x)
    if precision == "fp8":
        scale = x.detach().abs().amax().clamp(min=1e-12) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    raise ValueError(f"precision must be one of {PRECISIONS}, got "
                     f"{precision!r}")


class RefConv(nn.Conv2d):
    precision = "fp32"

    def forward(self, x):
        p = self.precision
        return F.conv2d(round_to(x, p), round_to(self.weight, p), self.bias,
                        self.stride, self.padding, self.dilation, self.groups)


class RefConvTranspose(nn.ConvTranspose2d):
    precision = "fp32"

    def forward(self, x):
        p = self.precision
        return F.conv_transpose2d(round_to(x, p), round_to(self.weight, p),
                                  self.bias, self.stride, self.padding)


class BatchNorm(nn.Module):
    """Evaluation-mode BatchNorm over NCHW, eps 1e-3 (ultralytics')."""

    def __init__(self, c: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        mult = self.weight * torch.rsqrt(self.running_var + self.eps)
        shape = (1, -1, 1, 1)
        return (x - self.running_mean.view(shape)) * mult.view(shape) \
            + self.bias.view(shape)


class ConvBNAct(nn.Module):
    def __init__(self, c_in, c_out, k=1, s=1, g=1, act=True):
        super().__init__()
        self.conv = RefConv(c_in, c_out, k, s, k // 2, groups=g, bias=False)
        self.bn = BatchNorm(c_out)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


def dw_conv(c_in, c_out, k=3, s=1, act=True):
    return ConvBNAct(c_in, c_out, k, s, g=math.gcd(c_in, c_out), act=act)


class Bottleneck(nn.Module):
    def __init__(self, c_in, c_out, shortcut=True, k=(3, 3), e=0.5):
        super().__init__()
        c_ = int(c_out * e)
        self.cv1 = ConvBNAct(c_in, c_, k[0])
        self.cv2 = ConvBNAct(c_, c_out, k[1])
        self.add = shortcut and c_in == c_out

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3k(nn.Module):
    def __init__(self, c_in, c_out, n=2, shortcut=True, e=0.5, k=3):
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
    def __init__(self, c_in, c_out, n=1, c3k=False, e=0.5, shortcut=True):
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
    def __init__(self, c_in, c_out, k=5):
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
    """PSA attention: qkv 1x1 conv, softmax attention per head over the
    flattened positions, a depthwise positional conv on v."""

    precision = "fp32"

    def __init__(self, dim, num_heads=8, attn_ratio=0.5):
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
        n, kd, p = h * w, self.key_dim, self.precision
        qkv = self.qkv(x).permute(0, 2, 3, 1).reshape(
            b, n, self.num_heads, 2 * kd + self.head_dim)
        q, k, v = qkv[..., :kd], qkv[..., kd:2 * kd], qkv[..., 2 * kd:]
        attn = torch.einsum("bqhd,bkhd->bhqk", round_to(q, p),
                            round_to(k, p)) * self.scale
        attn = attn.softmax(dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", round_to(attn, p),
                           round_to(v, p))
        out = out.reshape(b, h, w, self.dim).permute(0, 3, 1, 2)
        pe = self.pe(v.reshape(b, h, w, self.dim).permute(0, 3, 1, 2))
        return self.proj(out + pe)


class PSABlock(nn.Module):
    def __init__(self, dim, num_heads):
        super().__init__()
        self.attn = Attention(dim, num_heads)
        self.ffn = nn.Sequential(ConvBNAct(dim, dim * 2, 1),
                                 ConvBNAct(dim * 2, dim, 1, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn(x)


class C2PSA(nn.Module):
    def __init__(self, c_in, c_out, n=1, e=0.5):
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
    def __init__(self, c_in, c_hidden=256, nm=32):
        super().__init__()
        self.cv1 = ConvBNAct(c_in, c_hidden, 3)
        self.upsample = RefConvTranspose(c_hidden, c_hidden, 2, 2, 0,
                                         bias=True)
        self.cv2 = ConvBNAct(c_hidden, c_hidden, 3)
        self.cv3 = ConvBNAct(c_hidden, nm, 1)

    def forward(self, x):
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


def upsample2x(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def make_divisible(v: float, divisor: int = 8) -> int:
    return int(math.ceil(v / divisor) * divisor)


class SegmentHead(nn.Module):
    """Detect (cv2 box bins, cv3 class logits with YOLO11's depthwise
    stages) + mask coefficients (cv4) + Proto."""

    def __init__(self, ch, level_channels, nc=80, nm=32, npr=256):
        super().__init__()
        c2 = max(16, level_channels[0] // 4, REG_MAX * 4)
        c3 = max(level_channels[0], min(nc, 100))
        c4 = max(level_channels[0] // 4, nm)
        self.cv2 = nn.ModuleList(nn.Sequential(
            ConvBNAct(c, c2, 3), ConvBNAct(c2, c2, 3),
            RefConv(c2, 4 * REG_MAX, 1)) for c in level_channels)
        self.cv3 = nn.ModuleList(nn.Sequential(
            nn.Sequential(dw_conv(c, c, 3), ConvBNAct(c, c3, 1)),
            nn.Sequential(dw_conv(c3, c3, 3), ConvBNAct(c3, c3, 1)),
            RefConv(c3, nc, 1)) for c in level_channels)
        self.cv4 = nn.ModuleList(nn.Sequential(
            ConvBNAct(c, c4, 3), ConvBNAct(c4, c4, 3),
            RefConv(c4, nm, 1)) for c in level_channels)
        self.proto = Proto(level_channels[0], ch(npr), nm)

    def forward(self, feats):
        return ([m(x) for m, x in zip(self.cv2, feats)],
                [m(x) for m, x in zip(self.cv3, feats)],
                [m(x) for m, x in zip(self.cv4, feats)],
                self.proto(feats[0]))


class Yolo11Seg(nn.Module):
    """The network: (B, H, W, 3) in [0, 1] -> ``{"box", "cls", "coef"}``
    lists of (B, h, w, C) per level and ``"proto"`` (B, H/4, W/4, nm)."""

    def __init__(self, scale: str, num_classes: int = 80):
        super().__init__()
        depth, width, max_ch = SCALES[scale]
        ch = lambda c: make_divisible(min(c, max_ch) * width, 8)
        n2 = max(round(2 * depth), 1)
        c3k = scale in ("m", "l", "x")
        layers = {
            0: ConvBNAct(3, ch(64), 3, 2),
            1: ConvBNAct(ch(64), ch(128), 3, 2),
            2: C3k2(ch(128), ch(256), n2, c3k, 0.25),
            3: ConvBNAct(ch(256), ch(256), 3, 2),
            4: C3k2(ch(256), ch(512), n2, c3k, 0.25),
            5: ConvBNAct(ch(512), ch(512), 3, 2),
            6: C3k2(ch(512), ch(512), n2, True, 0.5),
            7: ConvBNAct(ch(512), ch(1024), 3, 2),
            8: C3k2(ch(1024), ch(1024), n2, True, 0.5),
            9: SPPF(ch(1024), ch(1024), 5),
            10: C2PSA(ch(1024), ch(1024), n2),
            13: C3k2(ch(1024) + ch(512), ch(512), n2, c3k, 0.5),
            16: C3k2(ch(512) + ch(512), ch(256), n2, c3k, 0.5),
            17: ConvBNAct(ch(256), ch(256), 3, 2),
            19: C3k2(ch(256) + ch(512), ch(512), n2, c3k, 0.5),
            20: ConvBNAct(ch(512), ch(512), 3, 2),
            22: C3k2(ch(512) + ch(1024), ch(1024), n2, True, 0.5),
            HEAD_INDEX: SegmentHead(ch, (ch(256), ch(512), ch(1024)),
                                    num_classes),
        }
        self.model = nn.ModuleDict({str(i): m for i, m in layers.items()})

    def set_precision(self, precision: str) -> "Yolo11Seg":
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        for m in self.modules():
            if isinstance(m, (RefConv, RefConvTranspose, Attention)):
                m.precision = precision
        return self

    def forward(self, x) -> Dict[str, List[torch.Tensor]]:
        m = self.model
        x = x.permute(0, 3, 1, 2)
        for i in range(5):
            x = m[str(i)](x)
        s4 = x
        x = m["6"](m["5"](x))
        s6 = x
        x = m["10"](m["9"](m["8"](m["7"](x))))
        s10 = x
        x = m["13"](torch.cat([upsample2x(x), s6], dim=1))
        s13 = x
        p3 = m["16"](torch.cat([upsample2x(x), s4], dim=1))
        p4 = m["19"](torch.cat([m["17"](p3), s13], dim=1))
        p5 = m["22"](torch.cat([m["20"](p4), s10], dim=1))
        box, cls, coef, proto = m[str(HEAD_INDEX)]((p3, p4, p5))
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        return {"box": [nhwc(t) for t in box], "cls": [nhwc(t) for t in cls],
                "coef": [nhwc(t) for t in coef], "proto": nhwc(proto)}


# --- the flax variable tree -> the state dict ------------------------------

def _flax_path_to_torch_key(path: Tuple[str, ...]) -> Tuple[str, str]:
    *mods, leaf = path
    tokens = []
    for seg in mods:
        if seg == "head":
            tokens.append(f"model.{HEAD_INDEX}")
        elif seg in ("detect", "dw"):
            continue   # flattened in torch (Segment is a Detect; DWConv a Conv)
        elif seg.startswith("layer"):
            tokens.append(f"model.{seg[5:]}")
        elif re.fullmatch(r"(cv\d|m)_?\d.*", seg) and "_" in seg:
            head, *idx = seg.split("_")
            tokens.append(".".join([head, *idx]))
        elif re.fullmatch(r"m\d+", seg):
            tokens.append(f"m.{seg[1:]}")
        elif seg in ("ffn0", "ffn1"):
            tokens.append(f"ffn.{seg[3]}")
        else:
            tokens.append(seg)
    return ".".join(tokens), leaf


def _as_float32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).clone()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """A flax ``{"params", "batch_stats"}`` tree -> the state dict of
    :class:`Yolo11Seg`, every leaf float32."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, path + (key,))
                continue
            collection, *mods = path + (key,)
            stem, leaf = _flax_path_to_torch_key(tuple(mods))
            t = _as_float32(value)
            if collection == "batch_stats":
                name = f"{stem}.running_{'mean' if leaf == 'mean' else 'var'}"
            else:
                name = f"{stem}.{'bias' if leaf == 'bias' else 'weight'}"
                if leaf == "kernel" and not stem.endswith("upsample"):
                    t = t.permute(3, 2, 0, 1).contiguous()    # HWIO -> OIHW
            if name in sd:
                raise ValueError(f"two flax variables map to {name}")
            sd[name] = t

    walk(variables, ())
    return sd


def load_reference(variables, scale: str, device="cpu",
                   precision: str = "fp32") -> Yolo11Seg:
    """The reference network of ``scale`` with the checkpoint's weights,
    in evaluation, on ``device``."""
    model = Yolo11Seg(scale)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.set_precision(precision).to(device).eval()


def parameter_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def conv_flops(model: nn.Module, input_hw, batch: int = 1) -> int:
    """2 x the multiply-adds of every convolution and linear layer in one
    forward of ``batch`` inputs of ``input_hw``, counted from the layers'
    output shapes (the attention's products are not layers and are left
    out, as Ultralytics' count leaves them)."""
    total = [0]

    def hook(module, inputs, output):
        if isinstance(module, nn.ConvTranspose2d):
            x = inputs[0]
            k = module.kernel_size[0] * module.kernel_size[1]
            total[0] += 2 * x.numel() * module.out_channels * k \
                // module.groups
        elif isinstance(module, nn.Conv2d):
            k = module.kernel_size[0] * module.kernel_size[1]
            total[0] += 2 * output.numel() * k * module.in_channels \
                // module.groups
        elif isinstance(module, nn.Linear):
            total[0] += 2 * output.numel() * module.in_features

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))]
    try:
        p = next(model.parameters())
        with torch.no_grad():
            model(torch.zeros((batch, *input_hw, 3), dtype=p.dtype,
                              device=p.device))
    finally:
        for h in handles:
            h.remove()
    return total[0]
