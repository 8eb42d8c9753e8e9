"""What the port's two model families share: Flax's BatchNorm, Flax's
default initializer, and the numerics scopes and division that keep a
network's bits equal across runs and devices.

* :class:`BatchNorm` and :func:`_update_running`: Flax's ``nn.BatchNorm``
  over NCHW, in evaluation and in training.
* :func:`flax_default_init`: Flax's default distributions drawn from a
  ``torch.Generator``.
* :func:`full_float32`: cuDNN convolutions and cuBLAS products in IEEE
  float32 (no TF32), as the JAX package computes; :func:`mixed_precision`
  adds bf16 products summed in float32, as XLA sums them, and
  :func:`numerics` picks the scope of a compute dtype.
* Flax's ``dtype``, the compute dtype of a mixed-precision network:
  :class:`Conv2d`, :class:`ConvTranspose2d` and :class:`Linear` compute
  in their ``compute_dtype`` from float32 parameters
  (:func:`set_compute_dtype`); :func:`flax_silu` rounds as Flax's.
* :func:`repeatable`: cuDNN's deterministic algorithms, for a backward
  that gives the same bits each run.
* :func:`true_div`: IEEE division by a scalar on every device.
* :func:`split_batch`, :func:`batch_mean`, :func:`batch_sum` and
  :func:`global_sum`: a training batch split over the ranks of a
  ``torch.distributed`` group (the scale-out mesh's ``data`` axis) takes
  its statistics and normalisers over the whole batch, as JAX's step on a
  sharded batch does.  With no group each returns its input itself, so
  the one-card step is unchanged.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

# Flax's variance_scaling divides the standard deviation by the standard
# deviation of a standard normal truncated to (-2, 2)
TRUNCATED_STD = 0.87962566103423978


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm`` over NCHW; ``eps`` and ``momentum`` default
    to the YOLO11 blocks' (ultralytics').

    ``forward(x)`` evaluates with the running statistics, with the rounding
    of Flax's under ``jax.jit``.  Flax computes the multiplier ``rsqrt(var
    + eps) * gamma`` in the dtype the checkpoint stores the statistics in
    (bfloat16 for the x checkpoint and for folded bf16 trees), ``eps``
    rounded to it first.  Compiled by XLA, as the JAX detector serves it,
    the sum and the ``rsqrt`` round to that dtype and the product stays
    float32; op by op the product rounds too.  Loading a state dict records
    the dtype, so the multiplier rounds as the jitted forward's whatever
    dtype the module was cast to.  A folded tree's multiplier is exactly 1
    either way.

    ``forward(x, train=True)`` takes the batch's statistics over (N, H,
    W): mean ``E[x]`` and the biased variance ``max(E[x^2] - E[x]^2, 0)``
    (Flax's ``use_fast_variance``), in float32, over the whole batch when
    it is split over the ranks of ``batch_group``
    (:func:`batch_mean`: each rank's ``E[x]`` and
    ``E[x^2]`` averaged over the ranks, with their gradients); the output
    is ``(x - mean)
    * (rsqrt(var + eps) * scale) + bias``; and, with no gradient,
    ``running = m * running + (1 - m) * batch`` (m = ``momentum``, Flax's
    convention: ``torch.nn.BatchNorm2d``'s momentum would be 1 - m, and it
    keeps the unbiased variance).  The statistics and the normalization
    are float32 whatever the input's dtype, and the output has the
    input's dtype: a bfloat16 input (a mixed-precision network's) gives a
    bfloat16 output, as Flax's ``BatchNorm(dtype=bfloat16)`` does.
    """

    def __init__(self, c: int, eps: float = 1e-3, momentum: float = 0.97):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self._set_stats_dtype(torch.float32)
        # the process group a training batch is split over
        # (split_batch); None: this rank's batch
        self.batch_group = None

    def _set_stats_dtype(self, dtype: torch.dtype) -> None:
        self.stats_dtype = dtype
        self._eps = float(torch.tensor(self.eps, dtype=dtype))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        var = state_dict.get(prefix + "running_var")
        gamma = state_dict.get(prefix + "weight")
        if var is not None and gamma is not None:
            self._set_stats_dtype(torch.promote_types(var.dtype, gamma.dtype))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x, train: bool = False):
        if train:
            dtype = x.dtype
            x = x.float()
            mean, mean_sq = batch_mean(
                self.batch_group, x.mean(dim=(0, 2, 3)),
                (x * x).mean(dim=(0, 2, 3)))
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            _update_running(self, mean, var)
            mul = torch.rsqrt(var + self.eps) * self.weight
            return ((x - mean[:, None, None]) * mul[:, None, None]
                    + self.bias[:, None, None]).to(dtype)
        # rounded to the statistics' dtype after the sum and after the rsqrt
        # (taken in float32: PyTorch's bfloat16 rsqrt on the CPU is not
        # correctly rounded); the product is float32
        sd = self.stats_dtype
        r = torch.rsqrt((self.running_var.to(sd) + self._eps).float())
        mul = r.to(sd).float() * self.weight
        y = (x.float() - self.running_mean.float()[:, None, None]) \
            * mul[:, None, None] + self.bias.float()[:, None, None]
        return y.to(x.dtype)


# ---------------------------------------------------------------------------
# a training batch split over ranks
# ---------------------------------------------------------------------------

def split_batch(model: nn.Module, group) -> None:
    """Make ``model``'s train-mode BatchNorms take their statistics over
    the batch split over ``group`` (None: the rank's own batch): sets the
    ``batch_group`` of every module that has one."""
    for module in model.modules():
        if hasattr(module, "batch_group"):
            module.batch_group = group


class AllReduceSum(torch.autograd.Function):
    """The sum over a group of each rank's share; the backward sums the
    gradients, since every rank's share depends on the sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def batch_mean(group, *stats: torch.Tensor):
    """The means of the whole batch from each rank's means over its own
    rows (each rank holds as many rows as any other: the batch divides):
    their sum over ``group``, divided by its size, through
    :class:`AllReduceSum`; the means as they are when ``group`` is None.
    Returns a tuple."""
    if group is None:
        return stats
    summed = AllReduceSum.apply(torch.stack(stats), group)
    n = torch.full((), dist.get_world_size(group), dtype=summed.dtype,
                   device=summed.device)
    return tuple((summed / n).unbind(0))


def batch_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of each rank's partial sum, with its
    gradient (:class:`AllReduceSum`); ``x`` when ``group`` is None."""
    return x if group is None else AllReduceSum.apply(x, group)


def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A normaliser summed over ``group``, detached (a count or a sum of
    targets: no gradient flows through it, as none does in JAX's step);
    ``x`` when ``group`` is None."""
    if group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def _update_running(bn: nn.Module, mean, var) -> None:
    """Flax's running-average update of ``bn``'s buffers, no gradient."""
    m = bn.momentum
    with torch.no_grad():
        bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
        bn.running_var.copy_(m * bn.running_var + (1 - m) * var)


def _fan_in(module: nn.Module, weight: torch.Tensor) -> int:
    if isinstance(module, nn.ConvTranspose2d):     # (in, out, kh, kw)
        return weight.shape[0] * weight.shape[2] * weight.shape[3]
    return math.prod(weight.shape[1:])             # (out, in, ...) layouts


@torch.no_grad()
def flax_default_init(model: nn.Module, seed: int = 0,
                      biases: Optional[Dict[str, float]] = None,
                      fan_ins: Optional[Dict[str, int]] = None
                      ) -> nn.Module:
    """Initialize ``model``'s parameters and BatchNorm statistics in place
    from ``seed`` with Flax's defaults; ``biases`` maps a module's name to
    the constant of its bias (0 elsewhere), ``fan_ins`` to the fan-in of
    its kernel where Flax's differs from the layer's own.  Returns the
    model.

    Every kernel of two or more dimensions: Flax's ``lecun_normal``, a
    normal truncated at two standard deviations and scaled to variance 1 /
    fan_in; BatchNorm scales 1, running means 0 and variances 1.  The draws
    are made on the CPU in the order of ``named_parameters`` and copied to
    the model's device, so a seed gives the same bits on any device."""
    biases, fan_ins = biases or {}, fan_ins or {}
    gen = torch.Generator().manual_seed(seed)
    modules = dict(model.named_modules())
    for name, param in model.named_parameters():
        stem, leaf = name.rsplit(".", 1)
        module = modules[stem]
        if leaf == "weight" and param.dim() >= 2:
            fan_in = fan_ins.get(stem) or _fan_in(module, param)
            std = math.sqrt(1.0 / fan_in) / TRUNCATED_STD
            value = torch.empty(param.shape, dtype=torch.float32)
            nn.init.trunc_normal_(value, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=gen)
        elif leaf == "weight":                     # a BatchNorm scale
            value = torch.ones(param.shape)
        else:
            value = torch.full(param.shape, biases.get(stem, 0.0))
        param.copy_(value)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.zero_()
        elif name.endswith("running_var"):
            buf.fill_(1.0)
    return model


@contextlib.contextmanager
def full_float32():
    """cuDNN convolutions and cuBLAS products in IEEE float32 (no TF32)
    inside the scope; the caller's settings are restored after it."""
    conv = torch.backends.cudnn.conv
    matmul = torch.backends.cuda.matmul
    saved = conv.fp32_precision, matmul.fp32_precision
    conv.fp32_precision = "ieee"
    matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision, matmul.fp32_precision = saved


@contextlib.contextmanager
def mixed_precision():
    """The scope of a mixed-precision step: :func:`full_float32`, and
    cuBLAS's bfloat16 products summed in float32 (PyTorch lets cuBLAS
    reduce them in bfloat16 by default; XLA sums in float32); the
    caller's settings are restored after it."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        with full_float32():
            yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved


def numerics(dtype: Optional[torch.dtype]):
    """The scope a network of compute dtype ``dtype`` runs in:
    :func:`mixed_precision` for bfloat16, else :func:`full_float32`."""
    return (mixed_precision() if dtype == torch.bfloat16
            else full_float32())


# ---------------------------------------------------------------------------
# Flax's dtype: float32 parameters, products in the compute dtype
# ---------------------------------------------------------------------------

def set_compute_dtype(model: nn.Module,
                      dtype: Optional[torch.dtype]) -> None:
    """Give every layer of ``model`` that has a ``compute_dtype`` the
    compute dtype ``dtype``, Flax's ``dtype`` of a module: its input,
    kernel and bias cast to it at the call (Flax's ``promote_dtype``), the
    parameters kept as they are.  float32 (or None) sets None: each
    layer's own call, bit for bit as before."""
    dtype = None if dtype in (None, torch.float32) else dtype
    for module in model.modules():
        if hasattr(module, "compute_dtype"):
            module.compute_dtype = dtype


def _in_dtype(layer: nn.Module, x, product):
    """``layer``'s output with Flax's dtype: the product of the input and
    the kernel cast to ``compute_dtype``, rounded to it, then the bias
    cast to it added in it (two roundings where a fused bias rounds
    once)."""
    dt = layer.compute_dtype
    y = product(x.to(dt), layer.weight.to(dt))
    if layer.bias is None:
        return y
    return y + layer.bias.to(dt).reshape(-1, *[1] * (y.dim() - 2))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (its parameters, state-dict keys and initializer)
    computing in ``compute_dtype`` where it is set (Flax's
    ``nn.Conv(dtype=...)``); None: ``nn.Conv2d``'s own call."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        if self.compute_dtype is None:
            return super().forward(x)
        return _in_dtype(self, x, lambda x, w: self._conv_forward(
            x, w, None))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``compute_dtype`` where it is
    set (Flax's ``nn.ConvTranspose(dtype=...)`` and the YOLO Proto's
    upsample); None: its own call.

    In a compute dtype the layer takes kernel == stride and no padding,
    as both networks' do, and is the JAX Proto's einsum: output pixel
    ``(s*h + a, s*w + c)`` is ``sum_i x[i, h, w] * W[i, o, a, c]``, one
    product summed in float32 and rounded.  (PyTorch's bfloat16
    ``conv_transpose2d`` on the CPU gets the input's gradient wrong at
    kernel == stride == 4: off by more than its largest entry.)"""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        if self.compute_dtype is None:
            return super().forward(x)
        k, s = tuple(self.kernel_size), tuple(self.stride)
        if k != s or any(self.padding) or any(self.output_padding) \
                or self.groups != 1 or any(d != 1 for d in self.dilation):
            raise ValueError(f"a ConvTranspose2d in a compute dtype takes "
                             f"kernel == stride and no padding, got "
                             f"kernel {k}, stride {s}")

        def product(x, w):
            b, _, h, wd = x.shape
            y = torch.einsum("bihw,ioac->bohawc", x, w)
            return y.reshape(b, w.shape[1], h * k[0], wd * k[1])
        return _in_dtype(self, x, product)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` where it is set
    (Flax's ``nn.Dense(dtype=...)``); None: its own call."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        if self.compute_dtype is None:
            return super().forward(x)
        return _in_dtype(self, x, torch.nn.functional.linear)


def flax_silu(x):
    """Flax's ``nn.silu``, ``x * sigmoid(x)``, with the sigmoid as XLA
    expands ``lax.logistic``: ``x * (1 / (1 + exp(-x)))``, each step
    rounded to ``x``'s dtype (bfloat16), where ``F.silu`` rounds once."""
    return x * (1 / (1 + torch.exp(-x)))


@contextlib.contextmanager
def repeatable():
    """cuDNN's deterministic algorithms and no autotuning inside the scope
    (the convolutions' weight gradients otherwise may sum in an order
    that varies); the caller's settings are restored after it."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def true_div(x, scalar: float):
    """``x / scalar`` rounded as IEEE division on every device.  PyTorch's
    CUDA kernel multiplies by the reciprocal of a Python-scalar divisor,
    which can round a quotient at or next to an integer to the other side
    of it: a point by a pillar's edge would fall into the neighbouring
    pillar on the card only.  A divisor on the tensor's device is divided
    by."""
    return x / torch.full((), scalar, dtype=x.dtype, device=x.device)
