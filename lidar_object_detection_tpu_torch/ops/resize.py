"""Bilinear resize with the weights of ``jax.image.resize``.

``jax.image.resize(..., method="bilinear")`` resamples each spatial axis
with a dense (n_in, n_out) weight matrix: a triangle kernel at the sample
positions ``(i + 0.5) / scale - 0.5``, widened by 1 / scale when
downsampling (antialiasing), each column normalized to sum 1, and columns
whose sample falls outside the input zeroed.  :func:`resize_weight_matrix`
computes that matrix with numpy in float64 and rounds it to float32, as
JAX does with 64-bit floats enabled.  The JAX package uses such resizes for
the letterbox (a downsample) and for the mask upsample, whose two taps per
output (:func:`resize_taps`) the mask-assembly kernels read.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def resize_weight_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of a 1-D bilinear resize."""
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :]
               - np.arange(n_in, dtype=np.float64)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(np.abs(total) > eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = np.where(inside[None, :], w, 0.0)
    out = w.astype(np.float32)
    out.flags.writeable = False
    return out


@functools.lru_cache(maxsize=64)
def resize_taps(n_in: int, n_out: int):
    """Per output pixel, (first tap index int32, weight0, weight1) of an
    upsampling bilinear resize, read off :func:`resize_weight_matrix`;
    the second tap is ``min(index + 1, n_in - 1)``, with weight 0 where it
    does not exist.  Upsampling has at most two taps per output."""
    if n_out < n_in:
        raise ValueError(f"resize_taps serves upsampling only: {n_in} -> "
                         f"{n_out} needs more than two taps per output")
    w = resize_weight_matrix(n_in, n_out)
    idx0 = np.argmax(w > 0, axis=0).astype(np.int32)
    ar = np.arange(n_out)
    w0 = w[idx0, ar]
    idx1 = np.minimum(idx0 + 1, n_in - 1)
    w1 = np.where(idx1 > idx0, w[idx1, ar], np.float32(0.0))
    out = (idx0, w0.astype(np.float32), w1.astype(np.float32))
    for a in out:
        a.flags.writeable = False
    return out


def resize_hw(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C) to (..., out_h, out_w, C) with
    the ``jax.image.resize`` weights, as two dense contractions in the
    input's dtype."""
    h, w = x.shape[-3], x.shape[-2]
    out = x
    if h != out_h:
        wh = torch.from_numpy(resize_weight_matrix(h, out_h).copy()).to(
            device=x.device, dtype=x.dtype)
        out = torch.einsum("...hwc,hH->...Hwc", out, wh)
    if w != out_w:
        ww = torch.from_numpy(resize_weight_matrix(w, out_w).copy()).to(
            device=x.device, dtype=x.dtype)
        out = torch.einsum("...hwc,wW->...hWc", out, ww)
    return out
