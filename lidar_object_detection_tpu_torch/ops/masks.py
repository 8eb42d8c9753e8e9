"""Bit-packed instance masks and the per-point mask gather.

Counterpart of ``lidar_object_detection_tpu/ops/masks.py``.  All <= 32
binary instance masks of a frame are packed into one 32-bit word per pixel
(bit d = detection d), so the per-point lookup is one gather of one word
per point, and erosion works on all masks at once with bitwise operations.

The words are held as ``torch.int32`` (a bit-identical view of the JAX
package's ``uint32``): PyTorch's ``uint32`` lacks shifts and compares on
the CPU.  Packing sums in int64 and wraps to int32 with
:func:`wrap_int32`.
"""

from __future__ import annotations

import torch


def wrap_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 tensor with the same 32
    bits (two's complement)."""
    return (((words + 2 ** 31) % 2 ** 32) - 2 ** 31).to(torch.int32)


def bit_weights(num_bits: int, device=None) -> torch.Tensor:
    """(num_bits,) int64 ``1 << d``."""
    return torch.ones((), dtype=torch.int64, device=device) << torch.arange(
        num_bits, dtype=torch.int64, device=device)


def pack_masks(masks: torch.Tensor) -> torch.Tensor:
    """(..., D, H, W) {0, 1} masks -> (..., H, W) int32 packed words,
    D <= 32."""
    d = masks.shape[-3]
    if d > 32:
        raise ValueError(f"at most 32 masks per frame, got {d}")
    w = bit_weights(d, masks.device)
    return wrap_int32((masks.to(torch.int64) * w[:, None, None]).sum(dim=-3))


def unpack_masks(bits: torch.Tensor, num_masks: int) -> torch.Tensor:
    """(H, W) int32 -> (D, H, W) bool."""
    d = torch.arange(num_masks, dtype=torch.int32, device=bits.device)
    return ((bits[None, :, :] >> d[:, None, None]) & 1).to(torch.bool)


def gather_point_bits(mask_bits: torch.Tensor, u, v, valid) -> torch.Tensor:
    """(..., P) int32 membership word of each point of (..., H, W) words
    (one frame or a batch); 0 for invalid points.

    A plain gather: the JAX package fetches aligned 128-lane rows instead
    (``masks.py:65-70``), which only pays on a TPU.
    """
    h, w = mask_bits.shape[-2:]
    ui = u.to(torch.int32).clamp(0, w - 1)
    vi = v.to(torch.int32).clamp(0, h - 1)
    lin = (vi * w + ui).to(torch.int64)
    flat = mask_bits.reshape(*mask_bits.shape[:-2], h * w)
    bits = torch.gather(flat, -1, lin)
    return torch.where(valid, bits, torch.zeros_like(bits))


def unpack_point_bits(bits: torch.Tensor, num_detections: int):
    """(..., P) int32 -> (..., D, P) bool membership."""
    d = torch.arange(num_detections, dtype=torch.int32, device=bits.device)
    return ((bits[..., None, :] >> d[:, None]) & 1).to(torch.bool)


def gather_mask_bits(mask_bits: torch.Tensor, u, v, valid,
                     num_detections: int) -> torch.Tensor:
    """Per-point mask membership of every detection at once: (..., H, W)
    int32 words and (..., P) coordinates and validity -> (..., D, P)
    bool, True where point p is valid and in detection d's mask."""
    return unpack_point_bits(gather_point_bits(mask_bits, u, v, valid),
                             num_detections)


def detection_word(det_valid: torch.Tensor) -> torch.Tensor:
    """(..., D) bool -> (...) int32 word with bit d set for each valid d."""
    w = bit_weights(det_valid.shape[-1], det_valid.device)
    return wrap_int32(torch.where(det_valid, w, 0).sum(dim=-1))
