"""Binary mask erosion with ``cv2.erode`` parity, on bit-packed masks.

Counterpart of ``lidar_object_detection_tpu/ops/erosion.py``.  The
reference erodes each mask on the host (cvs_erosion.py:77-111) with an
elliptical structuring element; erosion by element S is the AND over the
offsets s in S of the mask shifted by -s, with out-of-image neighbours
counting as foreground (cv2's border for erode never erodes).  On the
packed words this erodes all <= 32 masks of a frame at once;
:func:`erode_masks` wraps it for unpacked masks.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lidar_object_detection_tpu_torch.ops.masks import pack_masks, unpack_masks


@functools.lru_cache(maxsize=None)
def ellipse_kernel_offsets(ksize: int):
    """Offsets (dy, dx) of the OpenCV ``MORPH_ELLIPSE`` (ksize x ksize)
    structuring element, anchor at the centre, rasterized row by row as
    ``cv::getStructuringElement`` does.  ksize 3 gives the cross."""
    r = ksize // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    offsets = []
    for j in range(ksize):
        dy = abs(j - r)
        if dy <= r:
            dx = int(round(r * np.sqrt(max(0.0, 1.0 - dy * dy * inv_r2)))) \
                if r > 0 else 0
        else:
            dx = -1
        for i in range(ksize):
            if abs(i - r) <= dx:
                offsets.append((j - r, i - r))
    return tuple(offsets)


def _shift_all_ones_border(bits: torch.Tensor, dy: int, dx: int):
    """``out[..., y, x] = bits[..., y + dy, x + dx]``, all ones out of
    bounds."""
    h, w = bits.shape[-2:]
    py, px = abs(dy), abs(dx)
    padded = torch.full((*bits.shape[:-2], h + 2 * py, w + 2 * px), -1,
                        dtype=bits.dtype, device=bits.device)
    padded[..., py:py + h, px:px + w] = bits
    return padded[..., py + dy:py + dy + h, px + dx:px + dx + w]


def erode_packed(mask_bits: torch.Tensor, kernel_size: int = 3,
                 iterations: int = 1) -> torch.Tensor:
    """Erode an (..., H, W) int32 packed mask image (one frame or a batch);
    all planes at once."""
    offsets = ellipse_kernel_offsets(kernel_size)
    out = mask_bits
    for _ in range(iterations):
        acc = out
        for dy, dx in offsets:
            if dy == 0 and dx == 0:
                continue
            acc = acc & _shift_all_ones_border(out, dy, dx)
        out = acc
    return out


def erode_masks(masks: torch.Tensor, kernel_size: int = 3,
                iterations: int = 1) -> torch.Tensor:
    """Erode (D, H, W) {0, 1} masks (bool or float); returns bool masks.

    Counterpart of the JAX package's ``erode_masks``, its wrapper for
    unpacked masks: pack, :func:`erode_packed`, unpack (the pipeline
    itself stays packed).
    """
    bits = pack_masks(torch.as_tensor(masks) > 0.5)
    return unpack_masks(erode_packed(bits, kernel_size, iterations),
                        masks.shape[0])
