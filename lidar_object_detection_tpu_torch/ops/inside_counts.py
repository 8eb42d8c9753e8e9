"""Inside-count of the fusion step: kernel K1 and its plain twin.

Counterpart of ``lidar_object_detection_tpu/ops/pallas_count.py``
(``pallas_inside_counts_packed``).  For every (detection, box) pair it
counts the detection's points that fall inside the oriented box, taking the
per-point membership as the packed 32-bit word (bit d = detection d), so the
(D, P) membership matrix is never built on the kernel path.

* :func:`inside_counts_cuda` launches the hand-written CUDA kernel
  (``csrc/inside_counts.cu``) on CUDA tensors and raises on anything else.
* :func:`inside_counts_plain` is the plain PyTorch twin: the math of the
  JAX package's ``_chunked_inside_counts`` (``fusion/associate.py:99-132``),
  a (D, chunk) @ (chunk, G) product over point chunks.  It is the CPU path,
  the kernel's first oracle on the card, and computes in the dtype of its
  inputs.
* :func:`inside_counts` takes the kernel for a CUDA tensor and the twin for
  a CPU tensor.

Both return exact int32 counts (D, G) and totals (D,).  Both encode invalid
boxes with zero axes and offset -2 and evaluate the projections in the same
order (``geom.boxes.inside_from_frame``), so they agree bit for bit.
"""

from __future__ import annotations

import torch

from lidar_object_detection_tpu_torch.geom.boxes import (
    inside_from_frame, masked_box_frame)
from lidar_object_detection_tpu_torch.ops import kernel_lib
from lidar_object_detection_tpu_torch.ops.masks import unpack_point_bits


def inside_counts_plain(points, point_bits, corners, box_mask,
                        num_det: int, chunk: int = 16384):
    """Plain PyTorch inside-count.

    Args:
      points: (P, 3) points, velodyne frame.
      point_bits: (P,) int32 packed membership (invalid points already 0).
      corners: (G, 8, 3) box corners, same frame.
      box_mask: (G,) bool valid boxes.
      num_det: number of detection bit planes (<= 32).

    Returns (counts (D, G) int32, totals (D,) int32).
    """
    dtype = points.dtype
    axes, offsets = masked_box_frame(corners.to(dtype), box_mask)
    car = unpack_point_bits(point_bits, num_det).to(dtype)        # (D, P)
    p_total = points.shape[0]
    counts = torch.zeros((num_det, corners.shape[0]), dtype=dtype,
                         device=points.device)
    for start in range(0, p_total, chunk):
        stop = min(start + chunk, p_total)
        inside = inside_from_frame(points[start:stop], axes, offsets)
        counts += car[:, start:stop] @ inside.to(dtype)
    return counts.to(torch.int32), car.sum(dim=1).to(torch.int32)


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def inside_counts_cuda(points, point_bits, corners, box_mask, num_det: int):
    """Launch the CUDA inside-count kernel.

    Takes float32 points (P, 3), int32 words (P,), float32 corners
    (G, 8, 3) and a bool box mask (G,), all contiguous on one CUDA device.
    Returns (counts (D, G) int32, totals (D,) int32).
    """
    device = points.device
    if device.type != "cuda":
        raise ValueError(f"inside_counts_cuda needs CUDA tensors, got "
                         f"{device}")
    if not 1 <= num_det <= 32:
        raise ValueError(f"num_det must be in [1, 32], got {num_det}")
    p = points.shape[0]
    g = corners.shape[0]
    _check(points, "points", torch.float32, (p, 3), device)
    _check(point_bits, "point_bits", torch.int32, (p,), device)
    _check(corners, "corners", torch.float32, (g, 8, 3), device)
    _check(box_mask, "box_mask", torch.bool, (g,), device)
    axes, offsets = masked_box_frame(corners, box_mask)
    frame = torch.cat([axes, offsets[..., None]], dim=-1).reshape(g, 12)
    frame = frame.contiguous()
    counts = torch.zeros((num_det, g), dtype=torch.int32, device=device)
    totals = torch.zeros((num_det,), dtype=torch.int32, device=device)
    lib = kernel_lib.library()
    code = lib.inside_counts_launch(
        points.data_ptr(), point_bits.data_ptr(), frame.data_ptr(), p, g,
        num_det, counts.data_ptr(), totals.data_ptr(),
        kernel_lib.sm_count(device), kernel_lib.stream_handle(device))
    kernel_lib.check(code, "inside_counts_launch")
    kernel_lib.LAUNCHES["inside_counts"] += 1
    return counts, totals


def inside_counts(points, point_bits, corners, box_mask, num_det: int,
                  chunk: int = 16384):
    """The kernel on a CUDA tensor (points and corners taken as float32),
    the plain twin in the inputs' dtype on a CPU tensor."""
    if points.device.type == "cpu":
        return inside_counts_plain(points, point_bits, corners, box_mask,
                                   num_det, chunk)
    return inside_counts_cuda(points.to(torch.float32).contiguous(),
                              point_bits, corners.to(torch.float32)
                              .contiguous(), box_mask, num_det)
