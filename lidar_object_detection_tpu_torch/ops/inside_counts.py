"""Inside-count of the fusion step: kernel K1 and its plain twin.

Counterpart of ``lidar_object_detection_tpu/ops/pallas_count.py``
(``pallas_inside_counts_packed``).  For every (detection, box) pair it
counts the detection's points that fall inside the oriented box, taking the
per-point membership as the packed 32-bit word (bit d = detection d), so the
(D, P) membership matrix is never built on the kernel path.

Each function takes one frame -- points (P, 3), words (P,), corners
(G, 8, 3), box mask (G,) -- or a batch of frames with a leading (B,) axis
on each, and returns counts (D, G) and totals (D,), or (B, D, G) and
(B, D).

* :func:`inside_counts_cuda` launches the hand-written CUDA kernel
  (``csrc/inside_counts.cu``) on CUDA tensors, once for the whole batch,
  and raises on anything else.
* :func:`inside_counts_plain` is the plain PyTorch twin: the math of the
  JAX package's ``_chunked_inside_counts`` (``fusion/associate.py:99-132``),
  a (D, chunk) @ (chunk, G) product over point chunks, frame by frame.  It
  is the CPU path, the kernel's first oracle on the card, and computes in
  the dtype of its inputs.
* :func:`inside_counts` takes the kernel for a CUDA tensor and the twin for
  a CPU tensor.

All return exact int32 counts.  Both encode invalid boxes with zero axes
and offset -2 (the kernel skips them, which changes nothing) and evaluate
the projections in the same order (``geom.boxes.inside_from_frame``), so
they agree bit for bit.  The kernel also reads the corners, to cull the
boxes that a group of points cannot reach.
"""

from __future__ import annotations

import torch

from lidar_object_detection_tpu_torch.geom.boxes import (
    inside_from_frame, masked_box_frame)
from lidar_object_detection_tpu_torch.ops import kernel_lib
from lidar_object_detection_tpu_torch.ops.masks import unpack_point_bits
from lidar_object_detection_tpu_torch.utils import profiling


def _plain_frame(points, point_bits, corners, box_mask, num_det: int,
                 chunk: int):
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


def inside_counts_plain(points, point_bits, corners, box_mask,
                        num_det: int, chunk: int = 16384):
    """Plain PyTorch inside-count of one frame or a batch.

    Args:
      points: (P, 3) or (B, P, 3) points, velodyne frame.
      point_bits: (P,) or (B, P) int32 packed membership (invalid points
        already 0).
      corners: (G, 8, 3) or (B, G, 8, 3) box corners, same frame.
      box_mask: (G,) or (B, G) bool valid boxes.
      num_det: number of detection bit planes (<= 32).

    Returns (counts (D, G) int32, totals (D,) int32), each with the
    leading (B,) axis of a batch.
    """
    if points.dim() == 2:
        return _plain_frame(points, point_bits, corners, box_mask, num_det,
                            chunk)
    frames = [_plain_frame(points[b], point_bits[b], corners[b], box_mask[b],
                           num_det, chunk) for b in range(points.shape[0])]
    return (torch.stack([c for c, _ in frames]),
            torch.stack([t for _, t in frames]))


def inside_counts_cuda(points, point_bits, corners, box_mask, num_det: int):
    """Launch the CUDA inside-count kernel once for one frame or a batch.

    Takes float32 points (B, P, 3), int32 words (B, P), float32 corners
    (B, G, 8, 3) and a bool box mask (B, G), all contiguous on one CUDA
    device; one frame may come without the (B,) axis.  Returns
    (counts (B, D, G) int32, totals (B, D) int32), without the (B,) axis
    for one frame.
    """
    device = points.device
    if device.type != "cuda":
        raise ValueError(f"inside_counts_cuda needs CUDA tensors, got "
                         f"{device}")
    if not 1 <= num_det <= 32:
        raise ValueError(f"num_det must be in [1, 32], got {num_det}")
    if points.dim() == 2:
        counts, totals = inside_counts_cuda(
            points[None], point_bits[None], corners[None], box_mask[None],
            num_det)
        return counts[0], totals[0]
    b, p = points.shape[:2]
    g = corners.shape[1]
    check = kernel_lib.check_operand
    check(points, "points", torch.float32, (b, p, 3), device)
    check(point_bits, "point_bits", torch.int32, (b, p), device)
    check(corners, "corners", torch.float32, (b, g, 8, 3), device)
    check(box_mask, "box_mask", torch.bool, (b, g), device)
    axes, offsets = masked_box_frame(corners, box_mask)
    frame = torch.cat([axes, offsets[..., None]], dim=-1).reshape(b, g, 12)
    frame = frame.contiguous()
    counts = torch.zeros((b, num_det, g), dtype=torch.int32, device=device)
    totals = torch.zeros((b, num_det), dtype=torch.int32, device=device)
    with profiling.span("kernel.inside_counts"):
        lib = kernel_lib.library()
        code = lib.inside_counts_launch(
            points.data_ptr(), point_bits.data_ptr(), frame.data_ptr(),
            corners.data_ptr(), box_mask.data_ptr(), b, p, g, num_det,
            counts.data_ptr(), totals.data_ptr(),
            kernel_lib.sm_count(device), kernel_lib.stream_handle(device))
        kernel_lib.check(code, "inside_counts_launch")
        kernel_lib.LAUNCHES["inside_counts"] += 1
    return counts, totals


def inside_counts(points, point_bits, corners, box_mask, num_det: int,
                  chunk: int = 16384):
    """The kernel on a CUDA tensor (points and corners taken as float32),
    the plain twin in the inputs' dtype on a CPU tensor; one frame or a
    batch, as :func:`inside_counts_plain`."""
    if points.device.type == "cpu":
        return inside_counts_plain(points, point_bits, corners, box_mask,
                                   num_det, chunk)
    return inside_counts_cuda(points.to(torch.float32).contiguous(),
                              point_bits.contiguous(),
                              corners.to(torch.float32).contiguous(),
                              box_mask.contiguous(), num_det)
