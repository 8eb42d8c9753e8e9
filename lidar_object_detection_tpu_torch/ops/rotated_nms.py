"""Greedy NMS on the exact rotated BEV IoU: the SSD decode's suppression
as a CUDA kernel, with its plain twin.

Counterpart of ``lidar_object_detection_tpu/models/pointpillars/decode.py``
``_rotated_nms`` (lines 146-171) over ``ops/rotated_iou.py``
``rotated_iou_matrix``.  Not a Pallas kernel: XLA compiles the 512 x 512
IoU matrix and the 64-step ``fori_loop`` into one device program, where
PyTorch op by op would launch some ten kernels a step and hundreds over
the 262,144 pairs, per frame.

* :func:`rotated_nms_plain` follows ``_rotated_nms`` step for step over
  :func:`.rotated_iou.rotated_iou_matrix`, frames side by side on a
  leading axis.  It is the CPU path and the kernel's oracle on the card.
* :func:`rotated_nms_cuda` launches ``csrc/rotated_nms.cu`` on CUDA
  tensors, one thread block per frame and one thread per candidate, all
  frames in one launch, and raises on anything else.
* :func:`rotated_nms` takes the twin for a CPU tensor and the kernel for a
  CUDA tensor.

Each slot takes the alive candidate of the highest score (ties to the
lowest index, as ``jnp.argmax``), NaN and invalid scores never alive, and
kills the candidates whose IoU with it (its row of the matrix) exceeds the
threshold, itself included.  The kernel computes each IoU in the twin's
operations and order but sums the shoelace area in another order, so an
IoU may differ in its last bits: a pick can differ only where a deciding
IoU lies that close to the threshold.
"""

from __future__ import annotations

import torch

from lidar_object_detection_tpu_torch.ops import kernel_lib
from lidar_object_detection_tpu_torch.ops.rotated_iou import (
    rotated_iou_matrix)

# the kernel's limit: one thread per candidate in one block
MAX_CANDIDATES = 1024


def rotated_nms_plain(boxes7, scores, valid, iou_threshold: float,
                      max_outputs: int, return_pairs: bool = False):
    """Greedy rotated NMS of one frame (N, 7) or a batch (B, N, 7), in
    plain PyTorch.

    Returns (indices int32, keep bool), each (max_outputs,) or
    (B, max_outputs).  With ``return_pairs`` it also returns each frame's
    number of (pick, alive candidate other than the pick) pairs, (B,)
    int64: the IoUs the kernel's steps need.
    """
    single = boxes7.dim() == 2
    if single:
        boxes7, scores, valid = boxes7[None], scores[None], valid[None]
    b, n = scores.shape
    dev = scores.device
    iou = torch.stack([rotated_iou_matrix(bx, bx) for bx in boxes7])
    neg = torch.tensor(float("-inf"), device=dev)
    finite = valid & torch.isfinite(scores)
    base = torch.where(finite, scores.to(torch.float32), neg)
    alive = finite.clone()
    rows = torch.arange(b, device=dev)
    cols = torch.arange(n, device=dev)
    out_idx = torch.zeros((b, max_outputs), dtype=torch.int32, device=dev)
    out_keep = torch.zeros((b, max_outputs), dtype=torch.bool, device=dev)
    pairs = torch.zeros(b, dtype=torch.int64, device=dev)
    for slot in range(max_outputs):
        masked = torch.where(alive, base, neg)
        best = masked.argmax(dim=1)                                # (B,)
        ok = alive[rows, best] & (base[rows, best] > neg)
        out_idx[:, slot] = torch.where(ok, best, 0).to(torch.int32)
        out_keep[:, slot] = ok
        pairs += torch.where(ok, alive.sum(dim=1) - 1, 0)
        suppress = (iou[rows, best] > iou_threshold) | (cols == best[:, None])
        alive = torch.where(ok[:, None], alive & ~suppress, alive)
    if single:
        out_idx, out_keep, pairs = out_idx[0], out_keep[0], pairs[0]
    return (out_idx, out_keep, pairs) if return_pairs else (out_idx,
                                                             out_keep)


def rotated_nms_cuda(boxes7, scores, valid, iou_threshold: float,
                     max_outputs: int, iou_rows: bool = False):
    """Launch the rotated-NMS kernel over a batch.

    Takes float32 boxes7 (B, N, 7), float32 scores (B, N) and a bool
    candidate mask (B, N), all contiguous on one CUDA device, 1 <= N <=
    1024.  Returns (indices (B, M) int32, keep (B, M) bool); with
    ``iou_rows`` also each slot's IoU of its pick with every candidate,
    (B, M, N) float32 (zeros after the last pick), for checks.
    """
    device = boxes7.device
    if device.type != "cuda":
        raise ValueError(f"rotated_nms_cuda needs CUDA tensors, got {device}")
    if boxes7.dim() != 3:
        raise ValueError(f"boxes7 must be (B, N, 7), got "
                         f"{tuple(boxes7.shape)}")
    b, n = boxes7.shape[:2]
    if not 1 <= n <= MAX_CANDIDATES:
        raise ValueError(f"the kernel takes 1 to {MAX_CANDIDATES} "
                         f"candidates, got {n}")
    if max_outputs < 1:
        raise ValueError(f"max_outputs must be >= 1, got {max_outputs}")
    check = kernel_lib.check_operand
    check(boxes7, "boxes7", torch.float32, (b, n, 7), device)
    check(scores, "scores", torch.float32, (b, n), device)
    check(valid, "valid", torch.bool, (b, n), device)
    out_idx = torch.empty((b, max_outputs), dtype=torch.int32, device=device)
    out_keep = torch.empty((b, max_outputs), dtype=torch.bool, device=device)
    rows = (torch.zeros((b, max_outputs, n), dtype=torch.float32,
                        device=device) if iou_rows else None)
    lib = kernel_lib.library()
    code = lib.rotated_nms_launch(
        boxes7.data_ptr(), scores.data_ptr(), valid.data_ptr(), b, n,
        max_outputs, float(iou_threshold), out_idx.data_ptr(),
        out_keep.data_ptr(), None if rows is None else rows.data_ptr(),
        kernel_lib.stream_handle(device))
    kernel_lib.check(code, "rotated_nms_launch")
    kernel_lib.LAUNCHES["rotated_nms"] += 1
    return (out_idx, out_keep, rows) if iou_rows else (out_idx, out_keep)


def rotated_nms(boxes7, scores, valid, iou_threshold: float,
                max_outputs: int):
    """Greedy rotated NMS of one frame (N, 7) or a batch (B, N, 7): the
    twin on a CPU tensor, the kernel on a CUDA tensor (boxes and scores
    taken as float32).  Returns what :func:`rotated_nms_plain` returns."""
    if boxes7.device.type == "cpu":
        return rotated_nms_plain(boxes7, scores, valid, iou_threshold,
                                 max_outputs)
    single = boxes7.dim() == 2
    if single:
        boxes7, scores, valid = boxes7[None], scores[None], valid[None]
    idx, keep = rotated_nms_cuda(boxes7.to(torch.float32).contiguous(),
                                 scores.to(torch.float32).contiguous(),
                                 valid.contiguous(), iou_threshold,
                                 max_outputs)
    return (idx[0], keep[0]) if single else (idx, keep)
