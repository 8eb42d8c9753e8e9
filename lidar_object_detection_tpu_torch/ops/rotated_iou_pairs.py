"""The exact rotated BEV IoUs of the training assigner's candidate pairs:
a CUDA kernel, with its plain twin.

Counterpart of the clip in ``_rotated_iou_topk`` of
``lidar_object_detection_tpu/models/pointpillars/loss.py`` (lines 76-84):
for every frame b and GT box g, the K anchors of the largest IoU bound
are clipped exactly by the GT, ``rotated_iou_matrix(cand, gt[None])``
under ``vmap`` over the GTs (and over the frames, by the loss's
``vmap``).  XLA fuses that into the training step; op by op in PyTorch
it would launch per GT, some 10^5 launches a step.

* :func:`rotated_iou_pairs_cuda` launches ``rotated_iou_pairs_kernel``
  of ``csrc/rotated_nms.cu`` on CUDA tensors, one block per (frame, GT,
  256 candidates), the whole step's pairs in one launch, and raises on
  anything else.  A block lists its near candidates densely and clips
  them one a thread; a pair whose GT is not valid comes out 0 unclipped.
* :func:`candidate_ious` takes the kernel for CUDA tensors and the twin,
  :func:`.rotated_iou.rotated_iou_pairs` over the gathered anchors, for
  CPU tensors (every pair clipped, as JAX clips them).

The kernel computes each IoU in the twin's operations and order but sums
the shoelace area in another order (``ops/rotated_nms.py``), so an IoU
may differ from the twin's in its last bits, and an assignment only where
a deciding IoU lies that close to a threshold.  No backward: the
assignment takes no gradient.
"""

from __future__ import annotations

import torch

from lidar_object_detection_tpu_torch.ops import kernel_lib
from lidar_object_detection_tpu_torch.ops.rotated_iou import (
    rotated_iou_pairs)
from lidar_object_detection_tpu_torch.utils import profiling


def rotated_iou_pairs_plain(anchors, idx, gt_boxes7):
    """(B, G, K) float32: anchor ``idx[b, g, k]`` of ``anchors`` (N, 7)
    clipped by ``gt_boxes7[b, g]`` (B, G, 7), in plain PyTorch."""
    cand = anchors[idx]                                     # (B, G, K, 7)
    return rotated_iou_pairs(cand, gt_boxes7[:, :, None, :].expand_as(cand))


def rotated_iou_pairs_cuda(anchors, idx, gt_boxes7, gt_valid,
                           count_slow: bool = False):
    """Launch the assigner's IoU kernel.

    Takes float32 anchors (N, 7), int64 indices (B, G, K) into them,
    float32 GT boxes (B, G, 7) and a bool GT mask (B, G), all contiguous
    on one CUDA device.  Returns (B, G, K) float32, 0 where the GT is not
    valid.  With ``count_slow``, for checks, it also returns the number of
    pairs whose clipped rings outgrew the fast clip's register slots and
    took the ring routine, a (1,) int32 tensor.
    """
    device = anchors.device
    if device.type != "cuda":
        raise ValueError(f"rotated_iou_pairs_cuda needs CUDA tensors, got "
                         f"{device}")
    if idx.dim() != 3:
        raise ValueError(f"idx must be (B, G, K), got {tuple(idx.shape)}")
    b, g, k = idx.shape
    n = anchors.shape[0]
    check = kernel_lib.check_operand
    check(anchors, "anchors", torch.float32, (n, 7), device)
    check(idx, "idx", torch.int64, (b, g, k), device)
    check(gt_boxes7, "gt_boxes7", torch.float32, (b, g, 7), device)
    check(gt_valid, "gt_valid", torch.bool, (b, g), device)
    out = torch.empty((b, g, k), dtype=torch.float32, device=device)
    slow = (torch.zeros(1, dtype=torch.int32, device=device)
            if count_slow else None)
    with profiling.span("kernel.rotated_iou_pairs"):
        code = kernel_lib.library().rotated_iou_pairs_launch(
            anchors.data_ptr(), n, idx.data_ptr(), gt_boxes7.data_ptr(),
            gt_valid.data_ptr(), b, g, k, out.data_ptr(),
            None if slow is None else slow.data_ptr(),
            kernel_lib.stream_handle(device))
        kernel_lib.check(code, "rotated_iou_pairs_launch")
        kernel_lib.LAUNCHES["rotated_iou_pairs"] += 1
    return (out, slow) if count_slow else out


def candidate_ious(anchors, idx, gt_boxes7, gt_valid):
    """(B, G, K) exact IoUs of the assigner's candidate pairs: the twin on
    CPU tensors, the kernel on CUDA tensors."""
    if anchors.device.type == "cpu":
        return rotated_iou_pairs_plain(anchors, idx, gt_boxes7)
    return rotated_iou_pairs_cuda(
        anchors.to(torch.float32).contiguous(), idx.contiguous(),
        gt_boxes7.to(torch.float32).contiguous(), gt_valid.contiguous())
