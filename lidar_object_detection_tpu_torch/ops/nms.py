"""Greedy non-maximum suppression over a fixed candidate count: kernel K5
and its plain twin.

Counterpart of ``lidar_object_detection_tpu/ops/nms.py`` (the XLA loop)
and ``ops/pallas_nms.py`` (``pallas_nms``, the TPU kernel).  Each of
``max_outputs`` steps picks the best surviving candidate (ties to the
lowest index), records it, and suppresses the candidates whose IoU with it
is strictly greater than the threshold, itself included.  NaN and invalid
scores are dropped.

* :func:`nms_cuda` launches the hand-written CUDA kernel (``csrc/nms.cu``)
  on CUDA tensors, one warp per frame, all frames of a batch in one launch
  (the decode gives it both TTA views at once), and raises on anything
  else.
* :func:`nms_plain` is the plain PyTorch twin: every step is a few tensor
  operations over (B, N), frames side by side.  It is the CPU path and the
  kernel's oracle on the card.
* :func:`nms` takes the kernel for a CUDA tensor and the twin for a CPU
  tensor.

Both compute the IoU with the operations of ``geom.boxes.iou_2d_matrix``
in the same order and compare it with the threshold as float32, so they
agree exactly.
"""

from __future__ import annotations

import torch

from lidar_object_detection_tpu_torch.geom.boxes import iou_2d_matrix
from lidar_object_detection_tpu_torch.ops import kernel_lib
from lidar_object_detection_tpu_torch.utils import profiling

# the kernel's limit: 32 candidates on each lane of one warp
MAX_CANDIDATES = 1024


def _single(fn, boxes, scores, valid, iou_threshold, max_outputs):
    idx, keep = fn(boxes[None], scores[None], valid[None], iou_threshold,
                   max_outputs)
    return idx[0], keep[0]


def nms_plain(boxes, scores, valid, iou_threshold: float, max_outputs: int):
    """Greedy NMS of one frame (N candidates) or a batch (B, N), in plain
    PyTorch.

    Returns (indices int64, keep bool), each (max_outputs,) or
    (B, max_outputs): indices into the candidates in descending-score
    order, and which slots hold real detections.
    """
    if boxes.dim() == 2:
        return _single(nms_plain, boxes, scores, valid, iou_threshold,
                       max_outputs)
    b, n = scores.shape
    iou = iou_2d_matrix(boxes, boxes)
    finite = valid & torch.isfinite(scores)
    neg = torch.tensor(float("-inf"), device=scores.device)
    base = torch.where(finite, scores.to(torch.float32), neg)
    alive = finite.clone()
    rows = torch.arange(b, device=scores.device)
    cols = torch.arange(n, device=scores.device)
    out_idx = torch.zeros((b, max_outputs), dtype=torch.int64,
                          device=scores.device)
    out_keep = torch.zeros((b, max_outputs), dtype=torch.bool,
                           device=scores.device)
    for slot in range(max_outputs):
        masked = torch.where(alive, base, neg)
        best = masked.argmax(dim=1)                                # (B,)
        ok = alive[rows, best] & (base[rows, best] > neg)
        out_idx[:, slot] = torch.where(ok, best, 0)
        out_keep[:, slot] = ok
        suppress = (iou[rows, best] > iou_threshold) | (cols == best[:, None])
        alive = torch.where(ok[:, None], alive & ~suppress, alive)
    return out_idx, out_keep


def nms_cuda(boxes, scores, valid, iou_threshold: float, max_outputs: int):
    """Launch the CUDA NMS kernel over a batch.

    Takes float32 boxes (B, N, 4) xyxy, float32 scores (B, N) and a bool
    candidate mask (B, N), all contiguous on one CUDA device, 1 <= N <=
    1024.  Returns (indices (B, M) int64, keep (B, M) bool).
    """
    device = boxes.device
    if boxes.dim() != 3:
        raise ValueError(f"boxes must be (B, N, 4), got {tuple(boxes.shape)}")
    b, n = boxes.shape[:2]
    if not 1 <= n <= MAX_CANDIDATES:
        raise ValueError(f"the kernel takes 1 to {MAX_CANDIDATES} "
                         f"candidates, got {n}")
    if max_outputs < 1:
        raise ValueError(f"max_outputs must be >= 1, got {max_outputs}")
    check = kernel_lib.check_operand
    check(boxes, "boxes", torch.float32, (b, n, 4), device)
    check(scores, "scores", torch.float32, (b, n), device)
    check(valid, "valid", torch.bool, (b, n), device)
    if device.type != "cuda":
        raise ValueError(f"nms_cuda needs CUDA tensors, got {device}")
    if boxes.data_ptr() % 16:
        boxes = boxes.clone()            # the kernel reads float4 boxes
    out_idx = torch.empty((b, max_outputs), dtype=torch.int64, device=device)
    out_keep = torch.empty((b, max_outputs), dtype=torch.bool, device=device)
    with profiling.span("kernel.nms"):
        lib = kernel_lib.library()
        code = lib.nms_launch(boxes.data_ptr(), scores.data_ptr(),
                              valid.data_ptr(), b, n, max_outputs,
                              float(iou_threshold), out_idx.data_ptr(),
                              out_keep.data_ptr(),
                              kernel_lib.stream_handle(device))
        kernel_lib.check(code, "nms_launch")
        kernel_lib.LAUNCHES["nms"] += 1
    return out_idx, out_keep


def nms(boxes, scores, valid, iou_threshold: float, max_outputs: int):
    """Greedy NMS of one frame (N, 4) or a batch (B, N, 4): the kernel on a
    CUDA tensor (boxes and scores taken as float32), the twin on a CPU
    tensor.  Returns what :func:`nms_plain` returns."""
    if boxes.device.type == "cpu":
        return nms_plain(boxes, scores, valid, iou_threshold, max_outputs)
    if boxes.dim() == 2:
        return _single(nms, boxes, scores, valid, iou_threshold, max_outputs)
    return nms_cuda(boxes.to(torch.float32).contiguous(),
                    scores.to(torch.float32).contiguous(),
                    valid.contiguous(), iou_threshold, max_outputs)
