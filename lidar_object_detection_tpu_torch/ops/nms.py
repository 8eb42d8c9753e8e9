"""Greedy non-maximum suppression over a fixed candidate count.

Counterpart of ``lidar_object_detection_tpu/ops/nms.py``, the NMS that the
JAX package serves (``nms_impl="xla"``).  Each of ``max_outputs`` steps
picks the best surviving candidate (ties to the lowest index), records it,
and suppresses the candidates whose IoU with it is strictly greater than
the threshold.  NaN and invalid scores are dropped.  Frames of a batch
run side by side: every step is a few tensor operations over (B, N), with
no host synchronisation.
"""

from __future__ import annotations

import torch

from lidar_object_detection_tpu_torch.geom.boxes import iou_2d_matrix


def nms(boxes, scores, valid, iou_threshold: float, max_outputs: int):
    """Greedy NMS of one frame (N candidates) or a batch (B, N).

    Returns (indices int64, keep bool), each (max_outputs,) or
    (B, max_outputs): indices into the candidates in descending-score
    order, and which slots hold real detections.
    """
    if boxes.dim() == 2:
        idx, keep = nms(boxes[None], scores[None], valid[None],
                        iou_threshold, max_outputs)
        return idx[0], keep[0]
    b, n = scores.shape
    iou = torch.stack([iou_2d_matrix(boxes[i], boxes[i]) for i in range(b)])
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
