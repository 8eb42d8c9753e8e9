"""Horizontal-flip test-time augmentation of the seg decode.

Counterpart of ``lidar_object_detection_tpu/models/yolo/tta.py``.  The
network sees the frame and its horizontal mirror; both views are decoded,
and each normal-view detection whose best flipped-view IoU (boxes mapped
back) reaches ``match_iou`` averages the two views' probability tables
before the serving binarization.  Boxes, scores, validity and order stay
the normal view's.

The average happens at proto resolution: bilinear upsampling is linear and
its taps are symmetric, so mirroring the small cropped table's width axis
and averaging it equals averaging the two upsampled fields.  One table per
frame then goes through the shared assembly tail (``_finish_masks``: K3
and K2 on CUDA).

Under ``jit`` the JAX package's two single-view mask assemblies are dead
code that XLA drops (``tta.py:92-95``).  Eager PyTorch would run them, so
the views are decoded with ``masks=False``, which returns the mask
coefficients and assembles nothing: a TTA frame launches K3 and K2 once
each.  Both views of a batch go through one decode, 2B frames at once, so
the NMS (kernel K5 on CUDA tensors) is one launch per batch; every step of
the decode is per frame, so this changes no output.
"""

from __future__ import annotations

from typing import Dict

import torch

from lidar_object_detection_tpu_torch.geom.boxes import iou_2d_matrix
from lidar_object_detection_tpu_torch.models.yolo.postprocess import (
    PostprocessParams,
    _finish_masks,
    cropped_prob_table,
    postprocess_batch,
)

__all__ = ["flip_boxes", "postprocess_tta", "postprocess_tta_pair"]


def flip_boxes(boxes: torch.Tensor, src_w: float) -> torch.Tensor:
    """xyxy boxes in flipped-source pixels -> normal-source pixels."""
    return torch.stack([src_w - boxes[..., 2], boxes[..., 1],
                        src_w - boxes[..., 0], boxes[..., 3]], dim=-1)


def _merge_frame(det_n, det_f, proto_n, proto_f, params: PostprocessParams,
                 match_iou: float) -> torch.Tensor:
    """One frame's consensus mask words from its two decoded views."""
    spec = params.spec
    table_n = cropped_prob_table(proto_n, det_n["coef"], spec)
    table_f = cropped_prob_table(proto_f, det_f["coef"], spec).flip(-1)
    boxes_f = flip_boxes(det_f["boxes"], float(spec.src_w))
    iou = iou_2d_matrix(det_n["boxes"], boxes_f)                  # (D, D)
    iou = torch.where(det_f["det_valid"][None, :], iou, 0.0)
    best = iou.argmax(dim=1)
    matched = (iou.amax(dim=1) >= match_iou) & det_n["det_valid"]
    table = torch.where(matched[:, None, None],
                        0.5 * (table_n + table_f[best]), table_n)
    return _finish_masks(table, det_n["boxes"], det_n["det_valid"], params)


def postprocess_tta(outputs, params: PostprocessParams,
                    match_iou: float = 0.5) -> Dict[str, torch.Tensor]:
    """Consensus detections of a batch from one forward over both views:
    raw outputs of 2B frames (levels (2B, h, w, C)), the B frames first
    and their horizontal mirrors after them.  Returns boxes / scores /
    det_valid of the normal view and ``mask_bits`` (B, H0, W0) int32."""
    b = outputs["proto"].shape[0] // 2
    det = postprocess_batch(outputs, params, masks=False)
    det_n = {k: v[:b] for k, v in det.items()}
    det_f = {k: v[b:] for k, v in det.items()}
    bits = [
        _merge_frame({k: v[i] for k, v in det_n.items()},
                     {k: v[i] for k, v in det_f.items()},
                     outputs["proto"][i], outputs["proto"][b + i], params,
                     match_iou)
        for i in range(b)]
    return {"boxes": det_n["boxes"], "scores": det_n["scores"],
            "det_valid": det_n["det_valid"], "mask_bits": torch.stack(bits)}


def postprocess_tta_pair(out_n, out_f, params: PostprocessParams,
                         match_iou: float = 0.5) -> Dict[str, torch.Tensor]:
    """One frame from its two views' raw outputs (levels (h, w, C), no
    batch axis; ``out_f`` is the view of the horizontally flipped source
    image): the serving schema of ``postprocess_single`` with
    ``mask_bits`` from the consensus table."""
    pair = lambda a, b: torch.stack([a, b])
    both = {k: [pair(x, y) for x, y in zip(v, out_f[k])]
            if isinstance(v, list) else pair(v, out_f[k])
            for k, v in out_n.items()}
    out = postprocess_tta(both, params, match_iou)
    return {k: v[0] for k, v in out.items()}
