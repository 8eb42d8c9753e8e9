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
each.
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

__all__ = ["flip_boxes", "postprocess_tta_pair", "postprocess_tta_batch"]


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


def postprocess_tta_batch(out_n, out_f, params: PostprocessParams,
                          match_iou: float = 0.5) -> Dict[str, torch.Tensor]:
    """Consensus detections of a batch from both views' raw outputs
    (levels (B, h, w, C)); ``out_f`` is the view of the horizontally
    flipped source image.  Returns boxes / scores / det_valid of the
    normal view and ``mask_bits`` (B, H0, W0) int32."""
    det_n = postprocess_batch(out_n, params, masks=False)
    det_f = postprocess_batch(out_f, params, masks=False)
    bits = [
        _merge_frame({k: v[b] for k, v in det_n.items()},
                     {k: v[b] for k, v in det_f.items()},
                     out_n["proto"][b], out_f["proto"][b], params, match_iou)
        for b in range(det_n["boxes"].shape[0])]
    return {"boxes": det_n["boxes"], "scores": det_n["scores"],
            "det_valid": det_n["det_valid"], "mask_bits": torch.stack(bits)}


def postprocess_tta_pair(out_n, out_f, params: PostprocessParams,
                         match_iou: float = 0.5) -> Dict[str, torch.Tensor]:
    """One frame (levels (h, w, C), no batch axis): the serving schema of
    ``postprocess_single`` with ``mask_bits`` from the consensus table."""
    add = lambda o: {k: [x[None] for x in v] if isinstance(v, list)
                     else v[None] for k, v in o.items()}
    out = postprocess_tta_batch(add(out_n), add(out_f), params, match_iou)
    return {k: v[0] for k, v in out.items()}
