"""Horizontal-flip test-time augmentation of the seg decode.

Counterpart of ``lidar_object_detection_tpu/models/yolo/tta.py``.  The
network sees the frame and its horizontal mirror; both views are decoded,
and each normal-view detection whose best flipped-view IoU (boxes mapped
back) reaches ``match_iou`` averages the two views' probability tables
before the serving binarization.  Boxes, scores, validity and order stay
the normal view's.

The average happens at proto resolution: bilinear upsampling is linear and
its taps are symmetric, so mirroring the small cropped table's width axis
and averaging it equals averaging the two upsampled fields.  The batch's
tables then go through the shared assembly tail together
(``_finish_masks``: K3 and K2 on CUDA, once each per batch).

Under ``jit`` the JAX package's two single-view mask assemblies are dead
code that XLA drops (``tta.py:92-95``).  Eager PyTorch would run them, so
the views are decoded with ``masks=False``, which returns the mask
coefficients and assembles nothing.  Both views of a batch go through one
decode, 2B frames at once, so the NMS (kernel K5 on CUDA tensors) is one
launch per batch, and the merge runs over all B frames at once; every step
of the decode and the merge is per frame, so this changes no output.
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

__all__ = ["consensus_tables", "flip_boxes", "postprocess_tta",
           "postprocess_tta_pair", "validate_tta_params"]


def flip_boxes(boxes: torch.Tensor, src_w: float) -> torch.Tensor:
    """xyxy boxes in flipped-source pixels -> normal-source pixels."""
    return torch.stack([src_w - boxes[..., 2], boxes[..., 1],
                        src_w - boxes[..., 0], boxes[..., 3]], dim=-1)


def validate_tta_params(params: PostprocessParams) -> None:
    """hflip TTA averages probability tables and binarizes them at one
    absolute cut: reject the decode modes it cannot honour, with the JAX
    package's messages (``tta.py:59-72``)."""
    if params.mask_upsample != "prob":
        raise ValueError(
            "tta='hflip' needs mask_upsample='prob': the consensus "
            "averages per-view probability fields, which has no "
            "logit-space equivalent after the sigmoid")
    if params.mask_threshold_mode != "absolute":
        raise ValueError(
            "tta='hflip' needs mask_threshold_mode='absolute': a "
            "relative cut of an AVERAGED field re-normalizes against a "
            "peak neither view produced")


def consensus_tables(det, protos, params: PostprocessParams,
                     match_iou: float) -> torch.Tensor:
    """(B, D, mh_c, mw_c) consensus tables of a batch from the decode of
    both views (``det`` with ``coef``, 2B frames, the mirrors last) and
    their protos (2B, mh, mw, nm): each normal-view detection whose best
    flipped-view IoU reaches ``match_iou`` averages its table with that
    detection's mirrored one."""
    b = protos.shape[0] // 2
    spec = params.spec
    tables = cropped_prob_table(protos, det["coef"], spec)
    table_n, table_f = tables[:b], tables[b:].flip(-1)
    boxes_f = flip_boxes(det["boxes"][b:], float(spec.src_w))
    iou = iou_2d_matrix(det["boxes"][:b], boxes_f)             # (B, D, D)
    iou = torch.where(det["det_valid"][b:, None, :], iou, 0.0)
    best = iou.argmax(dim=-1)
    matched = (iou.amax(dim=-1) >= match_iou) & det["det_valid"][:b]
    best_f = table_f[torch.arange(b, device=best.device)[:, None], best]
    return torch.where(matched[..., None, None], 0.5 * (table_n + best_f),
                       table_n)


def postprocess_tta(outputs, params: PostprocessParams,
                    match_iou: float = 0.5) -> Dict[str, torch.Tensor]:
    """Consensus detections of a batch from one forward over both views:
    raw outputs of 2B frames (levels (2B, h, w, C)), the B frames first
    and their horizontal mirrors after them.  Returns boxes / scores /
    det_valid of the normal view and ``mask_bits`` (B, H0, W0) int32."""
    validate_tta_params(params)
    if "coef" not in outputs:
        raise ValueError("tta='hflip' needs a segmentation head: the "
                         "consensus is over mask probability fields")
    b = outputs["proto"].shape[0] // 2
    det = postprocess_batch(outputs, params, masks=False)
    table = consensus_tables(det, outputs["proto"], params, match_iou)
    boxes, valid = det["boxes"][:b], det["det_valid"][:b]
    return {"boxes": boxes, "scores": det["scores"][:b], "det_valid": valid,
            "mask_bits": _finish_masks(table, boxes, valid, params)}


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
