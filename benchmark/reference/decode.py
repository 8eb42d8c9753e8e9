# Adapted from lidar_object_detection_tpu_torch/models/yolo/postprocess.py:56-127,255-274,300-356, models/yolo/tta.py:54-113, ops/resize.py:22-78, ops/nms.py:38-72, ops/masks.py:18-43 and geom/boxes.py:220-236 at 072d88e (dense fields; no kernel).
"""The detector's decode in plain PyTorch, for the benchmark's reference.

Frames in, detections out, as the serving detector plays Ultralytics'
``predict``: the letterbox (bilinear with ``jax.image.resize``'s weights),
the network (:mod:`.yolo`), the DFL box decode, the car class's top-k
candidates by a stable descending sort, greedy NMS, the boxes back in
source pixels, and the masks: ``sigmoid(coef @ protos)`` with the
letterbox stripped at proto resolution, resized to the frame as a dense
(D, H, W) field, cropped to each box, cut at the threshold with the
guarded floor, and packed one 32-bit word per pixel.  With hflip TTA the
frame and its mirror go through the network together, and each detection
whose best mirrored IoU reaches the match IoU averages the two views'
tables before the cut.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch

from benchmark.reference.yolo import REG_MAX, STRIDES


@functools.lru_cache(maxsize=64)
def resize_weight_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of a 1-D bilinear resize, as
    ``jax.image.resize`` builds them (antialiased when shrinking)."""
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :]
               - np.arange(n_in, dtype=np.float64)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(np.abs(total) > eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = np.where(inside[None, :], w, 0.0)
    out = w.astype(np.float32)
    out.flags.writeable = False
    return out


def _weights(n_in, n_out, like):
    return torch.from_numpy(resize_weight_matrix(n_in, n_out).copy()).to(
        device=like.device, dtype=like.dtype)


def resize_hw(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(..., H, W, C) -> (..., out_h, out_w, C), bilinear."""
    h, w = x.shape[-3], x.shape[-2]
    out = x
    if h != out_h:
        out = torch.einsum("...hwc,hH->...Hwc", out, _weights(h, out_h, x))
    if w != out_w:
        out = torch.einsum("...hwc,wW->...hWc", out, _weights(w, out_w, x))
    return out


@dataclasses.dataclass(frozen=True)
class LetterboxSpec:
    """Ultralytics ``LetterBox`` (auto, stride 32) of a source size."""

    src_h: int
    src_w: int
    dst_h: int
    dst_w: int
    scaled_h: int
    scaled_w: int
    top: int
    left: int
    ratio: float

    @staticmethod
    def build(src_h: int, src_w: int, imgsz: int = 640,
              stride: int = 32) -> "LetterboxSpec":
        r = min(imgsz / src_h, imgsz / src_w)
        new_w, new_h = round(src_w * r), round(src_h * r)
        dw = (-new_w) % stride
        dh = (-new_h) % stride
        return LetterboxSpec(
            src_h=src_h, src_w=src_w, dst_h=new_h + dh, dst_w=new_w + dw,
            scaled_h=new_h, scaled_w=new_w, top=int(round(dh / 2 - 0.1)),
            left=int(round(dw / 2 - 0.1)), ratio=r)

    def proto_crop(self, mh: int, mw: int):
        """(top, bottom, left, right) of the image inside the proto grid."""
        gain = min(mh / self.src_h, mw / self.src_w)
        pad_w = (mw - self.src_w * gain) / 2
        pad_h = (mh - self.src_h * gain) / 2
        return (int(round(pad_h - 0.1)), mh - int(round(pad_h + 0.1)),
                int(round(pad_w - 0.1)), mw - int(round(pad_w + 0.1)))


def letterbox(images: torch.Tensor, spec: LetterboxSpec) -> torch.Tensor:
    """(B, H0, W0, 3) float in [0, 1] -> (B, dst_h, dst_w, 3)."""
    resized = resize_hw(images, spec.scaled_h, spec.scaled_w)
    out = torch.full((images.shape[0], spec.dst_h, spec.dst_w, 3),
                     114 / 255, dtype=images.dtype, device=images.device)
    out[:, spec.top:spec.top + spec.scaled_h,
        spec.left:spec.left + spec.scaled_w] = resized
    return out


@dataclasses.dataclass(frozen=True)
class DecodeParams:
    spec: LetterboxSpec
    conf: float = 0.25
    iou: float = 0.7
    class_id: int = 2
    max_candidates: int = 256
    max_detections: int = 32
    mask_threshold: float = 0.5
    mask_floor: Optional[float] = None
    mask_min_pixels: int = 0
    tta: str = "none"
    tta_match_iou: float = 0.5


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) xyxy -> (..., N, M) IoU, 0 where empty."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    iw = torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0],
                                                             b[..., 0])
    ih = torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1],
                                                             b[..., 1])
    inter = torch.where((iw <= 0) | (ih <= 0), torch.zeros_like(iw), iw * ih)
    union = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]) \
        + (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]) - inter
    safe = torch.where(union > 0, union, torch.ones_like(union))
    return torch.where(union > 0, inter / safe, torch.zeros_like(union))


def greedy_nms(boxes, scores, valid, iou_threshold: float, max_out: int):
    """Greedy NMS over (B, N): each step keeps the best live candidate
    (ties to the lowest index) and drops those whose IoU with it is above
    the threshold.  Returns (indices (B, M), keep (B, M))."""
    b, n = scores.shape
    iou = iou_matrix(boxes, boxes)
    live = valid & torch.isfinite(scores)
    neg = torch.tensor(float("-inf"), device=scores.device)
    base = torch.where(live, scores, neg)
    rows = torch.arange(b, device=scores.device)
    cols = torch.arange(n, device=scores.device)
    out_idx = torch.zeros((b, max_out), dtype=torch.int64,
                          device=scores.device)
    out_keep = torch.zeros((b, max_out), dtype=torch.bool,
                           device=scores.device)
    for slot in range(max_out):
        best = torch.where(live, base, neg).argmax(dim=1)
        ok = live[rows, best]
        out_idx[:, slot] = torch.where(ok, best, 0)
        out_keep[:, slot] = ok
        drop = (iou[rows, best] > iou_threshold) | (cols == best[:, None])
        live = torch.where(ok[:, None], live & ~drop, live)
    return out_idx, out_keep


def _flat(levels):
    return torch.cat([x.reshape(x.shape[0], -1, x.shape[-1])
                      for x in levels], 1)


def _anchors(level_shapes, device):
    points, strides = [], []
    for (h, w), s in zip(level_shapes, STRIDES):
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=device) + 0.5,
            torch.arange(w, dtype=torch.float32, device=device) + 0.5,
            indexing="ij")
        points.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        strides.append(torch.full((h * w,), float(s), device=device))
    return torch.cat(points, 0), torch.cat(strides, 0)


def decode_views(outputs, p: DecodeParams) -> Dict[str, torch.Tensor]:
    """Each view's kept detections: boxes (V, D, 4) in source pixels,
    scores, valid, and their mask coefficients (V, D, nm)."""
    level_shapes = [tuple(x.shape[1:3]) for x in outputs["box"]]
    box_flat, cls_flat = _flat(outputs["box"]), _flat(outputs["cls"])
    coef_flat = _flat(outputs["coef"])
    scores = torch.sigmoid(cls_flat[..., p.class_id].float())
    k = min(p.max_candidates, scores.shape[1])
    top = torch.sort(scores, dim=1, descending=True, stable=True)[1][:, :k]
    top_scores = torch.gather(scores, 1, top)
    shape = box_flat.shape[:-1]
    dist = box_flat.reshape(*shape, 4, REG_MAX).float().softmax(-1) \
        @ torch.arange(REG_MAX, dtype=torch.float32, device=scores.device)
    points, strides = _anchors(level_shapes, scores.device)
    boxes_all = torch.cat([(points - dist[..., :2]) * strides[:, None],
                           (points + dist[..., 2:]) * strides[:, None]], -1)
    cand = torch.gather(boxes_all, 1, top[..., None].expand(-1, -1, 4))
    keep_idx, keep = greedy_nms(cand, top_scores, top_scores > p.conf,
                                p.iou, p.max_detections)
    boxes_lb = torch.gather(cand, 1, keep_idx[..., None].expand(-1, -1, 4))
    s = p.spec
    shift = torch.tensor([s.left, s.top, s.left, s.top], dtype=torch.float32,
                         device=scores.device)
    limit = torch.tensor([s.src_w, s.src_h, s.src_w, s.src_h],
                         dtype=torch.float32, device=scores.device)
    boxes = torch.minimum(torch.clamp((boxes_lb - shift) / s.ratio, min=0.0),
                          limit)
    nm = coef_flat.shape[-1]
    coef = torch.gather(coef_flat, 1, top[..., None].expand(-1, -1, nm))
    coef = torch.gather(coef, 1, keep_idx[..., None].expand(-1, -1, nm))
    return {"boxes": torch.where(keep[..., None], boxes, 0.0),
            "scores": torch.where(keep, torch.gather(top_scores, 1,
                                                     keep_idx), 0.0),
            "det_valid": keep, "coef": coef}


def prob_tables(protos, coef, spec: LetterboxSpec) -> torch.Tensor:
    """(V, D, mh_c, mw_c) sigmoid tables, letterbox stripped."""
    mh, mw = protos.shape[1:3]
    top, bottom, left, right = spec.proto_crop(mh, mw)
    logits = torch.einsum("vdn,vhwn->vdhw", coef.float(), protos.float())
    return torch.sigmoid(logits[..., top:bottom, left:right])


def pack_words(masks: torch.Tensor) -> torch.Tensor:
    """(..., D, H, W) bool -> (..., H, W) int32 words, bit d = mask d."""
    d = masks.shape[-3]
    w = torch.ones((), dtype=torch.int64, device=masks.device) << torch.arange(
        d, dtype=torch.int64, device=masks.device)
    words = (masks.to(torch.int64) * w[:, None, None]).sum(dim=-3)
    return (((words + 2 ** 31) % 2 ** 32) - 2 ** 31).to(torch.int32)


def assemble_masks(table, boxes, valid, p: DecodeParams) -> torch.Tensor:
    """One frame: (D, mh_c, mw_c) table -> (H0, W0) int32 words."""
    h, w = p.spec.src_h, p.spec.src_w
    mh, mw = table.shape[-2:]
    wh = _weights(mh, h, table)
    ww = _weights(mw, w, table)
    field = torch.einsum("dHw,wW->dHW",
                         torch.einsum("dhw,hH->dHw", table, wh), ww)
    ys = torch.arange(h, dtype=torch.float32, device=table.device)
    xs = torch.arange(w, dtype=torch.float32, device=table.device)
    x1, y1, x2, y2 = (e[:, None, None] for e in boxes.unbind(-1))
    in_box = ((xs >= x1) & (xs < x2) & (ys[:, None] >= y1)
              & (ys[:, None] < y2) & valid[:, None, None])
    binary = (field > p.mask_threshold) & in_box
    if p.mask_floor is not None:
        low = (field > p.mask_floor) & in_box
        enough = binary.sum(dim=(-2, -1)) >= p.mask_min_pixels
        binary = torch.where(enough[:, None, None], binary, low)
    return pack_words(binary)


def flip_boxes(boxes: torch.Tensor, src_w: float) -> torch.Tensor:
    return torch.stack([src_w - boxes[..., 2], boxes[..., 1],
                        src_w - boxes[..., 0], boxes[..., 3]], dim=-1)


@torch.no_grad()
def detect(model, images: torch.Tensor,
           p: DecodeParams) -> Dict[str, torch.Tensor]:
    """(B, H0, W0, 3) uint8 frames on the model's device -> boxes (B, D,
    4), scores (B, D), det_valid (B, D) and mask_bits (B, H0, W0)."""
    x = images.float() / 255.0
    b = x.shape[0]
    if p.tta == "hflip":
        x = torch.cat([x, x.flip(2)], dim=0)
    outputs = model(letterbox(x, p.spec))
    det = decode_views(outputs, p)
    tables = prob_tables(outputs["proto"], det["coef"], p.spec)
    boxes, valid = det["boxes"][:b], det["det_valid"][:b]
    if p.tta == "hflip":
        mirrored = tables[b:].flip(-1)
        iou = iou_matrix(boxes, flip_boxes(det["boxes"][b:],
                                           float(p.spec.src_w)))
        iou = torch.where(det["det_valid"][b:, None, :], iou, 0.0)
        best = iou.argmax(dim=-1)
        matched = (iou.amax(dim=-1) >= p.tta_match_iou) & valid
        partner = mirrored[torch.arange(b, device=x.device)[:, None], best]
        tables = torch.where(matched[..., None, None],
                             0.5 * (tables[:b] + partner), tables[:b])
    words = torch.stack([assemble_masks(tables[i], boxes[i], valid[i], p)
                         for i in range(b)])
    return {"boxes": boxes, "scores": det["scores"][:b], "det_valid": valid,
            "mask_bits": words}
