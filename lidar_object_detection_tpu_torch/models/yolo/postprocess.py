"""YOLO decode, NMS and mask assembly on tensors.

Counterpart of ``lidar_object_detection_tpu/models/yolo/postprocess.py``:
letterbox preprocessing, DFL box decoding, the static top-k candidate
gather, greedy NMS, un-letterboxing, and the native-resolution mask
assembly of ultralytics' ``process_mask_native`` (sigmoid(coef @ protos) ->
strip the letterbox padding at proto resolution -> bilinear resize -> crop
to the box -> threshold), emitted as one packed 32-bit word per pixel.

Every decode mode of the JAX ``PostprocessParams`` is served:

* ``mask_upsample="prob"`` (ultralytics) interpolates probabilities;
  ``"logit"`` interpolates the logits and cuts at ``log(t / (1 - t))``,
  rounded to float32 as JAX rounds a weak-typed scalar against a float32
  field;
* ``mask_threshold_mode="absolute"`` cuts every detection at
  ``mask_threshold``; ``"relative"`` at the float32 product
  ``mask_threshold * peak`` of the detection's largest interpolated
  in-box probability (the peak pass of ``ops/mask_assembly.py``);
* the guarded-shrink floor (the committed checkpoints' serving point);
* ``emit_coef`` adds the kept detections' mask coefficients; a network
  with no mask branch (``YoloConfig(segment=False)``) gives zero words.

:func:`mask_prob_fields` and :func:`pack_thresholded_masks` are the dense
probability-field entry points of the JAX module, in plain PyTorch on
either device (JAX computes them in XLA).

The NMS runs kernel K5 (``ops/nms.py``, the counterpart of the JAX
module's ``nms_impl="pallas"``) on CUDA tensors.  The decode runs over a
batch: (B, ...) tensors where the JAX package vmapped a per-frame
function, so the NMS is one launch for the batch, and so is each pass of
the mask assembly: :func:`_finish_masks` takes the batch's (B, D, mh, mw)
tables to the kernels on CUDA tensors (K3 and K2 guarded; the peak pass
and K2 relative; K2 alone otherwise), the stack-free design of
``postprocess.py:400-424`` of the JAX package, and to their plain twins on
CPU tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from lidar_object_detection_tpu_torch.models.yolo.model import (
    REG_MAX, STRIDES)
from lidar_object_detection_tpu_torch.ops import mask_assembly
from lidar_object_detection_tpu_torch.ops.masks import pack_masks
from lidar_object_detection_tpu_torch.ops.nms import nms, nms_plain
from lidar_object_detection_tpu_torch.ops.resize import (
    resize_hw, resize_weight_matrix)


@dataclasses.dataclass(frozen=True)
class LetterboxSpec:
    """Static letterbox geometry (ultralytics ``LetterBox``, ``auto=True``,
    stride 32): scale the long side to ``imgsz``, pad the short side to the
    next stride multiple, split the padding with round(x -/+ 0.1)."""

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
        top = int(round(dh / 2 - 0.1))
        left = int(round(dw / 2 - 0.1))
        return LetterboxSpec(
            src_h=src_h, src_w=src_w, dst_h=new_h + dh, dst_w=new_w + dw,
            scaled_h=new_h, scaled_w=new_w, top=top, left=left, ratio=r)


def letterbox_image(image: torch.Tensor, spec: LetterboxSpec,
                    pad_value: float = 114 / 255) -> torch.Tensor:
    """(..., H0, W0, 3) float in [0, 1] -> (..., dst_h, dst_w, 3)."""
    resized = resize_hw(image, spec.scaled_h, spec.scaled_w)
    out = torch.full((*image.shape[:-3], spec.dst_h, spec.dst_w, 3),
                     pad_value, dtype=image.dtype, device=image.device)
    out[..., spec.top:spec.top + spec.scaled_h,
        spec.left:spec.left + spec.scaled_w, :] = resized
    return out


def _anchors(level_shapes, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchor centres (cell + 0.5) and strides, flattened over levels."""
    points, strides = [], []
    for (h, w), s in zip(level_shapes, STRIDES):
        ys = torch.arange(h, dtype=torch.float32, device=device) + 0.5
        xs = torch.arange(w, dtype=torch.float32, device=device) + 0.5
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        points.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        strides.append(torch.full((h * w,), float(s), device=device))
    return torch.cat(points, 0), torch.cat(strides, 0)


def decode_boxes(box_logits: torch.Tensor, level_shapes) -> torch.Tensor:
    """DFL decode of (..., N, 4 * REG_MAX) logits -> (..., N, 4) xyxy in
    letterbox pixels."""
    shape = box_logits.shape[:-1]
    dist = box_logits.reshape(*shape, 4, REG_MAX).to(torch.float32)
    dist = dist.softmax(dim=-1) @ torch.arange(
        REG_MAX, dtype=torch.float32, device=box_logits.device)   # ltrb
    points, strides = _anchors(level_shapes, box_logits.device)
    lt, rb = dist[..., :2], dist[..., 2:]
    x1y1 = (points - lt) * strides[:, None]
    x2y2 = (points + rb) * strides[:, None]
    return torch.cat([x1y1, x2y2], -1)


def unletterbox_boxes(boxes: torch.Tensor, spec: LetterboxSpec):
    """Letterbox pixels -> source-image pixels, clipped (scale_boxes)."""
    shift = torch.tensor([spec.left, spec.top, spec.left, spec.top],
                         dtype=boxes.dtype, device=boxes.device)
    limit = torch.tensor([spec.src_w, spec.src_h, spec.src_w, spec.src_h],
                         dtype=boxes.dtype, device=boxes.device)
    out = (boxes - shift) / spec.ratio
    return torch.minimum(torch.clamp(out, min=0.0), limit)


@dataclasses.dataclass(frozen=True)
class PostprocessParams:
    """The decode's parameters, validated on construction under the JAX
    package's conditions (``_assemble_masks``, ``postprocess.py:308-357``).

    ``fast_masks`` is accepted and changes nothing: the port assembles in
    exact float32 on both devices, as the JAX package's kernel path does
    "regardless of ``fast``" (the bf16 shortcut only shrinks its XLA
    path's (D, H, W) stack, which the port never builds).  The JAX
    ``mask_assembly`` backend knob is not ported: the port has one
    assembly per device (the kernels on CUDA, their twins on the CPU), so
    there is nothing to choose.
    """

    spec: LetterboxSpec
    conf_threshold: float = 0.25
    iou_threshold: float = 0.7
    class_id: int = 2            # car (V1:57)
    max_candidates: int = 256
    max_detections: int = 32
    # binarization cut of the interpolated field (ultralytics: 0.5)
    mask_threshold: float = 0.5
    # "absolute": one cut for every detection; "relative": threshold x the
    # detection's peak in-box probability (needs mask_upsample="prob")
    mask_threshold_mode: str = "absolute"
    # guarded shrink: a detection whose primary cut keeps fewer than
    # mask_min_pixels pixels serves this lower cut instead; None = off
    mask_threshold_floor: Optional[float] = None
    mask_min_pixels: int = 0
    # "prob": interpolate probabilities (ultralytics); "logit": interpolate
    # logits and cut at logit(mask_threshold)
    mask_upsample: str = "prob"
    # accepted for parity; exact float32 either way (see the docstring)
    fast_masks: bool = False
    # "auto" = kernel K5 (ops/nms.py) on a CUDA tensor and its PyTorch
    # twin on a CPU tensor; "plain" = the twin on any device (the kernel's
    # reference on the card)
    nms_impl: str = "auto"
    # also return the kept detections' mask coefficients ("coef",
    # (B, D, nm)); the serving path never reads them
    emit_coef: bool = False

    def __post_init__(self):
        if self.nms_impl not in ("auto", "plain"):
            raise ValueError(f"nms_impl must be 'auto' or 'plain', got "
                             f"{self.nms_impl!r}")
        upsample, mode = self.mask_upsample, self.mask_threshold_mode
        threshold, floor = self.mask_threshold, self.mask_threshold_floor
        if upsample not in ("prob", "logit"):
            raise ValueError(f"mask_upsample must be 'prob' or 'logit', "
                             f"got {upsample!r}")
        if mode not in ("absolute", "relative"):
            raise ValueError(f"mask_threshold_mode must be 'absolute' or "
                             f"'relative', got {mode!r}")
        if mode == "relative" and upsample != "prob":
            raise ValueError(
                "mask_threshold_mode='relative' needs mask_upsample="
                "'prob': a fraction of the per-instance peak is only "
                "meaningful on the [0, 1] probability field")
        if floor is not None:
            if not floor < threshold:
                raise ValueError(
                    f"mask_threshold_floor ({floor}) must sit below "
                    f"mask_threshold ({threshold}) -- it is the fallback "
                    f"cut for detections the primary cut leaves "
                    f"near-empty")
            if upsample != "prob":
                raise ValueError(
                    "mask_threshold_floor needs mask_upsample='prob' (the "
                    "floor compares on the same probability field)")
            if mode != "absolute":
                raise ValueError(
                    "mask_threshold_floor needs mask_threshold_mode="
                    "'absolute': with a relative primary cut the absolute "
                    "floor can sit ABOVE a soft detection's effective "
                    "cut, shrinking the mask the guard was meant to save")
            if self.mask_min_pixels < 1:
                raise ValueError(
                    f"mask_threshold_floor needs mask_min_pixels >= 1 "
                    f"(got {self.mask_min_pixels}): with no pixel guard "
                    f"the floor can never fire and only doubles the "
                    f"assembly cost")
        if upsample == "logit" and not 0.0 < threshold < 1.0:
            raise ValueError(
                f"logit-space interpolation needs mask_threshold in "
                f"(0, 1), got {threshold} (logit(t) is unbounded at the "
                f"endpoints)")

    @property
    def table_cut(self) -> float:
        """``mask_threshold`` in the table's space: logit(t) for logit
        tables (a float64, rounded to float32 where it meets the table)."""
        t = self.mask_threshold
        if self.mask_upsample == "logit":
            return math.log(t / (1.0 - t))
        return t


def _flatten_levels(levels: List[torch.Tensor]) -> torch.Tensor:
    """[(B, h, w, C), ...] -> (B, sum h*w, C)."""
    return torch.cat([x.reshape(x.shape[0], -1, x.shape[-1])
                      for x in levels], 1)


def nms_candidates(outputs, params: PostprocessParams):
    """The NMS's inputs from a batch of raw outputs: the top-k candidates'
    flat indices (B, K), letterbox boxes (B, K, 4), scores (B, K) and
    confidence mask (B, K)."""
    p = params
    level_shapes = tuple(tuple(b.shape[1:3]) for b in outputs["box"])
    box_flat = _flatten_levels(outputs["box"])
    cls_flat = _flatten_levels(outputs["cls"])
    scores = torch.sigmoid(cls_flat[..., p.class_id].to(torch.float32))
    k = min(p.max_candidates, scores.shape[1])
    # a stable descending sort: equal scores keep the lower index first,
    # as lax.top_k does
    order = torch.sort(scores, dim=1, descending=True, stable=True)[1]
    top_idx = order[:, :k]
    top_scores = torch.gather(scores, 1, top_idx)
    cand_valid = top_scores > p.conf_threshold
    boxes_all = decode_boxes(box_flat, level_shapes)
    boxes_lb = torch.gather(boxes_all, 1, top_idx[..., None].expand(-1, -1, 4))
    return top_idx, boxes_lb, top_scores, cand_valid


def postprocess_batch(outputs, params: PostprocessParams,
                      masks: bool = True) -> Dict[str, torch.Tensor]:
    """Decode a batch of raw network outputs.

    Args:
      outputs: ``Yolo11`` outputs, each level (B, h, w, C); without
        ``coef`` and ``proto`` for a detection-only network.
      params: decode parameters.
      masks: assemble ``mask_bits``; with False, return the kept
        detections' mask coefficients ``coef`` (B, D, nm) instead -- all
        that the TTA merge reads, so it runs no single-view assembly.

    Returns boxes (B, D, 4) xyxy in source pixels, scores (B, D),
    det_valid (B, D), confidence-sorted as at V1:69-72, and ``mask_bits``
    (B, H0, W0) int32 (zeros for a detection-only network) or ``coef``;
    ``coef`` beside ``mask_bits`` too with ``params.emit_coef``.
    """
    p = params
    spec = p.spec
    top_idx, boxes_lb, top_scores, cand_valid = nms_candidates(outputs, p)
    nms_fn = nms if p.nms_impl == "auto" else nms_plain
    keep_idx, keep_valid = nms_fn(boxes_lb, top_scores, cand_valid,
                                  p.iou_threshold, p.max_detections)
    det_boxes_lb = torch.gather(boxes_lb, 1,
                                keep_idx[..., None].expand(-1, -1, 4))
    det_scores = torch.where(keep_valid, torch.gather(top_scores, 1,
                                                      keep_idx), 0.0)
    det_boxes = unletterbox_boxes(det_boxes_lb, spec)
    det_boxes = torch.where(keep_valid[..., None], det_boxes, 0.0)
    out = {"boxes": det_boxes, "scores": det_scores, "det_valid": keep_valid}

    if "coef" not in outputs:
        out["mask_bits"] = torch.zeros(
            (keep_valid.shape[0], spec.src_h, spec.src_w), dtype=torch.int32,
            device=keep_valid.device)
        return out
    coef_flat = _flatten_levels(outputs["coef"])
    nm = coef_flat.shape[-1]
    cand_coef = torch.gather(coef_flat, 1,
                             top_idx[..., None].expand(-1, -1, nm))
    det_coef = torch.gather(cand_coef, 1,
                            keep_idx[..., None].expand(-1, -1, nm))
    if not masks or p.emit_coef:
        out["coef"] = det_coef
    if not masks:
        return out
    out["mask_bits"] = _finish_masks(
        cropped_table(outputs["proto"], det_coef, p), det_boxes, keep_valid,
        p)
    return out


def postprocess_single(outputs, params: PostprocessParams,
                       masks: bool = True) -> Dict[str, torch.Tensor]:
    """One image's outputs (each level (h, w, C), no batch axis) ->
    boxes (D, 4), scores, det_valid and ``mask_bits`` (H0, W0), or
    ``coef`` with ``masks=False``."""
    batched = {k: [x[None] for x in v] if isinstance(v, list) else v[None]
               for k, v in outputs.items()}
    return {k: v[0] for k, v in postprocess_batch(batched, params,
                                                  masks).items()}


def _proto_crop_bounds(mh: int, mw: int, spec: LetterboxSpec):
    """(top, bottom, left, right) of the image content inside the (mh, mw)
    proto grid: scale_masks' letterbox removal at proto resolution."""
    gain = min(mh / spec.src_h, mw / spec.src_w)
    pad_w = (mw - spec.src_w * gain) / 2
    pad_h = (mh - spec.src_h * gain) / 2
    top = int(round(pad_h - 0.1))
    left = int(round(pad_w - 0.1))
    bottom = mh - int(round(pad_h + 0.1))
    right = mw - int(round(pad_w + 0.1))
    return top, bottom, left, right


def _cropped_logits(protos: torch.Tensor, coef: torch.Tensor,
                    spec: LetterboxSpec) -> torch.Tensor:
    mh, mw, _ = protos.shape[-3:]
    logits = torch.einsum("...dn,...hwn->...dhw", coef.to(torch.float32),
                          protos.to(torch.float32))
    top, bottom, left, right = _proto_crop_bounds(mh, mw, spec)
    return logits[..., top:bottom, left:right]


def cropped_prob_table(protos: torch.Tensor, coef: torch.Tensor,
                       spec: LetterboxSpec) -> torch.Tensor:
    """(..., D, mh_c, mw_c) float32 sigmoid tables at proto resolution
    with the letterbox padding stripped, from protos (..., mh, mw, nm) and
    coef (..., D, nm), the leading axes a batch of frames.  Bilinear
    upsampling is linear, so TTA averages these small tables."""
    return torch.sigmoid(_cropped_logits(protos, coef, spec))


def cropped_table(protos: torch.Tensor, coef: torch.Tensor,
                  params: PostprocessParams) -> torch.Tensor:
    """The cropped table the assembly interpolates: probabilities, or
    the logits themselves with ``mask_upsample="logit"``."""
    if params.mask_upsample == "logit":
        return _cropped_logits(protos, coef, params.spec)
    return cropped_prob_table(protos, coef, params.spec)


def mask_prob_fields(protos: torch.Tensor, coef: torch.Tensor,
                     spec: LetterboxSpec) -> torch.Tensor:
    """(..., D, H0, W0) float32 probability fields: the cropped sigmoid
    table resized bilinearly to the source image with the
    ``jax.image.resize`` weights (``ops/resize.py``), before the box crop
    and binarization -- the field the JAX package's prob-space XLA
    assembly thresholds.  The serving path never builds this stack."""
    table = cropped_prob_table(protos, coef, spec)
    mh, mw = table.shape[-2:]
    wh, ww = (torch.from_numpy(resize_weight_matrix(n, m).copy()).to(
        table.device) for n, m in ((mh, spec.src_h), (mw, spec.src_w)))
    rows = torch.einsum("...dhw,hH->...dHw", table, wh)
    return torch.einsum("...dHw,wW->...dHW", rows, ww)


def pack_thresholded_masks(fields: torch.Tensor, boxes: torch.Tensor,
                           det_valid: torch.Tensor, threshold: float,
                           floor: Optional[float] = None,
                           min_pixels: int = 0) -> torch.Tensor:
    """Binarize (..., D, H, W) fields at ``threshold``, crop each to its
    box (..., D, 4), apply the guarded-shrink floor, and pack into
    (..., H, W) int32 words -- the tail of the JAX package's prob-space
    XLA assembly, for callers that build their own fields."""
    h, w = fields.shape[-2:]
    ys = torch.arange(h, dtype=torch.float32, device=fields.device)
    xs = torch.arange(w, dtype=torch.float32, device=fields.device)
    x1, y1, x2, y2 = (e[..., None, None] for e in boxes.unbind(-1))
    in_box = ((xs >= x1) & (xs < x2) & (ys[:, None] >= y1)
              & (ys[:, None] < y2) & det_valid[..., None, None])
    binary = (fields > threshold) & in_box
    if floor is not None:
        low = (fields > floor) & in_box
        keep_hi = binary.sum(dim=(-2, -1)) >= min_pixels
        binary = torch.where(keep_hi[..., None, None], binary, low)
    return pack_masks(binary)


def _finish_masks(table: torch.Tensor, boxes: torch.Tensor,
                  det_valid: torch.Tensor,
                  params: PostprocessParams) -> torch.Tensor:
    """Upsample + threshold + box-crop + bit-pack a batch's cropped tables
    (B, D, mh_c, mw_c), in the space of ``params.mask_upsample``, into
    (B, H0, W0) int32 words: guarded (K3, then K2), relative (the peak
    pass, then K2) or at one cut (K2), each pass one launch on CUDA
    tensors; their twins on CPU tensors."""
    p = params
    h, w = p.spec.src_h, p.spec.src_w
    if p.mask_threshold_mode == "relative":
        return mask_assembly.assemble_masks_relative_batch(
            table, boxes, det_valid, h, w, p.mask_threshold)
    if p.mask_threshold_floor is None:
        return mask_assembly.assemble_masks_batch(table, boxes, det_valid, h,
                                                  w, p.table_cut)
    return mask_assembly.assemble_masks_guarded_batch(
        table, boxes, det_valid, h, w, p.mask_threshold,
        p.mask_threshold_floor, p.mask_min_pixels)
