"""Detector over fixed-size images: uint8 frames in, fusion-ready
detections out.

Counterpart of ``lidar_object_detection_tpu/models/yolo/detector.py``: the
YOLO11-seg network, the static letterbox geometry and the decode, as
``model.predict(...)`` plays it in the reference (V1:55-93).  The masks
come out as packed 32-bit words per pixel, ready for
``fusion.associate.fuse_frame``.

A float32 detector runs its forward in full float32: cuDNN would
otherwise run float32 convolutions in TF32, which keeps about three
decimal digits, where the JAX package computes in float32.  It pins the
precision for its own forward only and restores the caller's settings.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from lidar_object_detection_tpu_torch.models.common import full_float32
from lidar_object_detection_tpu_torch.models.yolo.model import (
    Yolo11, YoloConfig)
from lidar_object_detection_tpu_torch.models.yolo.postprocess import (
    LetterboxSpec, PostprocessParams, letterbox_image, postprocess_batch)
from lidar_object_detection_tpu_torch.models.yolo.tta import (
    postprocess_tta, validate_tta_params)
from lidar_object_detection_tpu_torch.models.yolo.weights import (
    fold_serving_variables, from_flax_variables)
from lidar_object_detection_tpu_torch.utils import h2d, profiling


class YoloDetector:
    """Detector over (B, H0, W0, 3) uint8 RGB frames.

    Args:
      image_shape: (H0, W0) of the source images (376 x 1408 for KITTI-360).
      cfg: network scale.
      variables: Flax-layout weights (``utils.flax_msgpack`` reads them);
        random weights from ``seed`` when omitted.
      fold_weights: fold BatchNorm into the convs before loading, as the
        serving path does (``weights.fold_serving_variables``).
      mask_upsample, mask_threshold_mode, fast_masks: the decode modes of
        ``postprocess.PostprocessParams``.
      dtype: the network's dtype (bf16 serves on the card).
      tta: "none" or "hflip" (``tta.py``; prob-space, absolute cuts only).
      device: where the network and its outputs live; ``cuda`` raises
        where CUDA is not available.

    ``YoloConfig(segment=False)`` builds the detection-only network, whose
    decode gives zero mask words.
    """

    def __init__(self, image_shape, cfg: YoloConfig = YoloConfig(),
                 variables: Optional[dict] = None, imgsz: int = 640,
                 conf: float = 0.25, iou: float = 0.7, class_id: int = 2,
                 max_detections: int = 32, max_candidates: int = 256,
                 fold_weights: bool = False, mask_threshold: float = 0.5,
                 mask_upsample: str = "prob",
                 mask_threshold_mode: str = "absolute",
                 fast_masks: bool = False,
                 mask_threshold_floor: Optional[float] = None,
                 mask_min_pixels: int = 0, tta: str = "none",
                 tta_match_iou: float = 0.5,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 seed: int = 0):
        if tta not in ("none", "hflip"):
            raise ValueError(f"tta must be 'none' or 'hflip', got {tta!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' was asked for, but CUDA is not "
                               "available; pass device='cpu' to run on the "
                               "CPU")
        self.cfg = cfg
        self.dtype = dtype
        h0, w0 = image_shape
        self.spec = LetterboxSpec.build(h0, w0, imgsz)
        self.params = PostprocessParams(
            spec=self.spec, conf_threshold=conf, iou_threshold=iou,
            class_id=class_id, max_candidates=max_candidates,
            max_detections=max_detections, mask_threshold=mask_threshold,
            mask_upsample=mask_upsample,
            mask_threshold_mode=mask_threshold_mode, fast_masks=fast_masks,
            mask_threshold_floor=mask_threshold_floor,
            mask_min_pixels=mask_min_pixels)
        if tta == "hflip":
            validate_tta_params(self.params)
        self.tta = tta
        self.tta_match_iou = tta_match_iou
        # random weights come from ``seed`` without touching the caller's
        # global generator
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = Yolo11(cfg)
        if variables is not None:
            if fold_weights:
                variables = fold_serving_variables(variables, dtype=dtype)
            model.to(dtype)
            model.load_state_dict(from_flax_variables(variables), strict=True)
        self.model = model.to(device=self.device, dtype=dtype).eval()

    @torch.no_grad()
    def forward(self, images) -> Dict[str, List[torch.Tensor]]:
        """(B, H0, W0, 3) uint8 RGB (numpy or tensor) -> the network's raw
        outputs; with hflip TTA, one forward over both views (2B frames,
        the mirrored views last).  A float32 network runs in full float32
        (:func:`full_float32`).  On the card the frames go through the
        pinned ring of ``utils.h2d``."""
        with profiling.span("detect.upload", self.device,
                            nbytes=images.nbytes):
            imgs, = h2d.upload([images], self.device)
        scope = (full_float32() if self.dtype == torch.float32
                 else contextlib.nullcontext())
        with scope:
            with profiling.span("detect.preprocess", self.device):
                imgs = imgs.to(torch.float32) / 255.0
                if self.tta == "hflip":
                    imgs = torch.cat([imgs, imgs.flip(2)], dim=0)
                x = letterbox_image(imgs, self.spec).to(self.dtype)
            with profiling.span("detect.network", self.device):
                return self.model(x)

    def decode(self, outputs) -> Dict[str, torch.Tensor]:
        """Raw outputs of :meth:`forward` -> detections, on the outputs'
        device: the kernels decode CUDA tensors, the twins CPU tensors."""
        with profiling.span("detect.decode", self.device):
            if self.tta != "hflip":
                return postprocess_batch(outputs, self.params)
            return postprocess_tta(outputs, self.params, self.tta_match_iou)

    @torch.no_grad()
    def detect(self, images) -> Dict[str, torch.Tensor]:
        """(B, H0, W0, 3) uint8 RGB -> boxes (B, D, 4), scores (B, D),
        det_valid (B, D) and mask_bits (B, H0, W0) int32, confidence-sorted
        per frame, on the detector's device."""
        return self.decode(self.forward(images))
