"""The reference of a configuration: its checkpoint read by the
reference's own reader, the network in float32 with TF32 off (or, for the
control, rounded to a lower precision), the decode, the fusion and the
rows, in plain PyTorch.  It imports nothing of the program."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from benchmark.reference import decode as dec
from benchmark.reference import fusion as fus
from benchmark.reference.msgpack_reader import read_flax_msgpack
from benchmark.reference.yolo import load_reference

H0, W0 = 376, 1408
# frames a forward of the reference: its float32 activations and dense
# mask fields stay within a few GB on the card
BLOCK = 8


def full_float32() -> None:
    """Convolutions and products in IEEE float32: TF32 off."""
    conv, mm = torch.backends.cudnn.conv, torch.backends.cuda.matmul
    if hasattr(conv, "fp32_precision"):
        conv.fp32_precision = "ieee"
        mm.fp32_precision = "ieee"
    else:
        torch.backends.cudnn.allow_tf32 = False
        mm.allow_tf32 = False


class Reference:
    """``precision`` other than ``"fp32"`` rounds the network's operands
    (:func:`..yolo.round_to`): the control of the comparison."""

    def __init__(self, root: str, config: dict, device,
                 precision: str = "fp32"):
        full_float32()
        self.device = torch.device(device)
        self.config = config
        raw = read_flax_msgpack(os.path.join(root, config["checkpoint"]))
        self.model = load_reference(raw["variables"], config["scale"],
                                    self.device, precision)
        s = config["serving"]
        self.params = dec.DecodeParams(
            spec=dec.LetterboxSpec.build(H0, W0, s["imgsz"]), conf=s["conf"],
            iou=s["iou"], class_id=s["class_id"],
            max_candidates=s["max_candidates"],
            max_detections=s["max_detections"],
            mask_threshold=s["mask_threshold"],
            mask_floor=s["mask_threshold_floor"],
            mask_min_pixels=s["mask_min_pixels"], tta=s["tta"],
            tta_match_iou=s["tta_match_iou"])

    @torch.no_grad()
    def detect(self, images) -> Dict[str, torch.Tensor]:
        """(B, H0, W0, 3) uint8 frames (numpy or tensor) -> detections on
        the reference's device, ``BLOCK`` frames at a time."""
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        parts = [dec.detect(self.model,
                            images[i:i + BLOCK].to(self.device),
                            self.params)
                 for i in range(0, images.shape[0], BLOCK)]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    @torch.no_grad()
    def fuse(self, chunk, mask_bits, det_valid, calib) -> Dict[str, np.ndarray]:
        """The fused outputs of every frame of ``chunk`` (the traffic's
        arrays) with the given masks (B, H0, W0) and detection validity
        (B, D), as numpy arrays with a leading frame axis."""
        velo_to_rect, cam_to_velo, intrinsics = (
            torch.as_tensor(np.asarray(m, np.float32), device=self.device)
            for m in calib)
        f = self.config["fusion"]
        out = []
        for i in range(chunk.frames):
            t = lambda a: torch.as_tensor(np.asarray(a[i]), device=self.device)
            fused = fus.fuse_frame(
                t(chunk.points), t(chunk.point_valid), t(mask_bits),
                t(det_valid), t(chunk.corners), t(chunk.box_valid),
                velo_to_rect, cam_to_velo, intrinsics, width=W0, height=H0,
                depth_min=f["depth_min"], depth_max=f["depth_max"],
                min_points=f["min_points"])
            out.append({k: v.cpu().numpy() for k, v in fused.items()})
        return {k: np.stack([o[k] for o in out]) for k in out[0]}

    @staticmethod
    def rows(fused: Dict[str, np.ndarray], det_valid: np.ndarray):
        """Every frame's per-car rows, frame ids 0 .. B-1."""
        return [fus.frame_rows(i, {k: v[i] for k, v in fused.items()},
                               det_valid[i])
                for i in range(det_valid.shape[0])]
