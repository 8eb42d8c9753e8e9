"""Stub detector: deterministic detections without YOLO weights.

Counterpart of ``lidar_object_detection_tpu/models/stub.py``, the
runner's default detector.  Two modes:

* :meth:`StubDetector.detect_records` renders synthetic detections from
  the projected GT 3D boxes (rectangular masks over the projected extent),
  enough to drive the fusion and evaluation on real scans;
* :meth:`StubDetector.load_recording` replays detections saved to ``.npz``
  by :meth:`StubDetector.save_recording`.

The output has the schema of ``YoloDetector.detect`` as numpy arrays:
``boxes`` (B, D, 4), ``scores`` (B, D), ``det_valid`` (B, D) and
``mask_bits`` (B, H, W), the packed words held as int32 (a bit-identical
view of the JAX package's uint32).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from lidar_object_detection_tpu_torch.data.calib import CameraCalibration
from lidar_object_detection_tpu_torch.data.kitti360 import FrameRecord
from lidar_object_detection_tpu_torch.ops.masks import pack_masks


class StubDetector:
    def __init__(self, camera: CameraCalibration, max_detections: int = 32,
                 depth_range=(0.0, 40.0), min_size: int = 5, pad: int = 0,
                 corners_to_cam: Optional[np.ndarray] = None):
        self.camera = camera
        self.max_detections = max_detections
        self.depth_range = depth_range
        self.min_size = min_size
        self.pad = pad
        # cam0-frame corners -> this camera's projection frame (identity for
        # cam 0); see data.calib.TransformChain.corners_cam0_to_cam
        if corners_to_cam is not None and np.allclose(corners_to_cam,
                                                      np.eye(4)):
            corners_to_cam = None
        self.corners_to_cam = corners_to_cam

    def detect_records(self, records: Sequence[FrameRecord]
                       ) -> Dict[str, np.ndarray]:
        """GT-box-derived synthetic detections for a list of frames."""
        cam = self.camera
        b = len(records)
        d = self.max_detections
        boxes = np.zeros((b, d, 4), np.float32)
        scores = np.zeros((b, d), np.float32)
        det_valid = np.zeros((b, d), bool)
        mask_bits = np.zeros((b, cam.height, cam.width), np.int32)
        for i, rec in enumerate(records):
            planes = np.zeros((d, cam.height, cam.width), bool)
            di = 0
            for corners in rec.corners_cam0:
                if self.corners_to_cam is not None:
                    t = self.corners_to_cam
                    corners = corners @ t[:3, :3].T + t[:3, 3]
                u, v, z = cam.cam2image(corners.T)
                pos = z > 0
                if not pos.any():
                    continue
                zm = z[pos].mean()
                if not (self.depth_range[0] < zm < self.depth_range[1]):
                    continue
                x0 = int(max(u[pos].min() - self.pad, 0))
                x1 = int(min(u[pos].max() + self.pad, cam.width - 1))
                y0 = int(max(v[pos].min() - self.pad, 0))
                y1 = int(min(v[pos].max() + self.pad, cam.height - 1))
                if x1 - x0 < self.min_size or y1 - y0 < self.min_size:
                    continue
                planes[di, y0:y1 + 1, x0:x1 + 1] = True
                boxes[i, di] = (x0, y0, x1, y1)
                # deterministic pseudo-confidence, descending like the
                # reference's sort by confidence (V1:69-72)
                scores[i, di] = 0.95 - 0.01 * di
                det_valid[i, di] = True
                di += 1
                if di == d:
                    break
            # the planes past the last detection are empty: packing the
            # first di gives the same words
            mask_bits[i] = pack_masks(torch.from_numpy(planes[:di])).numpy()
        return {"boxes": boxes, "scores": scores, "det_valid": det_valid,
                "mask_bits": mask_bits}

    @staticmethod
    def save_recording(path: str, detections: Dict[str, np.ndarray],
                       frame_ids: np.ndarray) -> None:
        np.savez_compressed(path, frame_ids=frame_ids, **detections)

    @staticmethod
    def load_recording(path: str,
                       frame_ids: Optional[Sequence[int]] = None
                       ) -> Dict[str, np.ndarray]:
        """Replay recorded detections, optionally re-ordered to
        ``frame_ids``; packed words come back as int32 whichever of int32
        and uint32 they were saved as."""
        with np.load(path) as data:
            out = {k: data[k] for k in
                   ("boxes", "scores", "det_valid", "mask_bits")}
            recorded = list(data["frame_ids"])
        if out["mask_bits"].dtype == np.uint32:
            out["mask_bits"] = out["mask_bits"].view(np.int32)
        if frame_ids is not None:
            order = [recorded.index(f) for f in frame_ids]
            out = {k: v[order] for k, v in out.items()}
        return out
