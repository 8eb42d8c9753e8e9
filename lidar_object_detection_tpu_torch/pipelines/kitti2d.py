"""KITTI 2D detection evaluation pipeline (ObjectDetection_final.py).

Counterpart of ``lidar_object_detection_tpu/pipelines/kitti2d.py``: runs a
detector over a KITTI_Selection directory, matches detections to the GT
labels at IoU > 0.5, computes monocular distances and precision / recall,
and writes the reference's ``results_<name>.<ext>.txt`` files (writer
format: ObjectDetection_final.py:194-195) and the annotated images.

The default detector is YOLO11x with the detection-only head
(``YoloConfig(segment=False)``) on ``device`` (``cuda`` unless the caller
asks for the CPU): one detector per image shape, random weights from seed
0, as the JAX package's.  Its decode is kernel K5 on the card, one launch
per image.  Annotated images are written in their input's format (PNG or
JPEG, by the extension, as PIL's ``save``) with the port's writers.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional

import numpy as np

from lidar_object_detection_tpu_torch.data.kitti2d import Kitti2DDataset
from lidar_object_detection_tpu_torch.eval.kitti2d import (
    ImageEvaluation, evaluate_image)


@dataclasses.dataclass
class Kitti2DRunResult:
    evaluations: Dict[str, ImageEvaluation]

    @property
    def totals(self) -> dict:
        tp = sum(e.tp for e in self.evaluations.values())
        fp = sum(e.fp for e in self.evaluations.values())
        fn = sum(e.fn for e in self.evaluations.values())
        return {
            "tp": tp, "fp": fp, "fn": fn,
            "precision": tp / (tp + fp) if tp + fp else 0.0,
            "recall": tp / (tp + fn) if tp + fn else 0.0,
        }


def _yolo_detect_fn(conf: float, class_id: int, device="cuda"):
    """image (H, W, 3) uint8 RGB -> (N, 4) int64 xyxy boxes of the valid
    detections (truncated, as the JAX package casts them), from YOLO11x's
    detection head on ``device``; one detector per image shape."""
    from lidar_object_detection_tpu_torch.models.yolo.detector import (
        YoloDetector)
    from lidar_object_detection_tpu_torch.models.yolo.model import (
        YoloConfig)

    cache: Dict[tuple, YoloDetector] = {}

    def detect(image: np.ndarray) -> np.ndarray:
        shape = image.shape[:2]
        if shape not in cache:
            cache[shape] = YoloDetector(
                shape, YoloConfig(segment=False), conf=conf,
                class_id=class_id, device=device)
        out = cache[shape].detect(image[None])
        valid = out["det_valid"][0].cpu().numpy()
        return out["boxes"][0].cpu().numpy()[valid].astype(np.int64)

    return detect


def run_kitti2d_eval(root: str,
                     detect_fn: Optional[Callable[[np.ndarray],
                                                  np.ndarray]] = None,
                     output_dir: Optional[str] = None,
                     conf: float = 0.5, iou_threshold: float = 0.5,
                     camera_height: float = 1.65,
                     class_id: int = 2,
                     write_images: bool = True,
                     device="cuda") -> Kitti2DRunResult:
    """Evaluate every image under ``root``.

    Args:
      detect_fn: image (H, W, 3) uint8 RGB -> (N, 4) int xyxy car boxes,
        already confidence-filtered.  Defaults to the YOLO11x detection
        head on ``device`` with the reference's conf=0.5 / class 2
        settings (:132,141).
      output_dir: when set, ``results_<name>.<ext>.txt`` files are written
        (the reference's lines) and -- unless ``write_images=False`` --
        the annotated images with box and ID / IoU / distance labels
        (ObjectDetection_final.py:166-253), under the input's basename.
      device: where the default detector runs (``cuda`` raises without a
        card).
    """
    from lidar_object_detection_tpu_torch.utils.image import write_image_rgb

    ds = Kitti2DDataset(root)
    if detect_fn is None:
        detect_fn = _yolo_detect_fn(conf, class_id, device)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)

    evaluations: Dict[str, ImageEvaluation] = {}
    for name in ds.sample_names():
        sample = ds.load(name)
        image = ds.read_image(sample)
        det_boxes = detect_fn(image)
        intrinsics = sample.intrinsics
        if intrinsics is None:
            intrinsics = np.eye(3)
        ev = evaluate_image(det_boxes, sample.gt_boxes, sample.gt_distances,
                            intrinsics, iou_threshold, camera_height)
        evaluations[name] = ev
        if output_dir:
            ext = os.path.splitext(sample.image_path)[1].lstrip(".")
            out_path = os.path.join(output_dir, f"results_{name}.{ext}.txt")
            with open(out_path, "w") as f:
                for line in ev.result_lines():
                    f.write(line + "\n")
            if write_images:
                from lidar_object_detection_tpu_torch.viz.overlay import (
                    annotate_kitti2d_image)
                annotated = annotate_kitti2d_image(
                    image, ev.matches, ev.precision, ev.recall)
                write_image_rgb(os.path.join(
                    output_dir, os.path.basename(sample.image_path)),
                    annotated)
    return Kitti2DRunResult(evaluations=evaluations)
