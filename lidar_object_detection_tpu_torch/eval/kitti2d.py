"""KITTI (not 360) 2D detection evaluation: the ObjectDetection_YOLO
subproject (ObjectDetection_final.py).

Counterpart of ``lidar_object_detection_tpu/eval/kitti2d.py``.  Host-side
float64 numpy, as the reference's numpy computes it:

* 2D IoU matching of detections to GT labels at IoU > 0.5
  (ObjectDetection_final.py:168-233): the reference walks the detections
  and takes the FIRST GT with IoU > threshold (``break`` at :233),
  counting one TP per detection -- replicated, including the quirk that
  one GT box can be counted by several detections;
* the monocular ground-plane distance from the intrinsics
  (``calculate_distance_aligned``, :80-112): the minimum over the 4
  corners and 4 edge midpoints of sqrt(X^2 + h^2 + Y^2) with
  Y = h * fy / (v - cy) (infinite where v == cy), X = (u - cx) * Y / fx,
  camera height 1.65 m; a probe whose distance is not finite (0 * inf)
  counts as infinite;
* precision and recall from TP / FP / FN (:237-241).

The IoU matrix is the port's ``geom.boxes.iou_2d_matrix`` on float64
tensors.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from lidar_object_detection_tpu_torch.geom.boxes import iou_2d_matrix


def _intrinsics(intrinsics):
    k = np.asarray(intrinsics, np.float64)
    return k[0, 0], k[1, 1], k[0, 2], k[1, 2]


def _distance(us, vs, fx, fy, cx, cy, camera_height):
    dv = vs - cy
    with np.errstate(divide="ignore", invalid="ignore"):
        y = np.where(dv == 0, np.inf, camera_height * fy / dv)
        x = (us - cx) * y / fx
        dist = np.sqrt(x * x + camera_height * camera_height + y * y)
    return np.where(np.isfinite(dist), dist, np.inf)


def monocular_distance(intrinsics, boxes, camera_height: float = 1.65):
    """Ground-plane distance per (..., 4) xyxy box: the minimum over 8
    probe points (4 corners and 4 edge midpoints)."""
    fx, fy, cx, cy = _intrinsics(intrinsics)
    boxes = np.asarray(boxes, np.float64)
    x_min, y_min, x_max, y_max = (boxes[..., 0], boxes[..., 1],
                                  boxes[..., 2], boxes[..., 3])
    xm = (x_min + x_max) / 2
    ym = (y_min + y_max) / 2
    us = np.stack([x_min, x_max, x_max, x_min, xm, x_max, xm, x_min], -1)
    vs = np.stack([y_min, y_min, y_max, y_max, y_min, ym, y_max, ym], -1)
    return np.min(_distance(us, vs, fx, fy, cx, cy, camera_height), axis=-1)


def monocular_distance_bottom_center(intrinsics, boxes,
                                     camera_height: float = 1.65):
    """The earlier single-probe variant (Final1.py:57-74): the point
    (box centre x, y_max) only."""
    fx, fy, cx, cy = _intrinsics(intrinsics)
    boxes = np.asarray(boxes, np.float64)
    u = (boxes[..., 0] + boxes[..., 2]) / 2
    return _distance(u, boxes[..., 3], fx, fy, cx, cy, camera_height)


@dataclasses.dataclass
class MatchRecord:
    car_id: int
    det_box: np.ndarray
    gt_box: np.ndarray
    iou: float
    yolo_distance: float
    gt_distance: float


@dataclasses.dataclass
class ImageEvaluation:
    matches: List[MatchRecord]
    tp: int
    fp: int
    fn: int

    @property
    def precision(self) -> float:
        return self.tp / (self.tp + self.fp) if self.tp + self.fp > 0 else 0.0

    @property
    def recall(self) -> float:
        return self.tp / (self.tp + self.fn) if self.tp + self.fn > 0 else 0.0

    def result_lines(self) -> List[str]:
        """The ``results_<name>.txt`` lines (ObjectDetection_final.py:194)."""
        lines = []
        for m in self.matches:
            det = [int(x) for x in m.det_box]
            gt = [int(x) for x in m.gt_box]
            lines.append(
                f"CAR ID: {m.car_id}, YOLO distance: {m.yolo_distance:.2f}m, "
                f"GT distance: {m.gt_distance:.2f}m, "
                f"IoU Between YoloBB {det} and GT_BB {gt}: {m.iou:.2f}")
        return lines


def evaluate_image(det_boxes, gt_boxes, gt_distances, intrinsics,
                   iou_threshold: float = 0.5,
                   camera_height: float = 1.65) -> ImageEvaluation:
    """One image's detections against its GT labels.

    Args:
      det_boxes: (N, 4) int xyxy detections (class- and conf-filtered).
      gt_boxes: (M, 4) int xyxy ground-truth boxes.
      gt_distances: (M,) GT distances (the labels' last column).
      intrinsics: (3, 3) camera matrix.
    """
    det_boxes = np.asarray(det_boxes, dtype=np.float64).reshape(-1, 4)
    gt_boxes = np.asarray(gt_boxes, dtype=np.float64).reshape(-1, 4)
    gt_distances = np.asarray(gt_distances, dtype=np.float64).reshape(-1)

    matches: List[MatchRecord] = []
    tp = 0
    if len(det_boxes) and len(gt_boxes):
        iou = iou_2d_matrix(torch.from_numpy(det_boxes),
                            torch.from_numpy(gt_boxes)).numpy()
        dists = monocular_distance(intrinsics, det_boxes, camera_height)
        for d in range(len(det_boxes)):
            over = np.nonzero(iou[d] > iou_threshold)[0]
            if len(over) == 0:
                continue
            g = int(over[0])   # first match + break, as the reference
            tp += 1
            matches.append(MatchRecord(
                car_id=tp, det_box=det_boxes[d], gt_box=gt_boxes[g],
                iou=float(iou[d, g]), yolo_distance=float(dists[d]),
                gt_distance=float(gt_distances[g])))
    fp = len(det_boxes) - tp
    fn = len(gt_boxes) - tp
    return ImageEvaluation(matches=matches, tp=tp, fp=fp, fn=fn)
