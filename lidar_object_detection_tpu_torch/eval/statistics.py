"""Per-car point statistics.

Counterpart of ``lidar_object_detection_tpu/eval/statistics.py`` (its
``CarStatistics``, ``frame_statistics`` and ``summarize``), kept as its
own copy: the per-car rows of ``calculate_car_point_statistics``
(cvs_erosion.py:165-229) and the V2 summary aggregates (V2:406-443).
``matched_bbox_id`` indexes the visibility-filtered box list, as the
reference scripts compact the list before matching.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class CarStatistics:
    """One row of the master CSV."""

    frame: int
    car_id: int
    matched_bbox_id: int
    total_points: int
    points_inside_bbox: int
    points_outside_bbox: int
    inside_percentage: float
    outside_percentage: float

    @property
    def is_matched(self) -> bool:
        return self.matched_bbox_id >= 0


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def frame_statistics(frame_id: int, total_points, best_box, points_inside,
                     matched, det_valid, box_visible) -> List[CarStatistics]:
    """Per-car rows of one frame's fused outputs.  Cars with zero points
    are skipped (cvs_erosion.py:178-179); unmatched cars get 0 inside and
    100 % outside (cvs_erosion.py:216-225)."""
    total_points = _host(total_points)
    best_box = _host(best_box)
    points_inside = _host(points_inside)
    matched = _host(matched)
    det_valid = _host(det_valid)
    box_visible = _host(box_visible)
    filtered_pos = np.cumsum(box_visible) - 1

    rows: List[CarStatistics] = []
    for car_idx in range(total_points.shape[0]):
        if not det_valid[car_idx]:
            continue
        total = int(total_points[car_idx])
        if total == 0:
            continue
        if matched[car_idx]:
            inside = int(points_inside[car_idx])
            outside = total - inside
            bbox_id = int(filtered_pos[best_box[car_idx]])
            inside_pct = inside / total * 100.0
        else:
            inside = 0
            outside = total
            bbox_id = -1
            inside_pct = 0.0
        rows.append(CarStatistics(
            frame=frame_id, car_id=car_idx, matched_bbox_id=bbox_id,
            total_points=total, points_inside_bbox=inside,
            points_outside_bbox=outside,
            inside_percentage=round(inside_pct, 2),
            outside_percentage=round(100.0 - inside_pct
                                     if matched[car_idx] else 100.0, 2)))
    return rows


def summarize(rows: Sequence[CarStatistics]) -> dict:
    """The V2 summary table aggregates (V2:406-443)."""
    matched = [r for r in rows if r.is_matched]
    total_points = sum(r.total_points for r in matched)
    total_inside = sum(r.points_inside_bbox for r in matched)
    return {
        "total_cars": len(rows),
        "matched": len(matched),
        "unmatched": len(rows) - len(matched),
        "total_points": total_points,
        "total_inside": total_inside,
        "total_outside": total_points - total_inside,
        "avg_inside_pct": (total_inside / total_points * 100.0
                           if total_points else 0.0),
    }
