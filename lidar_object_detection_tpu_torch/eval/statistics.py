"""Per-car point statistics and the master-CSV export.

Counterpart of ``lidar_object_detection_tpu/eval/statistics.py``, kept as
its own copy:

* the per-car rows of ``calculate_car_point_statistics``
  (cvs_erosion.py:165-229),
* the master CSV ``frame, car_id, matched_bbox_id, total_points,
  points_inside_bbox, points_outside_bbox, inside_percentage,
  outside_percentage, is_matched, timestamp`` with append-mode writes
  (``append_to_master_csv``, cvs_erosion.py:232-265),
* the whole-run analysis (``analyze_master_csv``, cvs_erosion.py:268-295),
  read with the standard ``csv`` module and numpy where the JAX package
  uses pandas,
* the V2 summary table and its aggregates (V2:406-443).

``matched_bbox_id`` indexes the visibility-filtered box list, as the
reference scripts compact the list before matching.
"""

from __future__ import annotations

import csv
import dataclasses
import datetime
import os
from typing import List, Optional, Sequence

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


CSV_HEADER = ("frame,car_id,matched_bbox_id,total_points,points_inside_bbox,"
              "points_outside_bbox,inside_percentage,outside_percentage,"
              "is_matched,timestamp")


def append_to_master_csv(rows: Sequence[CarStatistics], path: str,
                         timestamp: Optional[str] = None) -> None:
    """Append rows to the master CSV, creating it with a header when absent
    (cvs_erosion.py:257-265).  ``timestamp`` defaults to the current local
    time in ISO format."""
    if not rows:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    ts = timestamp or datetime.datetime.now().isoformat()
    exists = os.path.exists(path)
    with open(path, "a") as f:
        if not exists:
            f.write(CSV_HEADER + "\n")
        for r in rows:
            f.write(f"{r.frame},{r.car_id},{r.matched_bbox_id},"
                    f"{r.total_points},{r.points_inside_bbox},"
                    f"{r.points_outside_bbox},{r.inside_percentage},"
                    f"{r.outside_percentage},{r.is_matched},{ts}\n")


def analyze_master_csv(path: str) -> Optional[dict]:
    """Whole-run aggregates of a master CSV (cvs_erosion.py:268-295), or
    None when the file does not exist."""
    if not os.path.exists(path):
        return None
    with open(path, newline="") as f:
        table = list(csv.DictReader(f))
    frames = np.asarray([int(r["frame"]) for r in table], np.int64)
    is_matched = np.asarray([r["is_matched"] == "True" for r in table])
    total = np.asarray([int(r["total_points"]) for r in table], np.int64)
    inside_pct = np.asarray([float(r["inside_percentage"]) for r in table],
                            np.float64)
    out = {
        "total_frames": int(len(np.unique(frames))),
        "total_detections": int(len(table)),
        "matched": int(is_matched.sum()),
        "unmatched": int((~is_matched).sum()),
        "match_rate": float(is_matched.mean() * 100.0),
    }
    if is_matched.any():
        out.update({
            "avg_points": float(total[is_matched].mean()),
            "avg_inside_pct": float(inside_pct[is_matched].mean()),
            "min_inside_pct": float(inside_pct[is_matched].min()),
            "max_inside_pct": float(inside_pct[is_matched].max()),
        })
    return out


def format_summary_table(rows: Sequence[CarStatistics]) -> str:
    """The V2 summary table, reference formatting (V2:406-443)."""
    lines = ["=" * 60, f"{'SUMMARY STATISTICS':^60}", "=" * 60]
    matched = [r for r in rows if r.is_matched]
    unmatched = [r for r in rows if not r.is_matched]
    lines.append(f"Total cars detected: {len(rows)}")
    lines.append(f"Successfully matched: {len(matched)}")
    lines.append(f"Unmatched: {len(unmatched)}")
    if matched:
        lines.append("")
        lines.append(f"{'Car ID':<8} {'BBox ID':<8} {'Total':<8} "
                     f"{'Inside':<8} {'Outside':<8} {'Inside %':<10}")
        lines.append("-" * 60)
        for r in matched:
            lines.append(f"{r.car_id:<8} {r.matched_bbox_id:<8} "
                         f"{r.total_points:<8} {r.points_inside_bbox:<8} "
                         f"{r.points_outside_bbox:<8} "
                         f"{r.inside_percentage:<10.1f}")
        total = sum(r.total_points for r in matched)
        inside = sum(r.points_inside_bbox for r in matched)
        outside = total - inside
        avg = inside / total * 100 if total else 0.0
        lines.append("-" * 60)
        lines.append(f"{'TOTAL':<8} {'':<8} {total:<8} {inside:<8} "
                     f"{outside:<8} {avg:<10.1f}")
    return "\n".join(lines)
