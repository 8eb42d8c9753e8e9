"""Idempotent, frame-keyed metric store.

Counterpart of ``lidar_object_detection_tpu/eval/store.py``, kept as its
own copy over the port's :mod:`..eval.statistics`.  The reference's master
CSV is blind append-mode: rerunning a frame duplicates its rows
(cvs_erosion.py:260-262; SURVEY.md section 5 calls for "an idempotent
frame-keyed metric store instead of blind CSV append").  This store keys
rows by (frame, car_id): re-processing a frame replaces its rows, making
crash-resume and partial reruns safe, while still exporting the exact
reference CSV schema, byte for byte the JAX package's.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Iterable, List, Optional, Tuple

from lidar_object_detection_tpu_torch.eval.statistics import (
    CSV_HEADER, CarStatistics)


class MetricStore:
    """JSONL-backed store with atomic rewrites and CSV export."""

    def __init__(self, path: str):
        self.path = path
        self._rows: Dict[Tuple[int, int], dict] = {}
        self._load()

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                row = json.loads(line)
                self._rows[(row["frame"], row["car_id"])] = row

    def update_frame(self, frame_id: int, rows: Iterable[CarStatistics],
                     timestamp: Optional[str] = None) -> None:
        """Replace all rows of one frame (idempotent rerun semantics)."""
        import datetime

        ts = timestamp or datetime.datetime.now().isoformat()
        self._rows = {k: v for k, v in self._rows.items()
                      if k[0] != frame_id}
        for r in rows:
            self._rows[(r.frame, r.car_id)] = {
                "frame": r.frame, "car_id": r.car_id,
                "matched_bbox_id": r.matched_bbox_id,
                "total_points": r.total_points,
                "points_inside_bbox": r.points_inside_bbox,
                "points_outside_bbox": r.points_outside_bbox,
                "inside_percentage": r.inside_percentage,
                "outside_percentage": r.outside_percentage,
                "is_matched": r.is_matched, "timestamp": ts,
            }
        self._flush()

    def _flush(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self.path) or ".")
        try:
            with os.fdopen(fd, "w") as f:
                for key in sorted(self._rows):
                    f.write(json.dumps(self._rows[key]) + "\n")
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @property
    def frames(self) -> List[int]:
        return sorted({f for f, _ in self._rows})

    def rows(self) -> List[dict]:
        return [self._rows[k] for k in sorted(self._rows)]

    def export_csv(self, csv_path: str) -> None:
        """Write the reference-schema master CSV (cvs_erosion.py:242-254)."""
        os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
        with open(csv_path, "w") as f:
            f.write(CSV_HEADER + "\n")
            for row in self.rows():
                f.write(f"{row['frame']},{row['car_id']},"
                        f"{row['matched_bbox_id']},{row['total_points']},"
                        f"{row['points_inside_bbox']},"
                        f"{row['points_outside_bbox']},"
                        f"{row['inside_percentage']},"
                        f"{row['outside_percentage']},"
                        f"{row['is_matched']},{row['timestamp']}\n")
