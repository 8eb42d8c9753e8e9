"""The erosion-vs-no-erosion study, the reference's headline result.

Counterpart of ``lidar_object_detection_tpu/eval/erosion_study.py``, kept
as its own copy.  It reproduces the analysis of
``master_car_statistics.csv.xlsx`` (sheets ``master_car_statistics`` /
``Ero_stats`` / ``Ero_vs_NoERo``; SURVEY.md section 6): run the fusion
twice (eroded / raw masks) on the same detections, join the per-car rows
on (frame, car_id), and compute the workbook's aggregates --

* mean inside-percentage over matched cars of the erosion run
  (reference: 74.48 %, cell G2 of ``Ero_stats``),
* mean per-car relative improvement of erosion over no-erosion
  (reference: +7.67 %, cell G2 of ``Ero_vs_NoERo``; the cached value
  includes a later-deleted F2 cell, reproduced by averaging
  ``pct_improvement`` over ALL joined rows),
* sample std-dev of the per-car inside-percentage difference
  (reference: 5.87, cell E2 of ``Ero_vs_NoERo``, STDEV.S over its A-B
  columns).

Reference numbers come from real yolo11x-seg detections; with the stub
detector the absolute values differ, but the pipeline, join and formulas
are the same.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from lidar_object_detection_tpu_torch.eval.statistics import CarStatistics


@dataclasses.dataclass
class ErosionStudyRow:
    """One matched car present in BOTH runs (xlsx master sheet row)."""

    frame: int
    car_id: int
    total_points_raw: int
    inside_raw: int
    inside_pct_raw: float
    total_points_eroded: int
    inside_eroded: int
    inside_pct_eroded: float

    @property
    def inside_point_diff(self) -> int:
        """Erosion minus no-erosion inside-point count."""
        return self.inside_eroded - self.inside_raw

    @property
    def inside_pct_diff(self) -> float:
        """Erosion minus no-erosion inside-%% (Ero_vs_NoERo col C: =A-B).

        This -- not the point-count difference -- is what the reference
        workbook's 5.87 standard deviation is computed over: recomputing
        STDEV.S over its sheet's A-B columns reproduces E2's cached
        5.869954203375591 exactly (BASELINE.md's row wording is loose).
        """
        return self.inside_pct_eroded - self.inside_pct_raw

    @property
    def pct_improvement(self) -> float:
        """Relative per-car inside-%% improvement (Ero_stats col F)."""
        if self.inside_pct_raw == 0:
            return 0.0
        return ((self.inside_pct_eroded - self.inside_pct_raw)
                / self.inside_pct_raw * 100.0)


@dataclasses.dataclass
class ErosionStudyResult:
    rows: List[ErosionStudyRow]
    mean_inside_pct_eroded: float     # xlsx Ero_vs_NoERo G2
    mean_inside_pct_raw: float
    mean_pct_improvement: float       # xlsx Ero_vs_NoERo G2
    # xlsx Ero_vs_NoERo E2: STDEV.S of the per-car inside-%% difference
    # (erosion - none).  Named *_point_diff historically; verified against
    # the reference workbook to be the PERCENTAGE difference (see
    # ErosionStudyRow.inside_pct_diff).
    std_inside_pct_diff: float

    def summary(self) -> dict:
        return {
            "matched_cars": len(self.rows),
            "mean_inside_pct_eroded": round(self.mean_inside_pct_eroded, 2),
            "mean_inside_pct_raw": round(self.mean_inside_pct_raw, 2),
            "mean_pct_improvement": round(self.mean_pct_improvement, 2),
            "std_inside_pct_diff": round(self.std_inside_pct_diff, 2),
        }


def join_runs(raw_rows: Sequence[CarStatistics],
              eroded_rows: Sequence[CarStatistics]) -> List[ErosionStudyRow]:
    """Join per-car rows of the two runs on (frame, car_id), keeping cars
    MATCHED in both (the xlsx Ero_vs_NoERo sheet keeps 61 of 72 rows)."""
    raw: Dict[Tuple[int, int], CarStatistics] = {
        (r.frame, r.car_id): r for r in raw_rows if r.is_matched}
    out = []
    for e in eroded_rows:
        if not e.is_matched:
            continue
        r = raw.get((e.frame, e.car_id))
        if r is None:
            continue
        out.append(ErosionStudyRow(
            frame=e.frame, car_id=e.car_id,
            total_points_raw=r.total_points,
            inside_raw=r.points_inside_bbox,
            inside_pct_raw=r.inside_percentage,
            total_points_eroded=e.total_points,
            inside_eroded=e.points_inside_bbox,
            inside_pct_eroded=e.inside_percentage))
    return out


def analyze(rows: Sequence[ErosionStudyRow]) -> ErosionStudyResult:
    if not rows:
        return ErosionStudyResult([], 0.0, 0.0, 0.0, 0.0)
    pct_e = np.asarray([r.inside_pct_eroded for r in rows], np.float64)
    pct_r = np.asarray([r.inside_pct_raw for r in rows], np.float64)
    imp = np.asarray([r.pct_improvement for r in rows], np.float64)
    diff = np.asarray([r.inside_pct_diff for r in rows], np.float64)
    std = float(np.std(diff, ddof=1)) if len(rows) > 1 else 0.0
    return ErosionStudyResult(
        rows=list(rows),
        mean_inside_pct_eroded=float(pct_e.mean()),
        mean_inside_pct_raw=float(pct_r.mean()),
        mean_pct_improvement=float(imp.mean()),
        std_inside_pct_diff=std)


def run_erosion_study(dataset_root: str,
                      frame_ids: Optional[Sequence[int]] = None,
                      detector=None,
                      output_csv: Optional[str] = None,
                      output_xlsx: Optional[str] = None,
                      device="cuda") -> ErosionStudyResult:
    """Run the V2 (raw masks) and CSV_EVAL (eroded masks) fusions on one
    set of detections and analyze them (cvs_erosion.py run + xlsx study).
    The fusions run on ``device``; the default detector is the stub."""
    from lidar_object_detection_tpu_torch.config import (
        FusionConfig, PipelineVersion)
    from lidar_object_detection_tpu_torch.data import Kitti360Dataset
    from lidar_object_detection_tpu_torch.pipelines.runner import (
        FusionPipeline)

    cfg_raw = FusionConfig.for_version(PipelineVersion.V2_STATS)
    cfg_ero = FusionConfig.for_version(PipelineVersion.CSV_EVAL)
    ds = Kitti360Dataset(dataset_root, shapes=cfg_raw.shapes)
    pipe_raw = FusionPipeline(ds, cfg_raw, detector, device=device)
    # detect once: the two runs differ only in the erosion flag inside the
    # fusion, so the detections (the expensive half) are shared
    records = ds.load_frames(frame_ids)
    batch = ds.make_batch(records)
    detections = pipe_raw.detect(records, batch)
    raw = pipe_raw.run(frame_ids, detections=detections)
    ero = FusionPipeline(ds, cfg_ero, pipe_raw.detector,
                         device=device).run(frame_ids, detections=detections)
    rows = join_runs(raw.csv_rows, ero.csv_rows)
    result = analyze(rows)
    if output_xlsx:
        from lidar_object_detection_tpu_torch.eval.xlsx import (
            export_erosion_workbook)
        export_erosion_workbook(output_xlsx, raw.csv_rows, ero.csv_rows,
                                result)
    if output_csv:
        os.makedirs(os.path.dirname(output_csv) or ".", exist_ok=True)
        with open(output_csv, "w") as f:
            f.write("frame,car_id,total_points_raw,inside_raw,"
                    "inside_pct_raw,total_points_eroded,inside_eroded,"
                    "inside_pct_eroded,inside_point_diff,pct_improvement\n")
            for r in rows:
                f.write(f"{r.frame},{r.car_id},{r.total_points_raw},"
                        f"{r.inside_raw},{r.inside_pct_raw},"
                        f"{r.total_points_eroded},{r.inside_eroded},"
                        f"{r.inside_pct_eroded},{r.inside_point_diff},"
                        f"{round(r.pct_improvement, 2)}\n")
    return result
