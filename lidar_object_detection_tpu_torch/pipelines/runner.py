"""The fusion pipeline runner: the entry points of the reference scripts.

Counterpart of ``lidar_object_detection_tpu/pipelines/runner.py`` for the
point-count pipelines: V1-V3 and csv_eval (``cvs_erosion.py``), with or
without erosion.  A run loads a KITTI-360 directory (``data/``), detects
(the stub by default, or ``YoloDetector``: kernels K5, K3 and K2 on the
card), fuses on the device (``fusion/associate.py``: kernel K1 on the
card), and formats the per-car rows on the host, appending them to the
master CSV.

Not ported yet (ROADMAP Queue 1 item 6): the V4 greedy-IoU and V5
Hungarian matchers, the streaming path, depth maps and the V2 analysis
cloud.  Asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import torch

from lidar_object_detection_tpu_torch.config import (
    FusionConfig, FusionParams, MatchStrategy, PipelineVersion)
from lidar_object_detection_tpu_torch.data.kitti360 import (
    FrameBatch, Kitti360Dataset)
from lidar_object_detection_tpu_torch.eval import statistics as stats_lib
from lidar_object_detection_tpu_torch.fusion.associate import fuse_batch
from lidar_object_detection_tpu_torch.geom.boxes import transform_corners
from lidar_object_detection_tpu_torch.models.stub import StubDetector

NOT_PORTED = "not ported yet (ROADMAP Queue 1 item 6)"


@dataclasses.dataclass
class FrameResult:
    frame_id: int
    statistics: List[stats_lib.CarStatistics]
    matched_pairs: List[dict]   # {detection, box_index, corners_velo, ...}
    num_detections: int
    num_visible_boxes: int


@dataclasses.dataclass
class RunResult:
    """``frames_per_s`` is end to end: detection (when this run performed
    it) + fusion.  ``fusion_frames_per_s`` covers only the fusion;
    ``detect_s`` is 0.0 when the caller passed the detections."""

    frames: List[FrameResult]
    csv_rows: List[stats_lib.CarStatistics]
    elapsed_s: float            # detect_s + fusion time
    frames_per_s: float         # end to end (same window as elapsed_s)
    detect_s: float = 0.0
    fusion_frames_per_s: float = 0.0

    def summary(self) -> dict:
        return stats_lib.summarize(self.csv_rows)


class FusionPipeline:
    """Dataset -> detector -> fusion on ``device`` -> rows.

    ``device`` defaults to the card and raises when there is none; pass
    ``device="cpu"`` to run the plain twins on the CPU.  A ``YoloDetector``
    passed in must live on the same device.
    """

    def __init__(self, dataset: Kitti360Dataset, config: FusionConfig,
                 detector=None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' was asked for, but CUDA is not "
                               "available; pass device='cpu' to run on the "
                               "CPU")
        if config.match_strategy != MatchStrategy.POINT_COUNT:
            raise NotImplementedError(
                f"match strategy {config.match_strategy.value}: {NOT_PORTED}")
        self.dataset = dataset
        self.config = config
        self.params = FusionParams.from_config(config)
        t = dataset.transforms
        self.detector = detector or StubDetector(
            dataset.camera, max_detections=config.shapes.max_detections,
            depth_range=(0.0, config.depth_max),
            corners_to_cam=t.corners_cam0_to_cam)
        as_dev = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                           device=self.device)
        self._velo_to_rect = as_dev(t.velo_to_rect)
        # GT corners are annotated in cam0; for cam k > 0 they move into the
        # rectified cam-k frame before projection, and corners_to_velo
        # composes back through cam0_to_velo (calib.TransformChain)
        self._corners_to_cam = (None if dataset.camera.cam_id == 0
                                else as_dev(t.corners_cam0_to_cam))
        self._corners_to_velo = as_dev(t.corners_to_velo)
        self._intrinsics = as_dev(dataset.camera.intrinsics)

    def _gt_corners(self, batch: FrameBatch) -> torch.Tensor:
        """Batch GT corners in the configured camera's projection frame."""
        corners = torch.from_numpy(batch.corners_cam0).to(self.device)
        if self._corners_to_cam is not None:
            corners = transform_corners(corners, self._corners_to_cam)
        return corners

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def detect(self, records, batch: FrameBatch) -> Dict[str, torch.Tensor]:
        """Run the detector: the stub reads the frame records, a
        ``YoloDetector`` the batch's images.  Returns tensors on the
        pipeline's device."""
        if isinstance(self.detector, StubDetector):
            out = self.detector.detect_records(records)
        else:
            out = self.detector.detect(self.dataset.load_images(batch))
        return {k: torch.as_tensor(v).to(self.device) for k, v in out.items()}

    def fuse(self, batch: FrameBatch, detections: Dict[str, torch.Tensor]):
        d = self.device
        return fuse_batch(
            torch.from_numpy(batch.points).to(d),
            torch.from_numpy(batch.point_valid).to(d),
            torch.as_tensor(detections["mask_bits"]).to(d),
            torch.as_tensor(detections["det_valid"]).to(d),
            self._gt_corners(batch), torch.from_numpy(batch.box_valid).to(d),
            self._velo_to_rect, self._corners_to_velo, self._intrinsics,
            self.params)

    # ------------------------------------------------------------------
    def run(self, frame_ids: Optional[Sequence[int]] = None,
            master_csv: Optional[str] = None,
            detections: Optional[Dict[str, torch.Tensor]] = None,
            timestamp: Optional[str] = None) -> RunResult:
        """Detect (unless ``detections`` are given), fuse and format the
        frames; append each frame's rows to ``master_csv`` when given, with
        ``timestamp`` (default: the time of each write)."""
        records = self.dataset.load_frames(frame_ids)
        if not records:
            return RunResult([], [], 0.0, 0.0)
        batch = self.dataset.make_batch(records)
        detect_s = 0.0
        if detections is None:
            td = time.perf_counter()
            detections = self.detect(records, batch)
            self._sync()
            detect_s = time.perf_counter() - td

        t0 = time.perf_counter()
        fused = self.fuse(batch, detections)
        self._sync()
        elapsed = time.perf_counter() - t0

        fused_np = {k: fused[k].cpu().numpy() for k in (
            "total_points", "best_box", "points_inside", "matched",
            "box_visible", "corners_velo")}
        det_valid = torch.as_tensor(detections["det_valid"]).cpu().numpy()
        frames: List[FrameResult] = []
        all_rows: List[stats_lib.CarStatistics] = []
        for i, rec in enumerate(records):
            rows = stats_lib.frame_statistics(
                rec.frame_id, fused_np["total_points"][i],
                fused_np["best_box"][i], fused_np["points_inside"][i],
                fused_np["matched"][i], det_valid[i],
                fused_np["box_visible"][i])
            frames.append(FrameResult(
                frame_id=rec.frame_id, statistics=rows,
                matched_pairs=self._matched_pairs(i, det_valid, fused_np),
                num_detections=int(det_valid[i].sum()),
                num_visible_boxes=int(fused_np["box_visible"][i].sum())))
            all_rows.extend(rows)
            if master_csv:
                stats_lib.append_to_master_csv(rows, master_csv, timestamp)
        total = elapsed + detect_s
        fps = len(records) / total if total > 0 else 0.0
        fusion_fps = len(records) / elapsed if elapsed > 0 else 0.0
        return RunResult(frames=frames, csv_rows=all_rows,
                         elapsed_s=total, frames_per_s=fps,
                         detect_s=detect_s, fusion_frames_per_s=fusion_fps)

    def _matched_pairs(self, i, det_valid, fused_np) -> List[dict]:
        """Each matched detection of frame ``i`` with its box, for
        wireframe rendering (V1:400-405)."""
        pairs = []
        for det in range(self.config.shapes.max_detections):
            box = int(fused_np["best_box"][i][det])
            if not det_valid[i][det] or box < 0:
                continue
            pairs.append({
                "detection": det, "box_index": box,
                "corners_velo": fused_np["corners_velo"][i][box],
                "point_count": int(fused_np["points_inside"][i][det])})
        return pairs

    # ------------------------------------------------------------------
    def stream(self, *args, **kwargs):
        """The streaming full-sequence fusion of the JAX package."""
        raise NotImplementedError(f"stream: {NOT_PORTED}")

    def depth_maps(self, *args, **kwargs):
        """Per-car depth maps (seg_with_pointcloud.py)."""
        raise NotImplementedError(f"depth_maps: {NOT_PORTED}")

    def analysis_cloud(self, *args, **kwargs):
        """The V2 per-point bbox-analysis cloud."""
        raise NotImplementedError(f"analysis_cloud: {NOT_PORTED}")


# ---------------------------------------------------------------------------
# Version entry points (reference script equivalents)
# ---------------------------------------------------------------------------

def _make(dataset_root: str, version: PipelineVersion, detector=None,
          device="cuda", **overrides) -> FusionPipeline:
    cfg = FusionConfig.for_version(version)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    ds = Kitti360Dataset(dataset_root, shapes=cfg.shapes)
    return FusionPipeline(ds, cfg, detector, device=device)


def v1_pointwise(dataset_root: str, detector=None, device="cuda",
                 **kw) -> FusionPipeline:
    """V1_BBox_Pointwise_filtering.py equivalent."""
    return _make(dataset_root, PipelineVersion.V1_POINTWISE, detector,
                 device, **kw)


def v2_stats(dataset_root: str, detector=None, device="cuda",
             **kw) -> FusionPipeline:
    """V2_point_cloud_without_erosion.py equivalent."""
    return _make(dataset_root, PipelineVersion.V2_STATS, detector, device,
                 **kw)


def v3_erosion(dataset_root: str, detector=None, device="cuda",
               **kw) -> FusionPipeline:
    """V3_point_cloud_with_erosion.py equivalent."""
    return _make(dataset_root, PipelineVersion.V3_EROSION, detector, device,
                 **kw)


def csv_eval(dataset_root: str, master_csv: str, detector=None,
             device="cuda", timestamp: Optional[str] = None,
             **kw) -> Optional[dict]:
    """cvs_erosion.py equivalent: one run over the directory, the master
    CSV, and the whole-run analysis."""
    pipe = _make(dataset_root, PipelineVersion.CSV_EVAL, detector, device,
                 **kw)
    pipe.run(master_csv=master_csv, timestamp=timestamp)
    return stats_lib.analyze_master_csv(master_csv)
