"""The system under test: the port's ``FusionPipeline`` with the
configuration's detector, driven chunk by chunk as the consumer of
``FusionPipeline.stream`` drives it (``pipelines/runner.py``): detect,
fuse, copy the fused outputs to the host, and one ``frame_statistics``
call per frame.

The pipeline is built over a KITTI-360 tree that holds only the
calibration (``scene.write_calibration``): frames and scans come from
memory, as the stream's producer hands them over.  With ``spans`` the
detector's forward and decode and the pipeline's fusion are timed with
CUDA events, and the rows with the host clock, per chunk.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import scene
from benchmark.harness.traffic import H0, W0, Chunk

FUSED_KEYS = ("total_points", "best_box", "points_inside", "matched",
              "box_visible")
# the kernels of the serving path, each launched once a chunk, and those
# that the path never launches
PATH_KERNELS = ("inside_counts", "mask_assemble", "mask_count", "nms")
OFF_PATH_KERNELS = ("lap", "rotated_nms", "mask_peak", "rotated_iou_pairs")


class Spans:
    """Per-chunk spans: CUDA event pairs, read once the window is over,
    and host-clock milliseconds."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.events: Dict[str, List] = {}
        self.host_ms: Dict[str, List[float]] = {}
        self.active = True

    def wrap(self, name: str, fn):
        def timed(*args, **kwargs):
            if not (self.active and self.cuda):
                return fn(*args, **kwargs)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.setdefault(name, []).append((start, end))
            return out
        return timed

    def host(self, name: str, ms: float) -> None:
        if self.active:
            self.host_ms.setdefault(name, []).append(ms)

    def milliseconds(self) -> Dict[str, List[float]]:
        out = {k: [s.elapsed_time(e) for s, e in v]
               for k, v in self.events.items()}
        out.update(self.host_ms)
        return out


class PortSystem:
    """``step(chunk)`` returns the detections (on the device), the fused
    outputs (on the device and, for ``FUSED_KEYS``, on the host), the
    detections' validity on the host and the rows."""

    def __init__(self, root: str, config: dict, mix: dict, device,
                 workdir: str, spans: Spans = None):
        from lidar_object_detection_tpu_torch.config import (
            FusionConfig, PipelineVersion, ShapeConfig)
        from lidar_object_detection_tpu_torch.data.kitti360 import (
            Kitti360Dataset)
        from lidar_object_detection_tpu_torch.eval.statistics import (
            frame_statistics)
        from lidar_object_detection_tpu_torch.models.yolo.serving import (
            load_serving_checkpoint)
        from lidar_object_detection_tpu_torch.pipelines.runner import (
            FusionPipeline)

        self.device = torch.device(device)
        self._frame_statistics = frame_statistics
        s, f = config["serving"], config["fusion"]
        if f["version"] != "csv_eval":
            raise ValueError(f"fusion version {f['version']!r}: the harness "
                             "drives csv_eval")
        scene.write_calibration(workdir)
        shapes = ShapeConfig(max_points=int(mix["scan"]["slots"]),
                             max_detections=int(s["max_detections"]),
                             max_boxes=int(mix["boxes"]["slots"]),
                             image_height=H0, image_width=W0)
        cfg = FusionConfig(
            version=PipelineVersion.CSV_EVAL, shapes=shapes,
            erosion_enabled=True, depth_min=float(f["depth_min"]),
            depth_max=float(f["depth_max"]), min_points=int(f["min_points"]))
        dtype = {"bfloat16": torch.bfloat16,
                 "float32": torch.float32}[config["dtype"]]
        detector, _, resolved = load_serving_checkpoint(
            os.path.join(root, config["checkpoint"]), (H0, W0),
            scale=config["scale"], conf=s["conf"],
            mask_threshold=s["mask_threshold"],
            mask_threshold_floor=s["mask_threshold_floor"],
            mask_min_pixels=s["mask_min_pixels"], tta=s["tta"],
            max_detections=s["max_detections"], imgsz=s["imgsz"],
            iou=s["iou"], class_id=s["class_id"],
            max_candidates=s["max_candidates"],
            tta_match_iou=s["tta_match_iou"], dtype=dtype,
            fold_weights=bool(config["fold_batchnorm"]), device=self.device)
        for key in ("mask_threshold", "mask_threshold_floor",
                    "mask_min_pixels", "tta"):
            if resolved[key] != s[key]:
                raise ValueError(f"the detector serves {key}="
                                 f"{resolved[key]!r}, the configuration "
                                 f"states {s[key]!r}")
        self.detector = detector
        self.pipe = FusionPipeline(Kitti360Dataset(workdir, shapes=shapes),
                                   cfg, detector, device=self.device)
        self.spans = spans
        if spans is not None:
            detector.forward = spans.wrap("forward", detector.forward)
            detector.decode = spans.wrap("decode", detector.decode)
            self.pipe.fuse = spans.wrap("fusion", self.pipe.fuse)

    def step(self, chunk: Chunk):
        from lidar_object_detection_tpu_torch.data.kitti360 import FrameBatch

        b = chunk.frames
        batch = FrameBatch(frame_ids=np.arange(b, dtype=np.int32),
                           points=chunk.points, point_valid=chunk.point_valid,
                           corners_cam0=chunk.corners,
                           box_valid=chunk.box_valid, image_paths=[None] * b)
        # the body of FusionPipeline.stream's consumer
        detections = self.pipe.detect(None, batch, images=chunk.images)
        fused = self.pipe.fuse(batch, detections)
        fused_np = {k: fused[k].cpu().numpy() for k in FUSED_KEYS}
        det_valid = detections["det_valid"].cpu().numpy()
        t = time.perf_counter()
        rows = [self._frame_statistics(
            i, fused_np["total_points"][i], fused_np["best_box"][i],
            fused_np["points_inside"][i], fused_np["matched"][i],
            det_valid[i], fused_np["box_visible"][i]) for i in range(b)]
        if self.spans is not None:
            self.spans.host("rows", (time.perf_counter() - t) * 1e3)
        return detections, fused, fused_np, det_valid, rows

    @staticmethod
    def launches() -> Dict[str, int]:
        from lidar_object_detection_tpu_torch.ops import kernel_lib
        return dict(kernel_lib.LAUNCHES)

    @staticmethod
    def build_info() -> dict:
        from lidar_object_detection_tpu_torch.ops import kernel_lib
        return {k: v for k, v in kernel_lib.build_info.items()
                if k != "ptxas"}


def row_tuples(rows) -> List[tuple]:
    """The program's ``CarStatistics`` rows as the reference's tuples
    (tuples pass as they are)."""
    return [r if isinstance(r, tuple) else
            (r.frame, r.car_id, r.matched_bbox_id, r.total_points,
             r.points_inside_bbox, r.points_outside_bbox,
             r.inside_percentage, r.outside_percentage) for r in rows]
