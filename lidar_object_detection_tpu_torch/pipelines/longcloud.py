"""Long-cloud fusion: a multi-sweep aggregate of a million points or more
through the fusion step.

    python -m lidar_object_detection_tpu_torch.pipelines.longcloud \\
        --dataset ROOT [--frame 100] [--sweeps 20] [--iters 5]
        [--min-points 1048576] [--device cuda|cpu]

Counterpart of ``examples/longcloud_demo.py``, with its flags and JSON
line.  The first ``--sweeps`` sweeps are pose-aggregated into
``--frame``'s velodyne coordinates with no point cap (``aggregate_sweeps``;
fewer than ``--min-points`` points refuses), and the whole cloud goes
through ``fuse_frame`` at the ``csv_eval`` settings with the stub
detector's masks for the frame's boxes: one launch of the inside-count
kernel (K1) for the cloud on the card.  After one warm-up call it times
``--iters`` calls (CUDA events on the card, the host clock on the CPU) and
prints the device (on the card its name and power limit) and
``{"metric": "longcloud_fuse_ms_per_cloud", "points", "value_ms",
"points_per_sec" (Mpts/s), "unit", "detections_points"}``, the last the
points that fell in any detection's mask.  It runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from lidar_object_detection_tpu_torch.config import (
    FusionConfig, FusionParams, PipelineVersion)
from lidar_object_detection_tpu_torch.data.kitti360 import Kitti360Dataset
from lidar_object_detection_tpu_torch.data.poses import aggregate_sweeps
from lidar_object_detection_tpu_torch.fusion.associate import fuse_frame
from lidar_object_detection_tpu_torch.models.stub import StubDetector
from lidar_object_detection_tpu_torch.pipelines import cli
from lidar_object_detection_tpu_torch.utils.profiling import (
    device_name, time_calls)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m lidar_object_detection_tpu_torch.pipelines."
             "longcloud", description=__doc__.split("\n\n")[0])
    cli.common_flags(ap)
    ap.add_argument("--frame", type=int, default=100)
    ap.add_argument("--sweeps", type=int, default=20)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--min-points", type=int, default=1 << 20)
    return ap


def fuse_operands(root: str, frame: int, sweeps: int, min_points: int,
                  device="cuda"):
    """The aggregate's ``fuse_frame`` arguments on ``device``, and its
    point count; prints the aggregate's size."""
    cfg = FusionConfig.for_version(PipelineVersion.CSV_EVAL)
    ds = Kitti360Dataset(root, shapes=cfg.shapes)
    ids = ds.frame_ids()[:sweeps]
    agg = aggregate_sweeps(ds, target_frame=frame, source_frames=ids)
    p = len(agg.points)
    if p < min_points:
        raise ValueError(f"the aggregate has only {p} points, fewer than "
                         f"--min-points {min_points}")
    print(f"[longcloud] {p:,} points from {sweeps} sweeps "
          f"({int(agg.point_valid.sum()):,} valid)", flush=True)
    rec = ds.load_frames([frame])[0]
    batch = ds.make_batch([rec])
    det = StubDetector(ds.camera,
                       corners_to_cam=ds.transforms.corners_cam0_to_cam
                       ).detect_records([rec])
    t = ds.transforms
    put = lambda a, dtype=None: torch.as_tensor(a, dtype=dtype).to(device)
    args = (put(agg.points, torch.float32), put(agg.point_valid),
            put(det["mask_bits"][0]), put(det["det_valid"][0]),
            put(batch.corners_cam0[0]), put(batch.box_valid[0]),
            put(t.velo_to_rect, torch.float32),
            put(t.corners_to_velo, torch.float32),
            put(ds.camera.intrinsics, torch.float32),
            FusionParams.from_config(cfg))
    return args, p


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    cli.require_dataset(ap, args)
    operands, p = fuse_operands(args.dataset, args.frame, args.sweeps,
                                args.min_points, args.device)
    with torch.inference_mode():
        out = fuse_frame(*operands)
        total = int(out["total_points"].sum())
        dt = time_calls(lambda: fuse_frame(*operands), args.iters,
                        args.device)
    print(f"[longcloud] {device_name(args.device)}", flush=True)
    print(json.dumps({
        "metric": "longcloud_fuse_ms_per_cloud",
        "points": p,
        "value_ms": round(dt * 1e3, 2),
        "points_per_sec": round(p / dt / 1e6, 1),
        "unit": "Mpts/s",
        "detections_points": total,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
