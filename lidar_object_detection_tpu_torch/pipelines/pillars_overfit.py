"""PointPillars overfit run: the front-sector grid on single sweeps.

    python -m lidar_object_detection_tpu_torch.pipelines.pillars_overfit \\
        [steps] [out.json] --dataset=ROOT [--subsample=0] [--fade=1.0]
        [--no-augment] [--frames=4] [--lr=2e-3] [--device=cuda|cpu]

Counterpart of ``examples/train_pointpillars_overfit.py``, with its flags,
defaults, printed lines and report.  The first ``--frames`` frames with
boxes, each its own sweep, their boxes brought into the velodyne frame by
``transform_corners`` and ``corners_to_boxes7``; the default
``PillarsConfig()`` grid; GT-paste for the first ``fade`` of the steps,
then global augmentation (none with ``--no-augment``); ``--subsample``
points a frame (0: the full scans, up to ``ShapeConfig.max_points``);
AdamW at ``cosine_decay_schedule(lr, steps, alpha=0.05)``; after every 500
steps the evaluation on the full clean frames (rotated-NMS decode, exact
BEV IoU 0.5), one entry of ``out.json``.  The loop, its producer thread
and the evaluation are :mod:`.pillars_surround`'s; the batches are drawn
from ``default_rng(1)``.  It runs on the card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

from lidar_object_detection_tpu_torch.config import ShapeConfig
from lidar_object_detection_tpu_torch.data.kitti360 import Kitti360Dataset
from lidar_object_detection_tpu_torch.geom.boxes import transform_corners
from lidar_object_detection_tpu_torch.models.pointpillars import (
    PillarsConfig, PillarsTrainer, corners_to_boxes7)
from lidar_object_detection_tpu_torch.models.pointpillars.augment import (
    GtDatabase, augment_frame, global_augment)
from lidar_object_detection_tpu_torch.parallel.optim import (
    cosine_decay_schedule)
from lidar_object_detection_tpu_torch.pipelines import cli
from lidar_object_detection_tpu_torch.pipelines import pillars_surround as ps
from lidar_object_detection_tpu_torch.pipelines import pointpillars as pp


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m lidar_object_detection_tpu_torch.pipelines."
             "pillars_overfit", description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=4000)
    ap.add_argument("out", nargs="?", default=os.path.join(
        tempfile.gettempdir(), "pp_overfit.json"))
    cli.common_flags(ap)
    ap.add_argument("--subsample", type=int, default=0,
                    help="points a frame a step; 0 = the full scans")
    ap.add_argument("--fade", type=float, default=1.0,
                    help="the share of the steps with GT-paste")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--no-augment", action="store_true")
    ap.add_argument("--lr", type=float, default=2e-3)
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    cli.require_dataset(ap, args)
    steps, subsample = args.steps, args.subsample
    use_augment = not args.no_augment
    cfg = PillarsConfig()
    t0 = time.time()
    report = {"chunks": [], "config": {
        "steps": steps, "subsample": subsample, "fade": args.fade,
        "augment": use_augment, "frames": args.frames,
        "lr_peak": args.lr}}

    shapes = ShapeConfig()
    ds = Kitti360Dataset(args.dataset, shapes=shapes)
    records = ds.load_frames(None, require_image=False)[:args.frames]
    cam_to_velo = torch.from_numpy(
        ds.transforms.cam_to_velo.astype(np.float32))
    frames = []
    for rec in records:
        corners_velo = transform_corners(
            torch.from_numpy(rec.corners_cam0.astype(np.float32)),
            cam_to_velo)
        boxes7 = corners_to_boxes7(corners_velo).numpy().astype(np.float32)
        frames.append((rec.points.astype(np.float32), boxes7.reshape(-1, 7)))
    db = GtDatabase.build(frames) if use_augment else None
    p_max = subsample if subsample else shapes.max_points

    schedule = cosine_decay_schedule(args.lr, max(steps, 1), alpha=0.05)
    trainer = PillarsTrainer(cfg, learning_rate=schedule,
                             device=args.device)
    n = len(frames)
    # full-resolution clean frames: recall is not judged on a subsampled
    # cloud even when training subsamples
    e_pts, e_pv, e_gt, _, e_gv = pp.pack_frames(frames, shapes.max_points,
                                                pp.MAX_GT)
    e_pts = torch.from_numpy(e_pts).to(trainer.device)
    e_pv = torch.from_numpy(e_pv).to(trainer.device)
    fade_step = int(steps * args.fade)

    prng = np.random.default_rng(1)

    def make(s: int):
        sel = [int(prng.integers(n)) for _ in range(ps.FRAMES_PER_STEP)]
        paste_db = db if s < fade_step else None
        batch = ps.empty_batch(len(sel), p_max)
        for j, i in enumerate(sel):
            p, bx = frames[i]
            if paste_db is not None:
                room = max(0, pp.MAX_GT - bx.shape[0])
                p, bx = augment_frame(p, bx, paste_db, prng,
                                      max_samples=min(12, room))
            elif use_augment:
                p, bx = global_augment(p, bx, prng)
            if len(p) > p_max:
                p = p[prng.choice(len(p), p_max, replace=False)]
            ps.put_frame(batch, j, p, bx)
        return batch

    producer = ps.Producer(make, 0, steps)
    try:
        ps.run_chunks(trainer, producer, 0, steps, t0, report, args.out,
                      lambda: ps.evaluate(trainer, cfg, e_pts, e_pv, e_gt,
                                          e_gv))
    finally:
        producer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
