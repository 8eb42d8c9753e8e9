"""Diagnose a PointPillars surround checkpoint: where do the misses live?

    python -m lidar_object_detection_tpu_torch.pipelines.pillars_diagnose \\
        [--ckpt=F.msgpack] [--cache=F.npz] [--head=ssd] [--eval-points=N]
        [--device=cuda|cpu]

Counterpart of ``examples/diagnose_pp_ckpt.py``, with its flags and
printed lines.  It restores the full train state that
:mod:`.pillars_surround` saved (``--ckpt``; a slim checkpoint is refused,
as the JAX script's ``from_bytes`` refuses it) into a trainer at
``cosine_decay_schedule(2e-3, 1000)`` (any schedule: its state has the
count leaf the training run's has), runs the eval-mode forward over the
cached aggregated frames (``--cache``, the runner's), decodes at
``max_detections=128`` with the rotated-NMS kernel and prints recall at
score thresholds 0.3, 0.1, 0.05 by IoU thresholds 0.5, 0.3, 0.1; then,
per ground-truth box binned by distance, the hits (IoU >= 0.5), the near
misses (0.1 <= IoU < 0.5, the exact rotated IoU on the host) and the boxes
holding fewer than 10 points.  ``--subsample`` is accepted for the JAX
command line and changes nothing: the port's network takes any cloud
size.  It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch

from lidar_object_detection_tpu_torch.models.pointpillars import (
    PillarsConfig, PillarsTrainer, decode_predictions)
from lidar_object_detection_tpu_torch.ops.rotated_iou import (
    rotated_iou_matrix_np)
from lidar_object_detection_tpu_torch.parallel.optim import (
    cosine_decay_schedule)
from lidar_object_detection_tpu_torch.pipelines import cli
from lidar_object_detection_tpu_torch.pipelines import pointpillars as pp

MAX_DETECTIONS = 128
BINS = ((0, 20), (20, 40), (40, 60), (60, 80), (80, 150))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m lidar_object_detection_tpu_torch.pipelines."
             "pillars_diagnose", description=__doc__.split("\n\n")[0])
    tmp = tempfile.gettempdir()
    ap.add_argument("--ckpt", default=os.path.join(tmp, "pp_ckpt.msgpack"))
    ap.add_argument("--cache", default=os.path.join(tmp, "pp_frames.npz"))
    ap.add_argument("--subsample", type=int, default=65536,
                    help="no effect (the JAX trainer's point count)")
    ap.add_argument("--head", default="ssd", choices=("ssd", "center"))
    ap.add_argument("--eval-points", type=int, default=1 << 18)
    ap.add_argument("--device", "--platform", dest="device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def in_box_count(pts: np.ndarray, box: np.ndarray) -> int:
    d = pts[:, :2] - box[:2]
    c, si = np.cos(box[6]), np.sin(box[6])
    lx = d[:, 0] * c + d[:, 1] * si
    ly = -d[:, 0] * si + d[:, 1] * c
    return int(np.sum((np.abs(lx) <= box[4] / 2)
                      & (np.abs(ly) <= box[3] / 2)
                      & (pts[:, 2] >= box[2] - box[5] / 2)
                      & (pts[:, 2] <= box[2] + box[5] / 2)))


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    cli.require_device(ap, args)
    cfg = dataclasses.replace(PillarsConfig.kitti360_surround(),
                              head=args.head)
    with np.load(args.cache) as z:
        frames = [(z[f"p{i}"], z[f"b{i}"]) for i in range(int(z["n"]))]
    trainer = PillarsTrainer(cfg, learning_rate=cosine_decay_schedule(
        2e-3, 1000), device=args.device)
    print(f"checkpoint step "
          f"{pp.restore_pillars_checkpoint(args.ckpt, trainer)}")

    e_pts, e_pv, e_gt, _, e_gv = pp.pack_frames(frames, args.eval_points,
                                                pp.MAX_GT)
    out = trainer.apply(e_pts, e_pv)
    n = len(frames)

    def decode(i, score_threshold):
        one = {k: v[i] for k, v in out.items()}
        with torch.no_grad():
            det = decode_predictions(one, cfg,
                                     score_threshold=score_threshold,
                                     rotated_nms=True,
                                     max_detections=MAX_DETECTIONS)
        return {k: v.cpu().numpy() for k, v in det.items()}

    for st in (0.3, 0.1, 0.05):
        dets = [decode(i, st) for i in range(n)]
        for iou_t in (0.5, 0.3, 0.1):
            matched = total = ndet = 0
            for i in range(n):
                r = pp.evaluate_bev(dets[i], e_gt[i], e_gv[i],
                                    iou_threshold=iou_t, exact=True)
                matched += r.matched
                total += r.total_gt
                ndet += r.total_det
            print(f"score>{st} iou>{iou_t}: recall {matched}/{total}, "
                  f"{ndet} detections")

    print("\nper-GT analysis (score>0.1, iou>0.5):")
    rows = []
    for i in range(n):
        det = decode(i, 0.1)
        dboxes = det["boxes7"][det["valid"]]
        gt = e_gt[i][e_gv[i]]
        iou = (rotated_iou_matrix_np(dboxes, gt) if len(dboxes) and len(gt)
               else np.zeros((0, len(gt))))
        best = iou.max(axis=0) if len(dboxes) else np.zeros(len(gt))
        pts = e_pts[i][e_pv[i]]
        for g in range(len(gt)):
            rows.append((float(np.hypot(gt[g, 0], gt[g, 1])),
                         in_box_count(pts, gt[g]), float(best[g])))
    rows.sort()
    for lo, hi in BINS:
        sel = [r for r in rows if lo <= r[0] < hi]
        if not sel:
            continue
        hit = sum(1 for r in sel if r[2] >= 0.5)
        near = sum(1 for r in sel if 0.1 <= r[2] < 0.5)
        empty = sum(1 for r in sel if r[1] < 10)
        print(f"  {lo:3d}-{hi:3d} m: {len(sel):3d} gt, {hit:3d} hit, "
              f"{near:3d} near-miss (0.1<=IoU<0.5), {empty:3d} with <10 pts")
    return 0


if __name__ == "__main__":
    sys.exit(main())
