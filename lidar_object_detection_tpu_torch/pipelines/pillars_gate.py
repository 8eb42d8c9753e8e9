"""PointPillars quality gate: score a checkpoint's recall at the surround
grid.

    python -m lidar_object_detection_tpu_torch.pipelines.pillars_gate \\
        CKPT --dataset ROOT [--head ssd|center] [--frames 4]
        [--eval-frames auto|2903,2939] [--max-points 262144]
        [--protect-in-box 0] [--score-threshold 0.3] [--min-recall 80]
        [--device cuda|cpu]

Counterpart of ``examples/verify_pp_gate.py``, with its flags, JSON line
and exit code: 0 if and only if the matched boxes reach ``--min-recall``
(then ``PASS``, else ``FAIL`` on the standard error).  The checkpoint
(full or slim; its sidecar must name the surround grid and ``--head``)
runs through :func:`.pointpillars.infer_pointpillars` on pose-aggregated
frames, its detections matched by exact BEV IoU 0.5.  By default it scores
the first ``--frames`` frames, the ones the committed checkpoints were
trained on; ``--eval-frames`` scores held-out frames instead (the spatial
split against those training frames) and adds the clean recall over the
held-out boxes outside every training frame's grid.  It runs on the card
unless ``--device cpu`` is given (``--platform`` is the JAX script's
spelling).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from lidar_object_detection_tpu_torch.config import ShapeConfig
from lidar_object_detection_tpu_torch.data.kitti360 import Kitti360Dataset
from lidar_object_detection_tpu_torch.pipelines import cli
from lidar_object_detection_tpu_torch.pipelines import pointpillars as pp


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m lidar_object_detection_tpu_torch.pipelines."
             "pillars_gate", description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt")
    cli.common_flags(ap)
    ap.add_argument("--head", default="ssd", choices=("ssd", "center"))
    ap.add_argument("--frames", type=int, default=4,
                    help="the training frames: the first N (in "
                         "--eval-frames mode the split's training set)")
    ap.add_argument("--eval-frames", default=None,
                    help="held-out mode: 'auto' or a comma list; default "
                         "scores the training frames themselves")
    ap.add_argument("--max-points", type=int, default=1 << 18)
    ap.add_argument("--protect-in-box", type=int, default=0,
                    help="GT-aware point-cap protection (points a box) of "
                         "the aggregates; the checkpoint's training value")
    ap.add_argument("--score-threshold", type=float, default=0.3)
    ap.add_argument("--min-recall", type=int, default=80)
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    cli.require_dataset(ap, args)
    cfg = pp.resolve_pillars_config(None, surround=True, head=args.head)
    ds = Kitti360Dataset(args.dataset, shapes=ShapeConfig())
    train_ids = ds.frame_ids()[:args.frames]

    split = None
    if args.eval_frames:
        ev = (None if args.eval_frames == "auto"
              else [int(x) for x in args.eval_frames.split(",")])
        split = pp.spatial_split(ds, eval_frames=ev, grid=cfg.grid,
                                 train_frames=train_ids)
        ids = split.eval
        print(f"held-out eval {ids} vs train {split.train}: "
              f"min separation {split.min_separation_m:.1f} m, "
              f"{split.eval_gt_overlapped}/{split.eval_gt_total} eval GT "
              f"inside a train-frame grid", flush=True)
    else:
        ids = train_ids

    frames = pp.load_aggregated_frames(ds, ids, grid=cfg.grid,
                                       max_points=args.max_points,
                                       protect_in_box=args.protect_in_box)
    dets = pp.infer_pointpillars(
        args.dataset, args.ckpt, frame_ids=ids, cfg=cfg, aggregate=True,
        max_points=args.max_points, protect_in_box=args.protect_in_box,
        score_threshold=args.score_threshold, device=args.device)

    matched = total = ndet = 0
    clean_matched = clean_total = 0
    for fid, det, (_, gt) in zip(ids, dets, frames):
        gt7 = np.asarray(gt, np.float32)
        gv = np.ones(len(gt7), bool)
        # the detections come without padding: every one is valid
        det = dict(det, valid=np.ones(len(det["boxes7"]), bool))
        ev = pp.evaluate_bev(det, gt7, gv, iou_threshold=0.5, exact=True)
        matched += ev.matched
        total += ev.total_gt
        ndet += ev.total_det
        if split is not None:
            clean = ~split.overlap_masks[fid][:len(gt7)]
            clean_total += int(clean.sum())
            clean_matched += int((ev.matched_gt[:len(clean)] & clean).sum())
    out = {"ckpt": args.ckpt, "head": args.head,
           "recall": f"{matched}/{total}",
           "precision": round(matched / max(ndet, 1), 3)}
    if split is not None:
        out.update(mode="heldout", eval_frames=ids,
                   train_frames=split.train,
                   min_separation_m=round(split.min_separation_m, 1),
                   clean_recall=f"{clean_matched}/{clean_total}")
    print(json.dumps(out), flush=True)
    if matched < args.min_recall:
        print(f"FAIL: recall {matched} < {args.min_recall}", file=sys.stderr)
        return 1
    print(f"PASS: recall {matched} >= {args.min_recall}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
