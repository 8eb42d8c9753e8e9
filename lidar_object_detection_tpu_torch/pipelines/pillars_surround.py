"""PointPillars quality run: the surround grid on multi-sweep clouds.

    python -m lidar_object_detection_tpu_torch.pipelines.pillars_surround \\
        [steps] [out.json] --dataset=ROOT [--subsample=65536] [--fade=0.85]
        [--frames=4] [--lr=2e-3] [--eval-points=262144] [--cache=F.npz]
        [--ckpt=F.msgpack] [--head=ssd|center] [--starve-weight=0]
        [--protect-starved=0] [--eval-frames=auto|2903,2939] [--no-augment]
        [--device=cuda|cpu]

Counterpart of ``examples/train_pointpillars_surround.py``, with its flags,
defaults, printed lines and report.  :meth:`PillarsConfig.
kitti360_surround` (+-102.4 m at 0.32 m pillars), each training frame a
pose-aggregated multi-sweep cloud; GT-paste and global augmentation (only
global augmentation for the last ``1 - fade`` of the run), AdamW at
``cosine_decay_schedule(lr, steps, alpha=0.05)``, a random subsample of
``--subsample`` points a frame each step, 4 frames a step.  After every
500 steps: the checkpoint (``--ckpt``: flax's msgpack of ``(variables,
opt_state, step)`` and its sidecar, which a restart resumes from), then a
full-cloud evaluation (rotated-NMS decode, exact BEV IoU 0.5: recall,
precision, BEV AP; with a split, the clean recall over held-out boxes
outside every training frame's grid), one report entry appended to
``out.json``.

* ``--eval-frames``: a held-out split over every frame with boxes
  (``spatial_split``: "auto" takes the two frames farthest from the rest);
  the GT-paste database holds the training frames only.  Without it the
  first ``--frames`` frames are trained and evaluated (the overfit gate).
* ``--cache``: the aggregated clouds as an ``.npz``, reused when its frame
  ids and ``[eval_points, protect_starved]`` match.
* ``--protect-starved=T``: the points of GT boxes holding at most T points
  are kept by every step's subsample, where the frame is not GT-pasted.

The producer thread makes each step's batch with numpy alone, seeded
``1 + start_step`` (so a resumed run draws other batches than an
uninterrupted one, as the JAX runner does); the main thread moves it to
the card.  Data comes from ``--dataset`` (default ``$LIDAR_TPU_KITTI360``);
with neither, the runner refuses.  It runs on the card unless ``--device
cpu`` is given (``--platform`` is the JAX script's spelling).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import queue
import sys
import tempfile
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from lidar_object_detection_tpu_torch.config import ShapeConfig
from lidar_object_detection_tpu_torch.data.kitti360 import Kitti360Dataset
from lidar_object_detection_tpu_torch.models.pointpillars import (
    PillarsConfig, PillarsTrainer, decode_predictions)
from lidar_object_detection_tpu_torch.models.pointpillars.augment import (
    GtDatabase, augment_frame, global_augment)
from lidar_object_detection_tpu_torch.parallel.optim import (
    cosine_decay_schedule)
from lidar_object_detection_tpu_torch.pipelines import pointpillars as pp
from lidar_object_detection_tpu_torch.pipelines.cli import (
    common_flags, require_dataset)

CHUNK = 500
FRAMES_PER_STEP = 4


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m lidar_object_detection_tpu_torch.pipelines."
             "pillars_surround", description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=8000)
    ap.add_argument("out", nargs="?", default=os.path.join(
        tempfile.gettempdir(), "pp_surround.json"))
    common_flags(ap)
    ap.add_argument("--subsample", type=int, default=65536)
    ap.add_argument("--fade", type=float, default=0.85)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--eval-points", type=int, default=1 << 18)
    ap.add_argument("--cache", default="")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--head", default="ssd", choices=("ssd", "center"))
    ap.add_argument("--starve-weight", type=float, default=0.0)
    ap.add_argument("--eval-frames", default="")
    ap.add_argument("--no-augment", action="store_true")
    ap.add_argument("--protect-starved", type=int, default=0)
    return ap


class Producer:
    """Step batches made ahead on a thread: ``make(s)`` gives step s's
    batch (numpy arrays), steps ``start``..``stop - 1`` in order, at most
    ``depth`` ahead.  :meth:`get` re-raises the thread's error; :meth:`close`
    stops and joins it."""

    def __init__(self, make: Callable, start: int, stop: int,
                 depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        args=(make, start, stop),
                                        daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, make, start, stop):
        try:
            for s in range(start, stop):
                if not self._put(("batch", make(s))):
                    return
        except BaseException as e:      # handed to the consumer, re-raised
            self._put(("error", e))

    def get(self):
        kind, item = self._q.get()
        if kind == "error":
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=60)


def empty_batch(b: int, num_points: int):
    return (np.zeros((b, num_points, 4), np.float32),
            np.zeros((b, num_points), bool),
            np.zeros((b, pp.MAX_GT, 7), np.float32),
            np.zeros((b, pp.MAX_GT), np.int32),
            np.zeros((b, pp.MAX_GT), bool))


def put_frame(batch, j: int, p: np.ndarray, bx: np.ndarray) -> None:
    pts, pv, gt, _, gv = batch
    k = len(p)
    pts[j, :k] = p
    pv[j, :k] = True
    g = min(len(bx), pp.MAX_GT)
    gt[j, :g] = bx[:g]
    gv[j, :g] = True


def evaluate(trainer, cfg, e_pts, e_pv, e_gt, e_gv, split=None,
             eval_ids=None, score_threshold: float = 0.1):
    """The full-cloud evaluation of the runners: the eval-mode forward of
    the whole batch (``e_pts``/``e_pv`` on the trainer's device), the
    rotated-NMS decode and exact BEV IoU at 0.5 per frame.  Returns
    (matched, total_gt, total_det, bev_ap_050, clean) where ``clean`` is
    ``"matched/total"`` over the held-out boxes outside every training
    frame's grid (``split`` given, ``eval_ids`` its frame of each row),
    else None."""
    out = trainer.apply(e_pts, e_pv)
    matched = total_gt = total_det = 0
    clean_matched = clean_total = 0
    dets, gts = [], []
    for i in range(len(e_gt)):
        one = {k: v[i] for k, v in out.items()}
        with torch.no_grad():
            det = decode_predictions(one, cfg,
                                     score_threshold=score_threshold,
                                     rotated_nms=True)
        det = {k: v.cpu().numpy() for k, v in det.items()}
        r = pp.evaluate_bev(det, e_gt[i], e_gv[i], iou_threshold=0.5,
                            exact=True)
        matched += r.matched
        total_gt += r.total_gt
        total_det += r.total_det
        if split is not None:
            # annotation order, MAX_GT-capped
            ov = split.overlap_masks[eval_ids[i]][:pp.MAX_GT]
            clean = e_gv[i].copy()
            clean[:len(ov)] &= ~ov
            clean_total += int(clean.sum())
            clean_matched += int((r.matched_gt & clean).sum())
        ok = det["valid"]
        dets.append((det["boxes7"][ok], det["scores"][ok]))
        gts.append(e_gt[i][e_gv[i]])
    clean = (f"{clean_matched}/{clean_total}" if split is not None
             else None)
    return (matched, total_gt, total_det,
            pp.bev_average_precision(dets, gts), clean)


def run_chunks(trainer, producer: Producer, start_step: int, steps: int,
               t0: float, report: dict, out_path: str,
               evaluate_fn: Callable, save: Optional[Callable] = None
               ) -> None:
    """The runners' loop: ``CHUNK`` steps, the loss printed at step 1 and
    every 50th, then ``save()`` (where given) and ``evaluate_fn()``; its
    entry is printed and appended to ``report``, which is rewritten to
    ``out_path``."""
    step = start_step
    while step < steps:
        losses: List[float] = []
        m = None
        for _ in range(CHUNK):
            m = trainer.train_step(*producer.get())
            step += 1
            if step % 50 == 0 or step == 1:
                loss = float(m["loss"])
                losses.append(loss)
                print(f"step {step}: loss={loss:.4f} "
                      f"({time.time() - t0:.0f}s)", flush=True)
            if step >= steps:
                break
        if not losses:
            losses.append(float(m["loss"]))
        if save is not None:
            save()
        matched, total_gt, total_det, ap, clean = evaluate_fn()
        entry = {"step": step, "loss": losses[-1],
                 "mean_loss": float(np.mean(losses)),
                 "recall": f"{matched}/{total_gt}",
                 "precision": (matched / total_det) if total_det else 0.0,
                 "bev_ap_050": ap,
                 "elapsed_s": round(time.time() - t0, 1)}
        if clean is not None:
            entry["heldout_clean_recall"] = clean
        report["chunks"].append(entry)
        print(json.dumps(entry), flush=True)
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    print("DONE", json.dumps(report["chunks"][-1]), flush=True)


def load_frames(ds, targets, cache_path: str, eval_points: int,
                protect: int, grid):
    """The aggregated (points, boxes7) frames of ``targets``, from the
    ``.npz`` cache where its ids and meta match, else aggregated (and
    cached)."""
    cache_meta = np.asarray([eval_points, protect], np.int64)
    if cache_path and os.path.exists(cache_path):
        with np.load(cache_path) as z:
            ids = list(z["ids"]) if "ids" in z else None
            meta = list(z["meta"]) if "meta" in z else None
            # caches without 'meta' always rebuild (meta is None)
            if ids == targets and meta == list(cache_meta):
                nf = int(z["n"])
                print(f"loaded {nf} cached aggregated frames from "
                      f"{cache_path}", flush=True)
                return [(z[f"p{i}"], z[f"b{i}"]) for i in range(nf)]
        print(f"cache {cache_path} is for frames {ids} meta={meta} (want "
              f"{list(cache_meta)}); rebuilding", flush=True)
    print(f"aggregating {len(ds.frame_ids())} sweeps into {len(targets)} "
          f"target frames...", flush=True)
    frames = pp.load_aggregated_frames(ds, targets, grid=grid,
                                       max_points=eval_points,
                                       protect_in_box=protect)
    if cache_path:
        arrs = {"n": np.int32(len(frames)),
                "ids": np.asarray(targets, np.int64), "meta": cache_meta}
        for i, (p, b) in enumerate(frames):
            arrs[f"p{i}"], arrs[f"b{i}"] = p, b
        np.savez(cache_path, **arrs)
    return frames


def starved_indices(frames, protect: int):
    """Per frame, the indices of its points inside GT boxes that hold at
    most ``protect`` points (an AABB prefilter, then the rotated box), and
    the indices of the rest."""
    prot_idx, rest_idx = [], []
    for (p, bx) in frames:
        keep = []
        for b in np.asarray(bx, np.float32).reshape(-1, 7):
            d0 = p[:, 0] - b[0]
            d1 = p[:, 1] - b[1]
            r = float(np.hypot(b[3], b[4])) / 2
            cand = np.nonzero((np.abs(d0) <= r) & (np.abs(d1) <= r))[0]
            if len(cand) == 0 or len(cand) > 8 * protect:
                continue
            c, si = np.cos(b[6]), np.sin(b[6])
            lx = d0[cand] * c + d1[cand] * si
            ly = -d0[cand] * si + d1[cand] * c
            inb = ((np.abs(lx) <= b[4] / 2) & (np.abs(ly) <= b[3] / 2)
                   & (p[cand, 2] >= b[2] - b[5] / 2)
                   & (p[cand, 2] <= b[2] + b[5] / 2))
            idx = cand[inb]
            if 0 < len(idx) <= protect:
                keep.append(idx)
        pr = (np.unique(np.concatenate(keep)) if keep
              else np.zeros(0, np.int64))
        prot_idx.append(pr)
        rest_idx.append(np.setdiff1d(np.arange(len(p)), pr,
                                     assume_unique=False))
    return prot_idx, rest_idx


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    require_dataset(ap, args)
    steps, out_path, subsample = args.steps, args.out, args.subsample
    protect = args.protect_starved
    cfg = dataclasses.replace(PillarsConfig.kitti360_surround(),
                              head=args.head,
                              starve_weight=args.starve_weight)
    t0 = time.time()
    report = {"chunks": [], "config": {
        "steps": steps, "subsample": subsample, "fade": args.fade,
        "frames": args.frames, "lr_peak": args.lr, "head": args.head,
        "starve_weight": args.starve_weight, "protect_starved": protect,
        "grid": "kitti360_surround"}}
    try:
        with open(out_path) as f:
            report["chunks"] = json.load(f).get("chunks", [])
    except (OSError, ValueError):
        pass

    ds = Kitti360Dataset(args.dataset, shapes=ShapeConfig())
    split = None
    if args.eval_frames:
        ev = (None if args.eval_frames == "auto"
              else [int(x) for x in args.eval_frames.split(",")])
        split = pp.spatial_split(ds, eval_frames=ev, grid=cfg.grid)
        targets = split.train + split.eval
        report["config"]["split"] = split.summary()
        print(f"split: {json.dumps(split.summary())}", flush=True)
    else:
        targets = ds.frame_ids()[:args.frames]
    frames = load_frames(ds, targets, args.cache, args.eval_points, protect,
                         cfg.grid)
    # with a split, training samples only train frames and the evaluation
    # runs only on the held-out tail
    train_idx = list(range(len(split.train) if split else len(frames)))
    eval_idx = (list(range(len(split.train), len(frames))) if split
                else list(range(len(frames))))
    for (p, b) in frames:
        print(f"  {len(p)} pts, {len(b)} gt boxes", flush=True)
    prot_idx = rest_idx = None
    if protect > 0:
        prot_idx, rest_idx = starved_indices(frames, protect)
        print("protect-starved: " + ", ".join(
            f"{len(pr)}/{len(p)}" for pr, (p, _) in zip(prot_idx, frames)),
            flush=True)
    # GT-paste database from train frames only (pasting eval cars into
    # training clouds would leak labels)
    db = GtDatabase.build([frames[i] for i in train_idx])
    print(f"gt database: {len(db)} cut-outs from {len(train_idx)} train "
          f"frames ({time.time() - t0:.0f}s)", flush=True)

    schedule = cosine_decay_schedule(args.lr, max(steps, 1), alpha=0.05)
    trainer = PillarsTrainer(cfg, learning_rate=schedule,
                             device=args.device)
    start_step = 0
    if args.ckpt and os.path.exists(args.ckpt):
        start_step = pp.restore_pillars_checkpoint(args.ckpt, trainer)
        print(f"resumed from {args.ckpt} at step {start_step}", flush=True)

    def save():
        if args.ckpt:
            pp.write_pillars_checkpoint(args.ckpt, trainer, cfg)

    # the clean frames' evaluation batch, on the device once
    e_pts, e_pv, e_gt, _, e_gv = pp.pack_frames(
        [frames[i] for i in eval_idx], args.eval_points, pp.MAX_GT)
    e_pts = torch.from_numpy(e_pts).to(trainer.device)
    e_pv = torch.from_numpy(e_pv).to(trainer.device)
    eval_ids = [targets[i] for i in eval_idx]
    fade_step = int(steps * args.fade)

    prng = np.random.default_rng(1 + start_step)

    def make(s: int):
        sel = [train_idx[int(prng.integers(len(train_idx)))]
               for _ in range(FRAMES_PER_STEP)]
        batch = empty_batch(len(sel), subsample)
        for j, i in enumerate(sel):
            p, bx = frames[i]
            mapping_intact = args.no_augment or s >= fade_step
            if args.no_augment:
                pass
            elif s < fade_step:
                room = max(0, pp.MAX_GT - bx.shape[0])
                p, bx = augment_frame(p, bx, db, prng,
                                      max_samples=min(12, room))
            else:
                p, bx = global_augment(p, bx, prng)
            if len(p) > subsample:
                if (prot_idx is not None and mapping_intact
                        and 0 < len(prot_idx[i]) < subsample):
                    take = subsample - len(prot_idx[i])
                    idx = np.concatenate([
                        prot_idx[i],
                        prng.choice(rest_idx[i], take, replace=False)])
                else:
                    idx = prng.choice(len(p), subsample, replace=False)
                p = p[idx]
            put_frame(batch, j, p, bx)
        return batch

    producer = Producer(make, start_step, steps)
    try:
        run_chunks(trainer, producer, start_step, steps, t0, report,
                   out_path,
                   lambda: evaluate(trainer, cfg, e_pts, e_pv, e_gt, e_gv,
                                    split, eval_ids),
                   save)
    finally:
        producer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
