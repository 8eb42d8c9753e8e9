"""Distillation-train YOLO11-seg on a KITTI-360 tree, from labels to a
served checkpoint.

Counterpart of ``examples/train_yolo_distill.py``, the runner that trained
the committed ``checkpoints/yolo11{n,x}_seg_distill.msgpack``.  The
supervision is distilled from the dataset's geometry, with no external
labels: for each GT 3D box, the LiDAR points inside it project onto the
car's visible surface; their raster, closed with a radius scaled by
1 / depth, is the car's instance mask, and the mask's bounding rectangle
its 2D box (class COCO car = 2).

Stages:
  --make-labels   build and cache the labels (npz)
  default         train (checkpoint and loss log; ``--resume`` carries on)
                  then evaluate
  --eval-only     serve the checkpoint through ``YoloDetector`` and score
                  its detections against the labels
  --eval-targets  serve the labels themselves as detections through the
                  erosion study (``examples/eval_distill_targets.py``):
                  the ceiling of the label recipe, no network

    python -m lidar_object_detection_tpu_torch.pipelines.yolo_distill \\
        --dataset ROOT --steps 3000 --ckpt OUT.msgpack --cache LABELS.npz
    python -m lidar_object_detection_tpu_torch.pipelines.yolo_distill \\
        --dataset ROOT --eval-only --ckpt OUT.msgpack
    python -m lidar_object_detection_tpu_torch.pipelines.yolo_distill \\
        --dataset ROOT --eval-targets --cache LABELS.npz

``--dataset`` defaults to ``$LIDAR_TPU_KITTI360``; one of them is
required.  Training runs on the card unless ``--device cpu`` is given.

Under ``torchrun`` (``WORLD_SIZE`` > 1) it trains data parallel over
every rank, as the JAX example trains over ``make_mesh()``: each rank
takes its rows of the batch (the frames divide by the world size), and
the step is the one-card step of the whole batch (:mod:`..parallel.
train`).  Rank 0 alone writes the label cache, the checkpoint and the
evaluation and prints; the others print nothing.  The ranks talk over
NCCL, or over gloo where they outnumber the cards (NCCL refuses two
ranks on one card):

    torchrun --nproc-per-node 2 -m \
        lidar_object_detection_tpu_torch.pipelines.yolo_distill \
        --dataset ROOT --steps 3000 --ckpt OUT.msgpack --cache LABELS.npz

The files are the JAX runner's, byte for byte for the same state:
``OUT.msgpack`` holds ``{variables, step, ema_variables?}``,
``OUT.msgpack.opt`` ``{opt_state}`` (optax's AdamW state as flax's
``to_state_dict`` lays it out) and ``OUT.msgpack.json`` the metadata; both
packages read them.  The labels are the JAX runner's bit for bit
(``scipy.ndimage`` for the morphology and the zoom).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from lidar_object_detection_tpu_torch.data import Kitti360Dataset
from lidar_object_detection_tpu_torch.geom.boxes import (
    points_in_oriented_boxes)
from lidar_object_detection_tpu_torch.models.common import true_div
from lidar_object_detection_tpu_torch.models.stub import StubDetector
from lidar_object_detection_tpu_torch.models.yolo.detector import (
    YoloDetector)
from lidar_object_detection_tpu_torch.models.yolo.model import YoloConfig
from lidar_object_detection_tpu_torch.models.yolo.postprocess import (
    LetterboxSpec, letterbox_image)
from lidar_object_detection_tpu_torch.ops.masks import (
    unpack_masks, wrap_int32)
from lidar_object_detection_tpu_torch.parallel import distributed
from lidar_object_detection_tpu_torch.parallel.mesh import make_mesh
from lidar_object_detection_tpu_torch.parallel.optim import (
    warmup_cosine_decay_schedule)
from lidar_object_detection_tpu_torch.parallel.train import YoloTrainer
from lidar_object_detection_tpu_torch.pipelines import cli
from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
    read_flax_msgpack, write_flax_msgpack)

IMG_H, IMG_W = 376, 1408
IMAGE_SIZE = (192, 640)   # the letterboxed input
MAX_T = 32                # targets a frame (the detector's max_detections)


# ---------------------------------------------------------------------------
# Label distillation (host side, cached)
# ---------------------------------------------------------------------------

def _project_np(points, velo_to_rect, intrinsics):
    """Velodyne points -> rounded pixel (u, v) and depth, in float64 (the
    devkit's rounding and |z| divide)."""
    T = velo_to_rect.astype(np.float64)
    rect = points[:, :3].astype(np.float64) @ T[:3, :3].T + T[:3, 3]
    proj = rect @ intrinsics.astype(np.float64).T
    depth = proj[:, 2].copy()
    depth[depth == 0] = -1e-6
    az = np.abs(depth)
    return np.round(proj[:, 0] / az), np.round(proj[:, 1] / az), depth


def _iou_xyxy(a, b) -> float:
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(x2 - x1, 0) * max(y2 - y1, 0)
    area = ((a[2] - a[0]) * (a[3] - a[1])
            + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / max(area, 1e-9)


def _disk(r: int) -> np.ndarray:
    y, x = np.ogrid[-r:r + 1, -r:r + 1]
    return (x * x + y * y) <= r * r


def _silhouette(us, vs, h, w, radius):
    """Rasterize projected points and close the speckle into a solid
    mask."""
    from scipy import ndimage

    m = np.zeros((h, w), bool)
    m[vs, us] = True
    r = max(int(radius), 1)
    closed = ndimage.binary_closing(
        ndimage.binary_dilation(m, _disk(max(r // 2, 1))), _disk(r))
    return closed | m


def _cached_labels(cache: Optional[str], recipe: np.ndarray):
    if not (cache and os.path.exists(cache)):
        return None
    cached = dict(np.load(cache))
    # a cache of another recipe would skew everything downstream
    if "recipe" in cached and np.array_equal(cached["recipe"], recipe):
        print(f"[labels] cached <- {cache}")
        return cached
    print(f"[labels] cache {cache} has no/other recipe marker; rebuilding")
    return None


def build_labels(root: str, min_points: int = 30, depth_max: float = 50.0,
                 cache: Optional[str] = None, device="cuda"):
    """Distill per-frame supervision from scans and GT 3D boxes; the
    oriented point-in-box tests run on ``device`` (the card unless the
    caller passes ``"cpu"``), the rest on the host.

    Returns a dict of arrays:
      images    (B, 376, 1408, 3) uint8
      boxes     (B, T, 4) xyxy image px (the mask's bounding rectangle)
      boxes_lb  (B, T, 4) xyxy letterbox px
      classes   (B, T) int32 (COCO car = 2)
      valid     (B, T) bool
      masks_img (B, T, 376, 1408) uint8 {0, 1} full-resolution silhouettes
      masks_pr  (B, T, 48, 160) float32 targets at prototype resolution
      frame_ids (B,) int32, and the recipe (min_points, depth_max).
    """
    from scipy import ndimage

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for, but CUDA is not "
                           "available; pass device='cpu' to build the labels "
                           "on the CPU")
    recipe = np.asarray([min_points, depth_max], np.float64)
    cached = _cached_labels(cache, recipe)
    if cached is not None:
        return cached

    ds = Kitti360Dataset(root)
    records = ds.load_frames()
    batch = ds.make_batch(records)
    images = ds.load_images(batch)
    spec = LetterboxSpec.build(IMG_H, IMG_W, 640)
    ph, pw = spec.dst_h // 4, spec.dst_w // 4      # prototype resolution
    t = ds.transforms
    K = ds.camera.intrinsics

    b = len(records)
    out = {
        "images": images.astype(np.uint8),
        "boxes": np.zeros((b, MAX_T, 4), np.float32),
        "boxes_lb": np.zeros((b, MAX_T, 4), np.float32),
        "classes": np.full((b, MAX_T), 2, np.int32),
        "valid": np.zeros((b, MAX_T), bool),
        "masks_img": np.zeros((b, MAX_T, IMG_H, IMG_W), np.uint8),
        "masks_pr": np.zeros((b, MAX_T, ph, pw), np.float32),
        "frame_ids": np.asarray([r.frame_id for r in records], np.int32),
        "recipe": recipe,
    }

    for i, rec in enumerate(records):
        pts = batch.points[i][batch.point_valid[i]]
        u, v, depth = _project_np(pts, t.velo_to_rect, K)
        pvalid = ((u >= 0) & (u < IMG_W) & (v >= 0) & (v < IMG_H)
                  & (depth > 0) & (depth < depth_max))

        corners = rec.corners_cam0                     # (G, 8, 3)
        cv = corners @ t.corners_to_velo[:3, :3].T + t.corners_to_velo[:3, 3]
        pts_dev = torch.from_numpy(pts[:, :3].astype(np.float32)).to(device)

        # nearest boxes first, so that the nearest cars take the MAX_T slots;
        # a box mostly covered by nearer targets, or whose rectangle
        # repeats a taken one, yields no second target for its region
        order = np.argsort([c.mean(0)[0] for c in cv])  # velo x ~ depth
        di = 0
        occupied = np.zeros((IMG_H, IMG_W), bool)
        taken_boxes = []
        for g in order:
            inside = points_in_oriented_boxes(
                pts_dev, torch.from_numpy(
                    cv[g:g + 1].astype(np.float32)).to(device))
            sel = inside[:, 0].cpu().numpy() & pvalid
            if sel.sum() < min_points:
                continue
            us = u[sel].astype(np.int32)
            vs = v[sel].astype(np.int32)
            med_d = float(np.median(depth[sel]))
            radius = np.clip(120.0 / med_d, 2.0, 10.0)
            mask = _silhouette(us, vs, IMG_H, IMG_W, radius)
            ys, xs = np.nonzero(mask)
            x0, x1 = xs.min(), xs.max()
            y0, y1 = ys.min(), ys.max()
            if x1 - x0 < 5 or y1 - y0 < 5:
                continue
            if (mask & occupied).sum() > 0.5 * mask.sum():
                continue
            cand = np.array([x0, y0, x1, y1], np.float32)
            if any(_iou_xyxy(cand, tb) > 0.6 for tb in taken_boxes):
                continue
            occupied |= mask
            taken_boxes.append(cand)
            out["masks_img"][i, di] = mask
            out["boxes"][i, di] = (x0, y0, x1, y1)
            r, left, top = spec.ratio, spec.left, spec.top
            out["boxes_lb"][i, di] = (x0 * r + left, y0 * r + top,
                                      x1 * r + left, y1 * r + top)
            # prototype-resolution target: area-mean downsample, threshold
            zoom = ndimage.zoom(mask.astype(np.float32),
                                (ph * 2 / IMG_H, pw * 2 / IMG_W), order=1)
            zoom = zoom[: ph * 2, : pw * 2]
            pooled = zoom.reshape(ph, 2, pw, 2).mean((1, 3))
            out["masks_pr"][i, di] = (pooled > 0.35).astype(np.float32)
            out["valid"][i, di] = True
            di += 1
            if di == MAX_T:
                break
        print(f"[labels] frame {rec.frame_id}: {di} targets")

    if cache:
        np.savez_compressed(cache, **out)
        print(f"[labels] cached -> {cache}")
    return out


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def save_ckpt(path, variables, opt_state, step, ema_variables=None,
              scale: str = "n"):
    """Write ``path`` ({variables, step, ema_variables?}), ``path.opt``
    ({opt_state}, for resuming) and ``path.json`` (the metadata), as the
    JAX runner writes them.  ``variables`` and ``ema_variables`` are Flax
    trees, ``opt_state`` in :meth:`YoloTrainer.opt_state_dict`'s layout."""
    payload = {"variables": variables, "step": np.asarray(step)}
    if ema_variables is not None:
        payload["ema_variables"] = ema_variables
    write_flax_msgpack(path, payload)
    write_flax_msgpack(path + ".opt", {"opt_state": opt_state})
    with open(path + ".json", "w") as f:
        json.dump({"model": "yolo11-seg", "scale": scale, "num_classes": 80,
                   "image_size": list(IMAGE_SIZE), "step": int(step)}, f)


def load_ckpt_variables(path, prefer_ema: bool = False):
    """(variables, step) of a checkpoint; the EMA copy where asked for and
    present."""
    raw = read_flax_msgpack(path)
    variables = raw["variables"]
    if prefer_ema and raw.get("ema_variables"):
        variables = raw["ema_variables"]
    return variables, int(np.asarray(raw["step"]))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def letterboxed(images, device):
    """(B, 376, 1408, 3) uint8 -> (B, 192, 640, 3) float32 in [0, 1] on
    ``device`` (an IEEE division by 255 on every device)."""
    spec = LetterboxSpec.build(IMG_H, IMG_W, 640)
    imgs = true_div(torch.from_numpy(np.asarray(images)).to(device).float(),
                    255.0)
    return letterbox_image(imgs, spec)


def train(labels, steps: int, lr: float, ckpt: str, scale: str = "n",
          resume: bool = False, log_every: int = 25, save_every: int = 250,
          seed: int = 0, seg_weight: float = 1.0, ema_decay: float = 0.0,
          device="cuda", mesh=None):
    """Train on every frame of ``labels`` as one batch for ``steps``
    steps in all (``resume`` starts from ``ckpt``'s step), AdamW under a
    warm-up and cosine schedule peaking at ``lr``; checkpoints every
    ``save_every`` steps and at the end.  With a ``mesh`` every rank
    calls this, the batch splits over its ``data`` axis and rank 0
    writes the checkpoints.  Returns the trainer."""
    cfg = YoloConfig(scale=scale, num_classes=80, segment=True)
    schedule = warmup_cosine_decay_schedule(
        0.0, lr, min(100, max(steps // 10, 1)), max(steps, 2), lr * 1e-2)
    trainer = YoloTrainer(cfg, image_size=IMAGE_SIZE, max_targets=MAX_T,
                          learning_rate=schedule, seed=seed,
                          seg_weight=seg_weight, ema_decay=ema_decay,
                          device=device, mesh=mesh)

    if resume and os.path.exists(ckpt):
        raw = read_flax_msgpack(ckpt)
        step0 = int(np.asarray(raw["step"]))
        # the saved EMA copy, so that an interrupted --ema-decay run
        # carries on with its average
        trainer.load(raw["variables"], step0, raw.get("ema_variables"))
        if os.path.exists(ckpt + ".opt"):
            trainer.load_opt_state(read_flax_msgpack(ckpt + ".opt")[
                "opt_state"])
        print(f"[train] resumed from {ckpt} at step {step0}")

    images, targets = trainer.put(letterboxed(labels["images"], device), {
        "boxes": labels["boxes_lb"], "classes": labels["classes"],
        "valid": labels["valid"], "masks": labels["masks_pr"]})

    t0 = time.time()
    step0 = trainer.state.step
    for s in range(step0, steps):
        m = trainer.train_step(images, targets)
        if (s + 1) % log_every == 0 or s == step0:
            loss = float(m["loss"])
            parts = {k: round(float(m[k]), 4)
                     for k in ("cls", "box", "dfl", "seg") if k in m}
            dt = (time.time() - t0) / max(s + 1 - step0, 1)
            print(f"[train] step {s + 1}/{steps} loss {loss:.4f} {parts} "
                  f"({dt:.2f}s/step)", flush=True)
        if (s + 1) % save_every == 0 or s + 1 == steps:
            # collective with a mesh: every rank gathers, rank 0 writes
            state = (trainer.variables(), trainer.opt_state_dict(),
                     trainer.ema_variables())
            if distributed.is_primary():
                save_ckpt(ckpt, state[0], state[1], s + 1,
                          ema_variables=state[2], scale=scale)
                print(f"[train] ckpt -> {ckpt} @ {s + 1}", flush=True)
    return trainer


# ---------------------------------------------------------------------------
# Evaluation: serve the checkpoint through the detector
# ---------------------------------------------------------------------------

def evaluate(labels, ckpt: str, scale: str = "n", conf: float = 0.25,
             device="cuda"):
    """Serve ``ckpt`` (its EMA copy where present) through
    ``YoloDetector`` on ``device`` and match its detections to the labels
    at IoU 0.5, greedily in confidence order; prints one JSON line and
    returns (TP, FP, FN)."""
    variables, step = load_ckpt_variables(ckpt, prefer_ema=True)
    det = YoloDetector((IMG_H, IMG_W), YoloConfig(scale=scale),
                       variables=variables, conf=conf,
                       max_detections=MAX_T, device=device)
    out = det.detect(labels["images"])
    boxes = out["boxes"].cpu().numpy()
    dvalid = out["det_valid"].cpu().numpy()
    mask_bits = out["mask_bits"].cpu()

    tp = fp = fn = 0
    mask_ious = []
    for i in range(len(labels["images"])):
        gt = labels["boxes"][i][labels["valid"][i]]
        gm = labels["masks_img"][i][labels["valid"][i]]
        db = boxes[i][dvalid[i]]
        dm = unpack_masks(mask_bits[i], MAX_T).numpy()[: dvalid[i].sum()]
        used = np.zeros(len(gt), bool)
        for d in range(len(db)):
            x1 = np.maximum(db[d, 0], gt[:, 0])
            y1 = np.maximum(db[d, 1], gt[:, 1])
            x2 = np.minimum(db[d, 2], gt[:, 2])
            y2 = np.minimum(db[d, 3], gt[:, 3])
            inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
            area_d = (db[d, 2] - db[d, 0]) * (db[d, 3] - db[d, 1])
            area_g = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
            iou = inter / np.maximum(area_d + area_g - inter, 1e-9)
            iou[used] = 0
            j = int(np.argmax(iou)) if len(iou) else -1
            if j >= 0 and iou[j] >= 0.5:
                used[j] = True
                tp += 1
                mi = (dm[d] & (gm[j] > 0)).sum() / max(
                    (dm[d] | (gm[j] > 0)).sum(), 1)
                mask_ious.append(float(mi))
            else:
                fp += 1
        fn += int((~used).sum())
    total_gt = tp + fn
    print(json.dumps({
        "ckpt_step": step,
        "detections_tp": tp, "fp": fp, "fn": fn,
        "recall": round(tp / max(total_gt, 1), 4),
        "precision": round(tp / max(tp + fp, 1), 4),
        "mean_mask_iou": round(float(np.mean(mask_ious)), 4)
        if mask_ious else 0.0,
    }), flush=True)
    return tp, fp, fn


# ---------------------------------------------------------------------------
# The supervision ceiling: the labels served as detections
# ---------------------------------------------------------------------------

class TargetOracleDetector:
    """Serves the distilled labels (``build_labels``) as detections, in the
    schema of ``StubDetector.detect_records``: each frame's targets are its
    detections, score 1, their full-resolution silhouettes packed into one
    int32 word per pixel (sums in int64, wrapped: ``ops/masks.py``)."""

    def __init__(self, labels, max_detections: int = MAX_T):
        self.by_frame = {int(f): i for i, f in enumerate(labels["frame_ids"])}
        self.labels = labels
        self.max_detections = max_detections

    def detect_records(self, records):
        lab = self.labels
        b = len(records)
        d = self.max_detections
        h, w = lab["masks_img"].shape[2:]
        boxes = np.zeros((b, d, 4), np.float32)
        scores = np.zeros((b, d), np.float32)
        det_valid = np.zeros((b, d), bool)
        mask_bits = np.zeros((b, h, w), np.int32)
        for i, rec in enumerate(records):
            li = self.by_frame.get(int(rec.frame_id))
            if li is None:
                raise KeyError(
                    f"frame {rec.frame_id} not in the labels cache -- the "
                    "cache was built from a different dataset/frame set; "
                    "delete it and rerun")
            t = min(d, lab["valid"].shape[1])
            valid = lab["valid"][li, :t]
            boxes[i, :t] = lab["boxes"][li, :t]
            det_valid[i, :t] = valid
            scores[i, :t] = np.where(valid, 1.0, 0.0)
            live = np.where(valid, np.int64(1) << np.arange(t), 0)
            words = (lab["masks_img"][li, :t].astype(np.int64)
                     * live[:, None, None]).sum(0)
            mask_bits[i] = wrap_int32(torch.from_numpy(words)).numpy()
        return {"boxes": boxes, "scores": scores, "det_valid": det_valid,
                "mask_bits": mask_bits}


class _OracleStub(StubDetector):
    """The oracle as the runner's stub: the runner hands a
    ``StubDetector`` the frame records (``detect_records``), which is all
    the oracle reads."""

    def __init__(self, inner: TargetOracleDetector):   # no camera needed
        self._inner = inner

    def detect_records(self, records):
        return self._inner.detect_records(records)


def eval_targets(labels, dataset: str, device="cuda"):
    """The erosion study behind the labels themselves; prints the JAX
    example's lines and returns the study."""
    from lidar_object_detection_tpu_torch.eval.erosion_study import (
        run_erosion_study)

    res = run_erosion_study(dataset, detector=_OracleStub(
        TargetOracleDetector(labels)), device=device)
    s = res.summary()
    print("target-oracle aggregates:", s)
    print(f"  mean inside (eroded): {s['mean_inside_pct_eroded']:.2f} %   "
          "(reference upstream weights: 74.48; learned x ckpt: 69.52)")
    print(f"  erosion improvement:  {s['mean_pct_improvement']:.2f} %   "
          "(reference: +7.67; learned x: +5.83)")
    print(f"  std of diff:          {s['std_inside_pct_diff']:.2f}     "
          "(reference: 5.87; learned x: 3.48)")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lidar_object_detection_tpu_torch.pipelines."
             "yolo_distill", description=__doc__.split("\n\n")[0])
    cli.common_flags(ap)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--scale", default="n")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint path (.opt and .json written beside); "
                         "required but with --eval-targets")
    ap.add_argument("--cache", default=None,
                    help="label cache (.npz), read when its recipe matches")
    ap.add_argument("--make-labels", action="store_true")
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--eval-targets", action="store_true",
                    help="serve the labels as detections through the "
                         "erosion study (no network, no checkpoint)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seg-weight", type=float, default=1.0,
                    help="instance-mask loss weight")
    ap.add_argument("--ema-decay", type=float, default=0.0,
                    help="EMA of the weights (e.g. 0.999); serving prefers "
                         "the EMA copy when the checkpoint has one")
    args = ap.parse_args(argv)
    cli.require_dataset(ap, args)
    if not args.ckpt and not args.eval_targets:
        ap.error("--ckpt is required (but with --eval-targets)")

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        run(args)
        return 0
    created = distributed.initialize(device=args.device)
    try:
        mesh = make_mesh(torch.device(args.device).type)
        with contextlib.ExitStack() as quiet:
            if not distributed.is_primary():
                devnull = quiet.enter_context(open(os.devnull, "w"))
                quiet.enter_context(contextlib.redirect_stdout(devnull))
            run(args, mesh)
    finally:
        if created:
            dist.destroy_process_group()
    return 0


def run(args, mesh=None) -> None:
    """The stages ``args`` asks for; with a mesh on every rank: rank 0
    builds (and caches) the labels first, the others after it; all train;
    rank 0 evaluates."""
    primary = distributed.is_primary()
    if mesh is not None and not primary:
        dist.barrier()      # rank 0's label cache first
    labels = build_labels(args.dataset, cache=args.cache,
                          device=args.device)
    if mesh is not None and primary:
        dist.barrier()
    if args.make_labels:
        return
    if args.eval_targets:
        if primary:
            eval_targets(labels, args.dataset, device=args.device)
        return
    if not args.eval_only:
        train(labels, args.steps, args.lr, args.ckpt, scale=args.scale,
              seg_weight=args.seg_weight, ema_decay=args.ema_decay,
              resume=args.resume, seed=args.seed, device=args.device,
              mesh=mesh)
    if primary:
        evaluate(labels, args.ckpt, scale=args.scale, conf=args.conf,
                 device=args.device)


if __name__ == "__main__":
    sys.exit(main())
