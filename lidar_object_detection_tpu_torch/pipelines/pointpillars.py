"""Pure-LiDAR 3D detection (PointPillars): training, inference and their
evaluation.

Counterpart of ``lidar_object_detection_tpu/pipelines/pointpillars.py``:
the training batches (``MAX_GT``, ``load_training_batch``, lines 30-52;
``pack_frames``, 366-382), the BEV-IoU evaluation (55-113, 385-437), the
pose-aggregated multi-sweep frames and the GT-aware point cap (114-200),
the held-out split (``FrameSplit``, ``ego_positions``,
``_gt_centers_world``, ``spatial_split``, 202-363), ``train_pointpillars``
(438-555), the checkpoint config check (558-626) and
``infer_pointpillars`` (628-712), which writes the same
``detections_<frame>.json`` and ``scene_<frame>.ply`` files.  The network
runs on ``device`` (the card by default); inference one frame per
forward as the JAX function runs it, its SSD decode's suppression the
rotated NMS kernel there (``ops/rotated_nms.py``), or K5 with
``rotated_nms=False``; training one batch of frames per step
(``models/pointpillars/train.py``).

``train_pointpillars(checkpoint_dir=...)`` writes
``pp_<head>_step<N>.msgpack``: flax's msgpack of ``(variables, opt_state,
step)`` with a ``pillars_config_meta`` sidecar, the layout of the JAX
package's surround runner (``examples/train_pointpillars_surround.py``),
which both packages' ``pointpillars-infer`` read.  The JAX function writes
an orbax directory there instead; orbax imports JAX, which the port does
not.  :func:`restore_pillars_checkpoint` resumes a trainer from such a
file (the runner's ``from_bytes``), and :func:`export_slim_checkpoint`
keeps only its variables and step (``examples/export_pp_ckpt.py``), the
form of the committed ``checkpoints/pp_*_surround.msgpack``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import warnings
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lidar_object_detection_tpu_torch.config import ShapeConfig
from lidar_object_detection_tpu_torch.data.kitti360 import Kitti360Dataset
from lidar_object_detection_tpu_torch.geom.boxes import (iou_2d_matrix,
                                                         transform_corners)
from lidar_object_detection_tpu_torch.models.pointpillars import (
    PillarsConfig, PointPillars, bev_aabb, boxes7_to_corners,
    corners_to_boxes7, decode_predictions, pillars_state_from_flax)
from lidar_object_detection_tpu_torch.models.pointpillars.augment import (
    points_in_box7)
from lidar_object_detection_tpu_torch.ops.rotated_iou import (
    rotated_iou_matrix_np)
from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
    packb, read_flax_msgpack, write_flax_msgpack)


MAX_GT = 64


def load_training_batch(dataset: Kitti360Dataset,
                        frame_ids: Optional[Sequence[int]] = None):
    """Frames and their velodyne-frame 7-dof GT boxes in fixed shapes:
    (batch, gt (B, MAX_GT, 7), gt_cls (B, MAX_GT) int32, gt_valid (B,
    MAX_GT))."""
    records = dataset.load_frames(frame_ids, require_image=False)
    batch = dataset.make_batch(records)
    b = batch.batch_size
    gt = np.zeros((b, MAX_GT, 7), np.float32)
    gt_cls = np.zeros((b, MAX_GT), np.int32)
    gt_valid = np.zeros((b, MAX_GT), bool)
    for i, rec in enumerate(records):
        boxes7 = _frame_boxes7(dataset, rec)
        g = min(len(boxes7), MAX_GT)
        gt[i, :g] = boxes7[:g]
        gt_valid[i, :g] = True
    return batch, gt, gt_cls, gt_valid


def _velo_corners(dataset: Kitti360Dataset, rec) -> np.ndarray:
    """(G, 8, 3) float32 velodyne-frame corners of a frame record."""
    cam_to_velo = torch.from_numpy(
        dataset.transforms.cam_to_velo.astype(np.float32))
    return transform_corners(
        torch.from_numpy(rec.corners_cam0.astype(np.float32)),
        cam_to_velo).numpy()


def _frame_boxes7(dataset: Kitti360Dataset, rec) -> np.ndarray:
    """(G, 7) float32 velodyne-frame GT boxes of a frame record."""
    corners = torch.from_numpy(_velo_corners(dataset, rec))
    return corners_to_boxes7(corners).numpy().reshape(-1, 7)


def pack_frames(frames: Sequence, num_points: int, max_gt: int = MAX_GT):
    """Fixed-shape batch arrays from (points, boxes7) frames: (pts
    (B, P, 4), pv (B, P), gt (B, G, 7), gcls (B, G) int32, gv (B, G))."""
    n = len(frames)
    pts = np.zeros((n, num_points, 4), np.float32)
    pv = np.zeros((n, num_points), bool)
    gt = np.zeros((n, max_gt, 7), np.float32)
    gcls = np.zeros((n, max_gt), np.int32)
    gv = np.zeros((n, max_gt), bool)
    for j, (p, bx) in enumerate(frames):
        k = min(len(p), num_points)
        pts[j, :k] = p[:k]
        pv[j, :k] = True
        g = min(len(bx), max_gt)
        gt[j, :g] = bx[:g]
        gv[j, :g] = True
    return pts, pv, gt, gcls, gv


@dataclasses.dataclass
class PillarsEvalResult:
    matched: int
    total_gt: int
    total_det: int
    # bool over the INPUT gt rows (gt_valid order): which GT got matched
    matched_gt: Optional[np.ndarray] = None

    @property
    def recall(self) -> float:
        return self.matched / self.total_gt if self.total_gt else 0.0

    @property
    def precision(self) -> float:
        return self.matched / self.total_det if self.total_det else 0.0


def evaluate_bev(det, gt_boxes7, gt_valid, iou_threshold: float = 0.5,
                 exact: bool = False):
    """Greedy BEV-IoU matching of decoded detections against GT:
    ``exact=True`` the rotated-rectangle IoU, else the axis-aligned BEV
    extent."""
    matched = 0
    total_gt = int(np.asarray(gt_valid).sum())
    det_boxes = np.asarray(det["boxes7"])
    det_ok = np.asarray(det["valid"])
    gt_ok = np.asarray(gt_valid)
    gt_np = np.asarray(gt_boxes7)
    matched_full = np.zeros(len(gt_ok), bool)
    total_det = int(det_ok.sum())
    if det_ok.any() and gt_ok.any():
        if exact:
            iou = rotated_iou_matrix_np(det_boxes[det_ok], gt_np[gt_ok])
        else:
            d_aabb = bev_aabb(torch.from_numpy(det_boxes[det_ok]))
            g_aabb = bev_aabb(torch.from_numpy(gt_np[gt_ok]))
            iou = iou_2d_matrix(d_aabb, g_aabb).numpy()
        used = np.zeros(iou.shape[1], bool)
        for d in range(iou.shape[0]):
            g = int(np.argmax(np.where(used, -1.0, iou[d])))
            if iou[d, g] >= iou_threshold and not used[g]:
                used[g] = True
                matched += 1
        matched_full[np.nonzero(gt_ok)[0][used]] = True
    return PillarsEvalResult(matched=matched, total_gt=total_gt,
                             total_det=total_det, matched_gt=matched_full)


def load_aggregated_frames(dataset: Kitti360Dataset,
                           target_frames: Sequence[int],
                           source_frames: Optional[Sequence[int]] = None,
                           grid=None,
                           max_points: Optional[int] = None,
                           protect_in_box: int = 0):
    """Multi-sweep frames: (points (P, 4), gt boxes7 (G, 7)) per target
    frame, each cloud pose-aggregated from ``source_frames`` into the
    target's velodyne coordinates and cropped to ``grid``'s bounds.
    ``protect_in_box`` > 0 exempts up to that many points per GT box from
    the ``max_points`` stride cap (:func:`cap_points_protected`)."""
    from lidar_object_detection_tpu_torch.data.poses import (
        aggregate_sweeps, load_pose_table)

    source_frames = list(source_frames or dataset.frame_ids())
    table = load_pose_table(dataset.root, dataset.seq)
    cam_to_velo = torch.from_numpy(
        dataset.transforms.cam_to_velo.astype(np.float32))
    out = []
    for tf in target_frames:
        agg = aggregate_sweeps(dataset, tf, source_frames,
                               pose_table=table)
        pts = agg.points[agg.point_valid]
        if grid is not None:
            keep = ((pts[:, 0] >= grid.x_range[0])
                    & (pts[:, 0] <= grid.x_range[1])
                    & (pts[:, 1] >= grid.y_range[0])
                    & (pts[:, 1] <= grid.y_range[1])
                    & (pts[:, 2] >= grid.z_range[0])
                    & (pts[:, 2] <= grid.z_range[1]))
            pts = pts[keep]
        rec = dataset.load_frame(tf, require_image=False)
        corners_velo = transform_corners(
            torch.from_numpy(rec.corners_cam0.astype(np.float32)),
            cam_to_velo)
        boxes7 = corners_to_boxes7(corners_velo).numpy().reshape(-1, 7)
        if max_points is not None and len(pts) > max_points:
            pts = cap_points_protected(pts, boxes7, max_points,
                                       protect_in_box)
        out.append((np.ascontiguousarray(pts), boxes7))
    return out


def cap_points_protected(pts: np.ndarray, boxes7: np.ndarray,
                         max_points: int,
                         protect_in_box: int = 0) -> np.ndarray:
    """Cap a cloud to ``max_points``, optionally exempting up to
    ``protect_in_box`` points per GT box from the stride subsample.
    Order-preserving; ``protect_in_box == 0`` is the plain uniform
    stride."""
    if len(pts) <= max_points:
        return pts
    if protect_in_box <= 0:
        return pts[np.linspace(0, len(pts) - 1,
                               max_points).astype(np.int64)]
    prot = np.zeros(len(pts), bool)
    for b in np.asarray(boxes7, np.float32).reshape(-1, 7):
        idx = np.nonzero(points_in_box7(pts, b))[0]
        if len(idx) > protect_in_box:
            idx = idx[np.linspace(0, len(idx) - 1,
                                  protect_in_box).astype(np.int64)]
        prot[idx] = True
    pidx = np.nonzero(prot)[0]
    rest = np.nonzero(~prot)[0]
    take = max(0, max_points - len(pidx))
    stride = rest[np.linspace(0, len(rest) - 1, take).astype(np.int64)] \
        if take and len(rest) else np.zeros(0, np.int64)
    return pts[np.sort(np.concatenate([pidx, stride]))[:max_points]]


@dataclasses.dataclass
class FrameSplit:
    """Held-out train/eval split over a drive's frames.

    The split maximizes the ego separation between eval and train frames
    and reports the leakage: ``eval_gt_overlapped`` counts the eval GT
    boxes whose center falls inside the pillar grid of some train frame
    (the same parked car may have been a training target).
    """

    train: List[int]
    eval: List[int]
    min_separation_m: float
    eval_gt_total: int
    eval_gt_overlapped: int
    # per eval frame: bool over its GT boxes (annotation order), True where
    # the box center is inside some train frame's grid footprint
    overlap_masks: Dict[int, np.ndarray] = dataclasses.field(
        default_factory=dict)

    def summary(self) -> dict:
        return {"train": self.train, "eval": self.eval,
                "min_separation_m": round(self.min_separation_m, 1),
                "eval_gt_total": self.eval_gt_total,
                "eval_gt_overlapped": self.eval_gt_overlapped}


def ego_positions(dataset: Kitti360Dataset,
                  table=None) -> Dict[int, np.ndarray]:
    """World-frame ego (velodyne origin) position per frame; ``table`` an
    already-loaded pose table, else read from disk."""
    from lidar_object_detection_tpu_torch.data.poses import (
        load_pose_table, velo_to_world)
    if table is None:
        table = load_pose_table(dataset.root, dataset.seq)
    v2r = dataset.transforms.velo_to_rect.astype(np.float64)
    return {f: velo_to_world(table.lookup(f), v2r)[:3, 3]
            for f in dataset.frame_ids()}


def _gt_centers_world(dataset: Kitti360Dataset, frame_id: int,
                      pose_table, v2r) -> np.ndarray:
    """(G, 3) world-frame GT box centers of one frame."""
    from lidar_object_detection_tpu_torch.data.poses import velo_to_world
    rec = dataset.load_frame(frame_id, require_image=False)
    if rec is None or rec.corners_cam0.shape[0] == 0:
        return np.zeros((0, 3))
    centers_velo = _velo_corners(dataset, rec).mean(axis=1)    # (G, 3)
    t = velo_to_world(pose_table.lookup(frame_id), v2r)
    return centers_velo @ t[:3, :3].T + t[:3, 3]


def spatial_split(dataset: Kitti360Dataset,
                  eval_frames: Optional[Sequence[int]] = None,
                  n_eval: int = 2,
                  grid=None,
                  train_frames: Optional[Sequence[int]] = None) -> FrameSplit:
    """Pick (or validate) a held-out eval set over the frames with GT.

    Without ``eval_frames``, the eval subset of ``n_eval`` frames that
    maximizes the least ego distance to a train frame (exhaustively up to
    3 frames, else greedily).  ``grid`` (default: the surround grid) is
    each train frame's reach for the leakage count.  ``train_frames`` pins
    the training set instead of "every usable frame but the eval ones",
    to score a trained checkpoint against frames it never saw.
    """
    import itertools

    from lidar_object_detection_tpu_torch.data.poses import (
        load_pose_table, velo_to_world)

    if grid is None:
        grid = PillarsConfig.kitti360_surround().grid
    usable = [f for f in dataset.frame_ids()
              if dataset.load_bboxes_exists(f)]
    if train_frames is not None:
        train_frames = sorted(set(train_frames))
        unknown = [f for f in train_frames if f not in usable]
        if unknown:
            raise ValueError(f"train frames without GT boxes: {unknown}")
        if not train_frames:
            raise ValueError("train_frames is empty")
    if eval_frames is None and not 0 < n_eval < len(usable):
        raise ValueError(
            f"n_eval={n_eval} must leave at least one training frame "
            f"({len(usable)} usable frames with GT boxes)")
    table = load_pose_table(dataset.root, dataset.seq)
    pos = ego_positions(dataset, table)

    def min_sep(ev):
        base = train_frames if train_frames is not None else usable
        tr = [f for f in base if f not in ev]
        return min(float(np.linalg.norm(pos[e] - pos[t]))
                   for e in ev for t in tr)

    if eval_frames is None:
        pool = ([f for f in usable if f not in train_frames]
                if train_frames is not None else usable)
        if n_eval > len(pool) - (1 if train_frames is None else 0):
            raise ValueError(
                f"n_eval={n_eval} does not fit the candidate pool "
                f"({len(pool)} frames)")
        if n_eval <= 3:
            best = max(itertools.combinations(pool, n_eval), key=min_sep)
        else:   # greedy farthest-point extension of the best pair
            best = list(max(itertools.combinations(pool, 2), key=min_sep))
            while len(best) < n_eval:
                rest = [f for f in pool if f not in best]
                best.append(max(rest, key=lambda f: min_sep(best + [f])))
        eval_frames = sorted(best)
    else:
        eval_frames = sorted(eval_frames)
        unknown = [f for f in eval_frames if f not in usable]
        if unknown:
            raise ValueError(f"eval frames without GT boxes: {unknown}")
        if train_frames is not None:
            leak = sorted(set(eval_frames) & set(train_frames))
            if leak:
                raise ValueError(f"eval frames also in train set: {leak}")
    train = (train_frames if train_frames is not None
             else [f for f in usable if f not in eval_frames])
    if not train:
        raise ValueError("eval set leaves no training frames")

    # leakage: eval GT centers inside any train frame's grid footprint,
    # checked in each train frame's velodyne coordinates
    v2r = dataset.transforms.velo_to_rect.astype(np.float64)
    train_inv = [np.linalg.inv(velo_to_world(table.lookup(t), v2r))
                 for t in train]
    total = overlapped = 0
    masks: Dict[int, np.ndarray] = {}
    for e in eval_frames:
        centers = _gt_centers_world(dataset, e, table, v2r)
        total += len(centers)
        m = np.zeros(len(centers), bool)
        for i, c in enumerate(centers):
            for tinv in train_inv:
                lc = tinv[:3, :3] @ c + tinv[:3, 3]
                if (grid.x_range[0] <= lc[0] <= grid.x_range[1]
                        and grid.y_range[0] <= lc[1] <= grid.y_range[1]):
                    m[i] = True
                    break
        overlapped += int(m.sum())
        masks[e] = m
    return FrameSplit(train=train, eval=list(eval_frames),
                      min_separation_m=min_sep(eval_frames),
                      eval_gt_total=total, eval_gt_overlapped=overlapped,
                      overlap_masks=masks)


def bev_average_precision(dets, gts, iou_threshold: float = 0.5) -> float:
    """Continuous-interpolation BEV average precision at
    ``iou_threshold``: ``dets`` per frame a (boxes7 (D, 7), scores (D,))
    pair, ``gts`` per frame a (G, 7) array; detections ranked globally by
    score and matched greedily on the rotated IoU."""
    rows = []  # (score, frame, det_index)
    for f, (boxes, scores) in enumerate(dets):
        for d in range(len(boxes)):
            rows.append((float(scores[d]), f, d))
    rows.sort(key=lambda r: -r[0])
    n_gt = sum(len(g) for g in gts)
    if n_gt == 0 or not rows:
        return 0.0
    iou_cache = {}
    for f, (boxes, _) in enumerate(dets):
        if len(boxes) and len(gts[f]):
            iou_cache[f] = rotated_iou_matrix_np(boxes, gts[f])
    used = {f: np.zeros(len(g), bool) for f, g in enumerate(gts)}
    tp = np.zeros(len(rows))
    fp = np.zeros(len(rows))
    for i, (_, f, d) in enumerate(rows):
        iou = iou_cache.get(f)
        if iou is None or iou.shape[1] == 0:
            fp[i] = 1
            continue
        masked = np.where(used[f], -1.0, iou[d])
        g = int(np.argmax(masked))
        if masked[g] >= iou_threshold:
            used[f][g] = True
            tp[i] = 1
        else:
            fp[i] = 1
    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    recall = ctp / n_gt
    precision = ctp / np.maximum(ctp + cfp, 1)
    mrec = np.concatenate([[0.0], recall, [recall[-1]]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def write_pillars_checkpoint(path: str, trainer, cfg: PillarsConfig) -> None:
    """flax's msgpack of ``(variables, opt_state, step)`` (the bytes of
    ``flax.serialization.to_bytes`` of the JAX trainer's tuple, maps in
    sorted key order) and the ``pillars_config_meta`` sidecar
    ``<path>.json``: the layout of the JAX package's surround runner, read
    by ``load_pillars_variables`` in both packages and by flax's
    ``from_bytes`` against the JAX trainer's state."""
    variables, opt_state, step = trainer.state.flax_tree()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    write_flax_msgpack(tmp, {"0": variables, "1": opt_state, "2": step})
    os.replace(tmp, path)
    with open(path + ".json", "w") as f:
        json.dump(pillars_config_meta(cfg), f)


def restore_pillars_checkpoint(path: str, trainer) -> int:
    """Resume ``trainer`` (a :class:`PillarsTrainer`) from a full
    checkpoint that :func:`write_pillars_checkpoint` or the JAX surround
    runner wrote; returns its step.  The sidecar, where there is one, must
    name the trainer's grid and head; a slim checkpoint is refused
    (``PillarsTrainer.restore``)."""
    check_sidecar(path, trainer.cfg)
    trainer.restore(read_flax_msgpack(path))
    return trainer.state.step


def export_slim_checkpoint(src: str, dst: str) -> Dict:
    """Write ``dst``: ``src``'s ``{"0": variables, "2": step}`` alone, the
    optimizer's moments dropped, as flax's ``msgpack_serialize`` writes it
    (the bytes of ``examples/export_pp_ckpt.py``'s), and copy its sidecar.
    Returns the payload's size in bytes, the step and the sidecar (None
    without one)."""
    raw = read_flax_msgpack(src)
    payload = packb({"0": raw["0"], "2": raw["2"]})
    tmp = dst + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, dst)
    meta = None
    if os.path.exists(src + ".json"):
        shutil.copyfile(src + ".json", dst + ".json")
        with open(dst + ".json") as f:
            meta = json.load(f)
    step = raw["2"] if isinstance(raw["2"], dict) else int(raw["2"])
    return {"bytes": len(payload), "step": step, "sidecar": meta}


def train_pointpillars(dataset_root: str, steps: int = 50,
                       frame_ids: Optional[Sequence[int]] = None,
                       cfg: Optional[PillarsConfig] = None,
                       learning_rate: float = 2e-3,
                       batch_frames: int = 4,
                       log_every: int = 10,
                       eval_score_threshold: float = 0.1,
                       checkpoint_dir: Optional[str] = None,
                       augment: bool = True,
                       gt_sample_max: int = 12,
                       seed: int = 0,
                       eval_iou: float = 0.5,
                       eval_exact: bool = True,
                       surround: bool = False,
                       aggregate: bool = False,
                       max_points: Optional[int] = None,
                       head: Optional[str] = None,
                       device="cuda") -> Dict:
    """Train on a drive's frames (an overfit and regression harness: the
    bundled sample has 19 frames), on ``device``.

    ``augment=True`` applies the Lang et al. section-3 recipe on the host
    per step (GT paste, then global rotation, flip and scale,
    ``models/pointpillars/augment.py``); the closing evaluation runs on
    the un-augmented frames (the rotated-NMS decode with ``eval_exact``,
    then ``evaluate_bev``).  ``surround=True`` selects
    :meth:`PillarsConfig.kitti360_surround`, ``aggregate=True`` trains on
    pose-aggregated multi-sweep clouds.  With ``checkpoint_dir`` the
    final state goes to ``pp_<head>_step<steps>.msgpack`` there
    (:func:`write_pillars_checkpoint`).

    Returns dict: loss_history, trainer, eval (a
    :class:`PillarsEvalResult` per evaluated frame), checkpoint (its path
    or None).
    """
    from lidar_object_detection_tpu_torch.models.pointpillars.augment import (
        GtDatabase, augment_frame)
    from lidar_object_detection_tpu_torch.models.pointpillars.train import (
        PillarsTrainer)

    cfg = resolve_pillars_config(cfg, surround=surround, head=head)
    shapes = ShapeConfig()
    ds = Kitti360Dataset(dataset_root, shapes=shapes)
    p_max = max_points or shapes.max_points
    if aggregate:
        targets = list(frame_ids or ds.frame_ids())
        frames = load_aggregated_frames(ds, targets, grid=cfg.grid,
                                        max_points=p_max)
    else:
        records = ds.load_frames(frame_ids, require_image=False)
        frames = [(rec.points.astype(np.float32), _frame_boxes7(ds, rec))
                  for rec in records]
    db = GtDatabase.build(frames) if augment else None
    rng = np.random.default_rng(seed)

    def make_batch(sel, train: bool):
        b = len(sel)
        pts = np.zeros((b, p_max, 4), np.float32)
        pv = np.zeros((b, p_max), bool)
        gt = np.zeros((b, MAX_GT, 7), np.float32)
        gcls = np.zeros((b, MAX_GT), np.int32)
        gv = np.zeros((b, MAX_GT), bool)
        for j, i in enumerate(sel):
            p, bx = frames[i]
            if train and augment:
                room = max(0, MAX_GT - bx.shape[0])
                p, bx = augment_frame(p, bx, db, rng,
                                      max_samples=min(gt_sample_max, room))
            if len(p) > p_max:
                # a random subsample: the pasted points sit at the tail,
                # where a plain truncation would drop exactly them
                p = p[rng.choice(len(p), p_max, replace=False)]
            n = len(p)
            pts[j, :n] = p
            pv[j, :n] = True
            g = min(len(bx), MAX_GT)
            gt[j, :g] = bx[:g]
            gv[j, :g] = True
        return pts, pv, gt, gcls, gv

    trainer = PillarsTrainer(cfg, learning_rate=learning_rate, seed=seed,
                             device=device)

    n = len(frames)
    history: List[float] = []
    for step in range(steps):
        sel = [(step * batch_frames + j) % n for j in range(batch_frames)]
        metrics = trainer.train_step(*make_batch(sel, train=True))
        loss = float(metrics["loss"])
        history.append(loss)
        if log_every and step % log_every == 0:
            print(f"step {step}: loss={loss:.4f} "
                  f"cls={float(metrics['cls']):.4f} "
                  f"box={float(metrics['box']):.4f} "
                  f"num_pos={int(metrics['num_pos'])}")
    path = None
    if checkpoint_dir:
        path = os.path.join(checkpoint_dir,
                            f"pp_{cfg.head}_step{steps}.msgpack")
        write_pillars_checkpoint(path, trainer, cfg)

    # evaluation on the (un-augmented) training frames
    eval_sel = list(range(min(batch_frames, n)))
    pts, pv, gt, _, gv = make_batch(eval_sel, train=False)
    out = trainer.apply(pts, pv)
    results = []
    for i in eval_sel:
        one = {k: v[i] for k, v in out.items()}
        # the harness's threshold: the focal loss's confidence ramps slowly
        # on tiny datasets; production decoding uses 0.3
        with torch.no_grad():
            det = decode_predictions(one, cfg,
                                     score_threshold=eval_score_threshold,
                                     rotated_nms=eval_exact)
        det = {k: v.cpu().numpy() for k, v in det.items()}
        results.append(evaluate_bev(det, gt[i], gv[i],
                                    iou_threshold=eval_iou,
                                    exact=eval_exact))
    return {"loss_history": history, "trainer": trainer, "eval": results,
            "checkpoint": path}


def resolve_pillars_config(cfg: Optional[PillarsConfig] = None,
                           surround: bool = False,
                           head: Optional[str] = None) -> PillarsConfig:
    """The config-resolution rule of the JAX package's training and
    inference: ``cfg``, else the surround or the default preset, with
    ``head`` replaced where given."""
    cfg = cfg or (PillarsConfig.kitti360_surround() if surround
                  else PillarsConfig())
    if head is not None:
        cfg = dataclasses.replace(cfg, head=head)
    return cfg


def pillars_config_meta(cfg: PillarsConfig) -> Dict:
    """The config fields a checkpoint consumer must agree on: a mismatch
    loads cleanly (every layer is grid-extent-agnostic) but decodes in the
    wrong coordinate frame."""
    g = cfg.grid
    return {"head": cfg.head, "x_range": list(g.x_range),
            "y_range": list(g.y_range), "z_range": list(g.z_range),
            "pillar_size": g.pillar_size}


def load_pillars_variables(ckpt_path: str,
                           expect_cfg: Optional[PillarsConfig] = None):
    """Model variables from a surround-runner checkpoint, the flax msgpack
    of ``(variables, opt_state, step)``, read with the port's own reader.
    Returns (variables, step).

    With ``expect_cfg`` the ``<ckpt>.json`` sidecar's grid and head must
    match it (ValueError otherwise), and a missing sidecar warns.
    """
    raw = read_flax_msgpack(ckpt_path)
    variables, step = raw["0"], raw["2"]
    if expect_cfg is not None:
        check_sidecar(ckpt_path, expect_cfg)
    return variables, int(np.asarray(step))


def check_sidecar(ckpt_path: str, expect_cfg: PillarsConfig) -> None:
    """The ``<ckpt>.json`` sidecar's grid and head must match
    ``expect_cfg`` (ValueError otherwise); a missing sidecar warns."""
    sidecar = ckpt_path + ".json"
    if not os.path.exists(sidecar):
        warnings.warn(
            f"checkpoint {ckpt_path} has no {os.path.basename(sidecar)} "
            "sidecar; cannot verify it matches the requested "
            "--surround/--head config. A mismatched grid decodes garbage "
            "coordinates silently.", stacklevel=3)
        return
    with open(sidecar) as f:
        saved = json.load(f)
    want = pillars_config_meta(expect_cfg)
    mismatch = {k: (saved.get(k), v) for k, v in want.items()
                if saved.get(k) != v}
    if mismatch:
        raise ValueError(
            f"checkpoint {ckpt_path} was trained with a different "
            f"config than requested (saved vs requested): {mismatch}. "
            "Pass matching --surround/--head flags (or the cfg the "
            "checkpoint was trained with).")


def load_pillars_model(ckpt_path: str, cfg: PillarsConfig,
                       device="cuda") -> Tuple[PointPillars, int]:
    """The checkpoint's network on ``device`` (its sidecar checked against
    ``cfg``), and its training step."""
    variables, step = load_pillars_variables(ckpt_path, expect_cfg=cfg)
    model = PointPillars(cfg)
    model.load_state_dict(pillars_state_from_flax(variables), strict=True)
    return model.to(device).eval(), step


def pillars_clouds(dataset: Kitti360Dataset, frame_ids: Sequence[int],
                   cfg: PillarsConfig, aggregate: bool, max_points: int,
                   protect_in_box: int = 0) -> Iterator[np.ndarray]:
    """Each frame's cloud (N, 4) float32, capped to ``max_points``:
    pose-aggregated over the dataset's sweeps and cropped to the grid, or
    the frame's own scan, read one at a time."""
    if aggregate:
        frames = load_aggregated_frames(dataset, frame_ids, grid=cfg.grid,
                                        max_points=max_points,
                                        protect_in_box=protect_in_box)
        clouds = (p for p, _ in frames)
    else:
        clouds = (dataset.load_frame(f, require_image=False)
                  .points.astype(np.float32) for f in frame_ids)
    for pts in clouds:
        if len(pts) > max_points:
            pts = pts[np.linspace(0, len(pts) - 1,
                                  max_points).astype(np.int64)]
        yield pts


def padded_cloud(pts: np.ndarray, max_points: int, device="cpu"):
    """One cloud as the network's (1, P, 4) points and (1, P) mask."""
    buf = np.zeros((1, max_points, 4), np.float32)
    buf[0, :len(pts)] = pts[:, :4]
    pv = np.zeros((1, max_points), bool)
    pv[0, :len(pts)] = True
    return (torch.from_numpy(buf).to(device),
            torch.from_numpy(pv).to(device))


def detection_record(frame: int, det, step: int) -> Dict:
    """One frame's valid detections as numpy arrays, with its frame id and
    the checkpoint's step."""
    ok = det["valid"].cpu().numpy()
    return {"frame": int(frame),
            "boxes7": det["boxes7"].cpu().numpy()[ok],
            "scores": det["scores"].cpu().numpy()[ok],
            "classes": det["classes"].cpu().numpy()[ok],
            "ckpt_step": step}


def write_detections(rec: Dict, pts: np.ndarray, output_dir: str,
                     export_ply: bool = False) -> None:
    """``detections_<frame>.json``, and with ``export_ply``
    ``scene_<frame>.ply`` (gray cloud and red predicted wireframes)."""
    frame = rec["frame"]
    with open(os.path.join(output_dir, f"detections_{frame:010d}.json"),
              "w") as f:
        json.dump({k: (v.tolist() if isinstance(v, np.ndarray) else v)
                   for k, v in rec.items()}, f, indent=1)
    if export_ply:
        from lidar_object_detection_tpu_torch.viz.export import (
            export_fusion_scene)

        corners = boxes7_to_corners(torch.from_numpy(rec["boxes7"])).numpy()
        export_fusion_scene(
            os.path.join(output_dir, f"scene_{frame:010d}.ply"),
            pts[:, :3], None, [{"corners_velo": c} for c in corners])


def infer_pointpillars(dataset_root: str, ckpt_path: str,
                       frame_ids: Optional[Sequence[int]] = None,
                       cfg: Optional[PillarsConfig] = None,
                       surround: bool = False,
                       aggregate: bool = False,
                       head: Optional[str] = None,
                       max_points: Optional[int] = None,
                       protect_in_box: int = 0,
                       score_threshold: float = 0.3,
                       rotated_nms: bool = True,
                       output_dir: Optional[str] = None,
                       export_ply: bool = False,
                       device="cuda") -> List[Dict]:
    """Run a trained PointPillars checkpoint over dataset frames on
    ``device``.

    Returns one dict per frame: ``{"frame", "boxes7" (D, 7), "scores"
    (D,), "classes" (D,), "ckpt_step"}`` (valid detections only).  With
    ``output_dir``, writes ``detections_<frame>.json`` per frame and, with
    ``export_ply``, ``scene_<frame>.ply``.
    """
    cfg = resolve_pillars_config(cfg, surround=surround, head=head)
    model, step = load_pillars_model(ckpt_path, cfg, device)

    shapes = ShapeConfig()
    ds = Kitti360Dataset(dataset_root, shapes=shapes)
    p_max = max_points or shapes.max_points
    ids = list(frame_ids or ds.frame_ids())
    clouds = pillars_clouds(ds, ids, cfg, aggregate, p_max, protect_in_box)

    out: List[Dict] = []
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    for frame, pts in zip(ids, clouds):
        points, pv = padded_cloud(pts, p_max, device)
        with torch.inference_mode():
            raw = model(points, pv)
            one = {k: v[0] for k, v in raw.items()}
            det = decode_predictions(one, cfg,
                                     score_threshold=score_threshold,
                                     rotated_nms=rotated_nms)
        rec = detection_record(frame, det, step)
        out.append(rec)
        if output_dir:
            write_detections(rec, pts, output_dir, export_ply)
    return out
