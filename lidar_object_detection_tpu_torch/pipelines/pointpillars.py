"""Pure-LiDAR 3D detection (PointPillars): inference and its evaluation.

Counterpart of the inference half of
``lidar_object_detection_tpu/pipelines/pointpillars.py``: the BEV-IoU
evaluation (lines 55-113, 385-437), the pose-aggregated multi-sweep
frames and the GT-aware point cap (114-200), the checkpoint config check
(558-626) and ``infer_pointpillars`` (628-712), which writes the same
``detections_<frame>.json`` and ``scene_<frame>.ply`` files.  The
network runs on ``device`` (the card by default), one frame per forward
as the JAX function runs it; the SSD decode's suppression is the rotated
NMS kernel there (``ops/rotated_nms.py``), or K5 with ``rotated_nms=False``.
Training (``load_training_batch``, ``spatial_split``, ``pack_frames``,
``train_pointpillars``) is ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import dataclasses
import json
import os
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
    read_flax_msgpack)


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
    sidecar = ckpt_path + ".json"
    if expect_cfg is not None and not os.path.exists(sidecar):
        warnings.warn(
            f"checkpoint {ckpt_path} has no {os.path.basename(sidecar)} "
            "sidecar; cannot verify it matches the requested "
            "--surround/--head config. A mismatched grid decodes garbage "
            "coordinates silently.", stacklevel=2)
    if expect_cfg is not None and os.path.exists(sidecar):
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
    return variables, int(np.asarray(step))


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
