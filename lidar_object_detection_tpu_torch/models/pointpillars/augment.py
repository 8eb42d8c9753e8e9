"""PointPillars training augmentation (Lang et al. 2019, section 3), on
the host in NumPy.

Counterpart of ``lidar_object_detection_tpu/models/pointpillars/
augment.py``, copied so that the same ``np.random.default_rng(seed)`` gives
the same arrays bit for bit:

* **GT-database sampling**: every annotated car is cut out of its source
  scan (the points inside its 7-dof box); at train time up to
  ``max_samples`` non-colliding cars are pasted into the frame at their
  original pose (the scan's points under a pasted box removed first);
* **global rotation** about +z, uniform in [-pi/4, pi/4];
* **global y-flip** with probability 0.5 (yaw negates);
* **global scale**, uniform in [0.95, 1.05].

The transforms apply to points and boxes alike, in the velodyne frame
with the (x, y, z, w, l, h, yaw) box layout.  ``points_in_box7`` also
serves ``pipelines.pointpillars.cap_points_protected``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


def points_in_box7(points: np.ndarray, box7: np.ndarray,
                   margin: float = 0.0) -> np.ndarray:
    """Boolean mask of (N, >=3) points inside one rotated 7-dof box, in
    the points' own dtype.  A BEV-AABB + z prefilter narrows the exact
    rotated test to the points near the box."""
    xyz = points[:, :3]
    x, y, z, w, l, h, yaw = [float(v) for v in box7]
    # prefilter: circumscribed AABB (+margin)
    c0, s0 = abs(np.cos(yaw)), abs(np.sin(yaw))
    ex = (l * c0 + w * s0) / 2 + margin
    ey = (l * s0 + w * c0) / 2 + margin
    near = np.where((np.abs(xyz[:, 0] - x) <= ex)
                    & (np.abs(xyz[:, 1] - y) <= ey)
                    & (np.abs(xyz[:, 2] - z) <= h / 2 + margin))[0]
    out = np.zeros(len(xyz), bool)
    if near.size == 0:
        return out
    sub = xyz[near]
    c, s = np.cos(-yaw), np.sin(-yaw)
    dx = sub[:, 0] - x
    dy = sub[:, 1] - y
    lx = dx * c - dy * s          # rotate into the box frame
    ly = dx * s + dy * c
    inside = ((np.abs(lx) <= l / 2 + margin)
              & (np.abs(ly) <= w / 2 + margin))
    out[near[inside]] = True
    return out


def _bev_aabb_np(boxes7: np.ndarray) -> np.ndarray:
    x, y = boxes7[:, 0], boxes7[:, 1]
    w, l, yaw = boxes7[:, 3], boxes7[:, 4], boxes7[:, 6]
    c, s = np.abs(np.cos(yaw)), np.abs(np.sin(yaw))
    ex = (l * c + w * s) / 2
    ey = (l * s + w * c) / 2
    return np.stack([x - ex, y - ey, x + ex, y + ey], -1)


def _aabb_overlaps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) boolean overlap matrix."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), bool)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    return (x2 > x1) & (y2 > y1)


@dataclasses.dataclass
class GtSample:
    box7: np.ndarray              # (7,)
    points: np.ndarray            # (n, 4) velodyne frame (original pose)


class GtDatabase:
    """Cut-out car instances for paste augmentation."""

    def __init__(self, samples: List[GtSample]):
        self.samples = samples

    def __len__(self) -> int:
        return len(self.samples)

    @staticmethod
    def build(frames: Sequence[Tuple[np.ndarray, np.ndarray]],
              min_points: int = 8) -> "GtDatabase":
        """``frames``: list of (points (N, 4), boxes7 (G, 7)).  Boxes with
        fewer than ``min_points`` interior points are skipped (too sparse
        to teach anything)."""
        samples = []
        for pts, boxes7 in frames:
            for b in np.asarray(boxes7).reshape(-1, 7):
                inside = points_in_box7(pts, b)
                if inside.sum() >= min_points:
                    samples.append(GtSample(box7=b.copy(),
                                            points=pts[inside].copy()))
        return GtDatabase(samples)


def sample_paste(points: np.ndarray, boxes7: np.ndarray, db: GtDatabase,
                 rng: np.random.Generator, max_samples: int = 12,
                 collision_margin: float = 0.5):
    """Paste up to ``max_samples`` database cars into the frame.

    Candidates colliding (BEV AABB + margin) with existing or already
    accepted boxes are rejected; scan points under an accepted box are
    removed before its points are added (SECOND's paste rule).
    """
    if len(db) == 0 or max_samples <= 0:
        return points, boxes7
    order = rng.permutation(len(db))[:max_samples * 3]
    accepted: List[GtSample] = []
    occupied = _bev_aabb_np(boxes7) if len(boxes7) else np.zeros((0, 4))
    occupied = occupied.copy()
    occupied[:, :2] -= collision_margin
    occupied[:, 2:] += collision_margin
    for k in order:
        cand = db.samples[k]
        ca = _bev_aabb_np(cand.box7[None])
        if _aabb_overlaps(ca, occupied).any():
            continue
        accepted.append(cand)
        occupied = np.concatenate([occupied, ca], 0)
        if len(accepted) == max_samples:
            break
    if not accepted:
        return points, boxes7
    keep = np.ones(len(points), bool)
    for cand in accepted:
        keep &= ~points_in_box7(points, cand.box7, margin=0.1)
    points = np.concatenate([points[keep]] + [c.points for c in accepted], 0)
    boxes7 = np.concatenate(
        [boxes7.reshape(-1, 7)] + [c.box7[None] for c in accepted], 0)
    return points, boxes7


def global_augment(points: np.ndarray, boxes7: np.ndarray,
                   rng: np.random.Generator,
                   max_rotation: float = np.pi / 4,
                   scale_range: Tuple[float, float] = (0.95, 1.05),
                   flip_y: bool = True):
    """Global rotation / y-flip / scale applied to points and boxes."""
    points = points.copy()
    boxes7 = np.asarray(boxes7, np.float32).reshape(-1, 7).copy()
    theta = rng.uniform(-max_rotation, max_rotation)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.asarray([[c, -s], [s, c]], np.float32)
    points[:, :2] = points[:, :2] @ rot.T
    boxes7[:, :2] = boxes7[:, :2] @ rot.T
    boxes7[:, 6] += theta
    if flip_y and rng.random() < 0.5:
        points[:, 1] = -points[:, 1]
        boxes7[:, 1] = -boxes7[:, 1]
        boxes7[:, 6] = -boxes7[:, 6]
    sc = rng.uniform(*scale_range)
    points[:, :3] *= sc
    boxes7[:, :6] *= sc
    boxes7[:, 6] = np.remainder(boxes7[:, 6] + np.pi, 2 * np.pi) - np.pi
    return points, boxes7


def augment_frame(points: np.ndarray, boxes7: np.ndarray,
                  db: Optional[GtDatabase], rng: np.random.Generator,
                  max_samples: int = 12):
    """Full per-frame train-time augmentation: paste, then global."""
    boxes7 = np.asarray(boxes7, np.float32).reshape(-1, 7)
    if db is not None:
        points, boxes7 = sample_paste(points, boxes7, db, rng,
                                      max_samples=max_samples)
    return global_augment(points, boxes7, rng)
