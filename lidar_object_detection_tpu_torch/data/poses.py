"""KITTI-360 pose files and multi-sweep scan aggregation.

Counterpart of ``lidar_object_detection_tpu/data/poses.py`` (lines
36-203), kept as its own copy:

- ``poses.txt`` rows are ``frame  3x4`` IMU/GPS->world transforms;
- ``cam0_to_world.txt`` rows are ``frame  4x4`` *rectified*-cam0->world
  transforms.

Multi-sweep aggregation moves consecutive Velodyne scans into one target
frame's velodyne coordinates through the world frame (``T =
inv(velo_to_world[target]) @ velo_to_world[source]``), in float64 on the
host, giving one dense cloud with per-point sweep ids.  PointPillars'
surround inference runs on such clouds (``pipelines/pointpillars.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from lidar_object_detection_tpu_torch.data.kitti360 import (
    Kitti360Dataset, load_velodyne_scan, sequence_name)


def _load_pose_file(path: str, n_values: int) -> Tuple[np.ndarray, np.ndarray]:
    """``frame v0 v1 ...`` rows -> (frames (N,), transforms (N, 4, 4))."""
    frames = []
    mats = []
    with open(path) as f:
        for line in f:
            vals = line.split()
            if not vals:
                continue
            if len(vals) < 1 + n_values:
                raise ValueError(
                    f"{path}: expected {1 + n_values} columns, got "
                    f"{len(vals)}: {line[:60]!r}")
            frames.append(int(vals[0]))
            m = np.array([float(v) for v in vals[1:1 + n_values]],
                         np.float64).reshape(-1, 4)
            if m.shape[0] == 3:
                m = np.vstack([m, [0.0, 0.0, 0.0, 1.0]])
            mats.append(m)
    if not frames:
        raise ValueError(f"{path}: no pose rows")
    order = np.argsort(frames)
    return (np.asarray(frames, np.int64)[order],
            np.stack(mats, axis=0)[order])


def load_poses_txt(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """IMU/GPS system -> world, one 3x4 row per estimated frame."""
    return _load_pose_file(path, 12)


def load_cam0_to_world(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Rectified cam0 -> world, one flattened 4x4 row per frame."""
    return _load_pose_file(path, 16)


@dataclasses.dataclass(frozen=True)
class PoseTable:
    """Frame-indexed rigid transforms with exact or nearest lookup.

    Pose files are keyframed (drive 0000 starts at frame 1 and skips
    frames), so ``nearest=True`` (the default) snaps to the closest
    estimated frame -- the right semantics for sweep aggregation where a
    <0.1 s pose error is far below the scan's own motion blur.  Use
    ``nearest=False`` to require exact rows.
    """

    frames: np.ndarray          # (N,) int64, sorted
    transforms: np.ndarray      # (N, 4, 4) float64

    @staticmethod
    def from_file(path: str, kind: str = "cam0_to_world") -> "PoseTable":
        if kind == "cam0_to_world":
            frames, mats = load_cam0_to_world(path)
        elif kind == "poses":
            frames, mats = load_poses_txt(path)
        else:
            raise ValueError(f"unknown pose file kind: {kind!r}")
        return PoseTable(frames=frames, transforms=mats)

    def __len__(self) -> int:
        return len(self.frames)

    def lookup(self, frame_id: int, nearest: bool = True) -> np.ndarray:
        i = int(np.searchsorted(self.frames, frame_id))
        if i < len(self.frames) and self.frames[i] == frame_id:
            return self.transforms[i]
        if not nearest:
            raise KeyError(f"no pose for frame {frame_id}")
        # closest of the two neighbours
        cands = [j for j in (i - 1, i) if 0 <= j < len(self.frames)]
        j = min(cands, key=lambda j: abs(int(self.frames[j]) - frame_id))
        return self.transforms[j]


def load_pose_table(root: str, seq: int = 0,
                    kind: str = "cam0_to_world") -> PoseTable:
    name = {"cam0_to_world": "cam0_to_world.txt", "poses": "poses.txt"}[kind]
    path = os.path.join(root, "data_poses", sequence_name(seq), name)
    return PoseTable.from_file(path, kind)


def velo_to_world(pose_cam0_to_world: np.ndarray,
                  velo_to_rect: np.ndarray) -> np.ndarray:
    """Velodyne -> world for one frame.

    ``cam0_to_world`` is rectified-cam0 -> world (verified convention
    above) and ``velo_to_rect`` (data/calib.py TransformChain) is
    velodyne -> rectified cam0, so the composition is direct.
    """
    return pose_cam0_to_world @ velo_to_rect


@dataclasses.dataclass
class SweepAggregate:
    """A multi-sweep point cloud in the target frame's velodyne coords."""

    points: np.ndarray        # (P, 4) float32 -- xyz in target velo + refl
    point_valid: np.ndarray   # (P,) bool
    sweep_id: np.ndarray      # (P,) int32 -- index into ``source_frames``
    target_frame: int
    source_frames: Tuple[int, ...]

    @property
    def num_valid(self) -> int:
        return int(self.point_valid.sum())


def aggregate_sweeps(dataset: Kitti360Dataset,
                     target_frame: int,
                     source_frames: Sequence[int],
                     max_points: Optional[int] = None,
                     pose_table: Optional[PoseTable] = None) -> SweepAggregate:
    """Fuse several Velodyne sweeps into ``target_frame``'s velo frame.

    Each source scan is loaded, lifted to world via its (nearest) cam0
    pose and the fixed velo->rect chain, and brought back through the
    target frame's inverse chain.  The result is padded/truncated to
    ``max_points`` (default: next multiple of 4096 >= total) with a
    validity mask, ready for ``fuse_frame`` / point-sharded fusion.
    """
    table = pose_table or load_pose_table(dataset.root, dataset.seq)
    if dataset.cam_id == 0:
        v2r = dataset.transforms.velo_to_rect.astype(np.float64)
    else:
        # cam0_to_world composes with the *cam0* rectified chain, whatever
        # camera the dataset was opened for
        from lidar_object_detection_tpu_torch.data import calib as calib_lib
        cam0 = calib_lib.load_perspective_camera(dataset.root, 0)
        v2r = calib_lib.build_transform_chain(
            dataset.root, cam0).velo_to_rect.astype(np.float64)
    t_target = velo_to_world(table.lookup(target_frame), v2r)
    t_target_inv = np.linalg.inv(t_target)

    chunks = []
    ids = []
    for s, src in enumerate(source_frames):
        scan = load_velodyne_scan(dataset.scan_path(src))
        t = t_target_inv @ velo_to_world(table.lookup(src), v2r)
        xyz = scan[:, :3].astype(np.float64)
        xyz = xyz @ t[:3, :3].T + t[:3, 3]
        out = np.empty_like(scan)
        out[:, :3] = xyz.astype(np.float32)
        out[:, 3] = scan[:, 3]
        chunks.append(out)
        ids.append(np.full(len(out), s, np.int32))

    points = np.concatenate(chunks, axis=0)
    sweep_id = np.concatenate(ids, axis=0)
    total = len(points)
    if max_points is None:
        max_points = ((total + 4095) // 4096) * 4096
    if total > max_points:
        # subsample evenly across the concatenated cloud instead of
        # slicing the head, which would silently drop entire later sweeps
        keep = np.linspace(0, total - 1, max_points).round().astype(np.int64)
        points = points[keep]
        sweep_id = sweep_id[keep]
        total = max_points
    pad = max_points - total
    if pad:
        points = np.pad(points, ((0, pad), (0, 0)))
        sweep_id = np.pad(sweep_id, (0, pad), constant_values=-1)
    valid = np.zeros(max_points, bool)
    valid[:total] = True
    return SweepAggregate(points=points, point_valid=valid,
                          sweep_id=sweep_id, target_frame=int(target_frame),
                          source_frames=tuple(int(f) for f in source_frames))
