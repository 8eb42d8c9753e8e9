"""Pillar voxelization over a dense grid.

Counterpart of ``lidar_object_detection_tpu/models/pointpillars/
voxelize.py`` (lines 30-128).  PointPillars (Lang et al., CVPR 2019)
discretizes the x-y plane into pillars, augments each point with its
pillar's statistics, and, after a per-point embedding, max-pools each
pillar into a dense BEV image.  As in the JAX package no ragged pillar list
is built: a pillar id per point, one scatter-add for the pillar sums and
counts, and one scatter-max straight into the (B, ny, nx, C) image.

Pillar ids of a batch carry per-frame offsets (frame b's ids start at b *
ny * nx), so one scatter serves the batch.  An invalid or out-of-grid point
gets id 0 and contributes zeros: to pillar 0's sums (nothing), and to its
max (nothing, over a zero fill, since embeddings are ReLU outputs).

The sums and counts are ``index_add_`` under PyTorch's deterministic
algorithms (:func:`deterministic_algorithms`, a scope as narrow as the two
calls): on the card that is a sort of the pillar ids and a sum in their
order, the same bits on every run, where the default is a float atomic
whose order varies.  The order is not JAX's, so the pillar means may
differ from JAX's in their last bits.  The max of :func:`scatter_bev`
does not depend on order and stays atomic.

Memory at the surround grid (640 x 640) and B = 1: the image and the
scatter's fill are 640 * 640 * 64 * 4 B = 105 MB each, the scatter's
index 131072 * 64 * 8 B = 67 MB.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Tuple

import torch

from lidar_object_detection_tpu_torch.models.common import true_div


@dataclasses.dataclass(frozen=True)
class PillarGridConfig:
    """Standard KITTI car-detection grid (PointPillars section 4.1)."""

    x_range: Tuple[float, float] = (0.0, 69.12)
    y_range: Tuple[float, float] = (-39.68, 39.68)
    z_range: Tuple[float, float] = (-3.0, 1.0)
    pillar_size: float = 0.16

    @property
    def nx(self) -> int:
        return int(round((self.x_range[1] - self.x_range[0])
                         / self.pillar_size))

    @property
    def ny(self) -> int:
        return int(round((self.y_range[1] - self.y_range[0])
                         / self.pillar_size))


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` inside the scope; the
    caller's setting and its ``warn_only`` are restored after it.  The
    setting is the process's, so keep the scope to the calls that need
    it."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])


def pillar_ids(points, valid, cfg: PillarGridConfig):
    """Per-point pillar index into the flattened (ny, nx) grid.

    Returns (ids (P,) int64, in_grid (P,) bool).  Out-of-range or invalid
    points get id 0 with in_grid False.
    """
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    ix = torch.floor(true_div(x - cfg.x_range[0], cfg.pillar_size)).to(
        torch.int32)
    iy = torch.floor(true_div(y - cfg.y_range[0], cfg.pillar_size)).to(
        torch.int32)
    in_grid = (valid
               & (ix >= 0) & (ix < cfg.nx)
               & (iy >= 0) & (iy < cfg.ny)
               & (z >= cfg.z_range[0]) & (z <= cfg.z_range[1]))
    ids = torch.where(in_grid, iy.long() * cfg.nx + ix.long(), 0)
    return ids, in_grid


def point_features(points, valid, cfg: PillarGridConfig, batch: int = 1):
    """The 9-dim PointPillars per-point feature:
    (x, y, z, reflectance, x-xc, y-yc, z-zc, x-cx, y-cy), where (xc, yc,
    zc) is the pillar's point mean and (cx, cy) the pillar's center.

    Takes (B*P, >=3) points flattened frame by frame and ``batch``.
    Returns (features (B*P, 9) float32, ids (B*P,) batch-offset, in_grid).
    """
    points = points.to(torch.float32)
    ids, in_grid = pillar_ids(points, valid, cfg)
    if batch > 1:
        per = points.shape[0] // batch
        offs = torch.arange(batch, device=points.device).repeat_interleave(
            per) * (cfg.nx * cfg.ny)
        ids = ids + offs
    n_pillars = batch * cfg.nx * cfg.ny
    w = in_grid.to(torch.float32)

    xyz = points[:, :3] * w[:, None]
    with deterministic_algorithms():
        sums = points.new_zeros((n_pillars, 3)).index_add_(0, ids, xyz)
        counts = points.new_zeros((n_pillars,)).index_add_(0, ids, w)
    means = sums[ids] / torch.clamp(counts[ids], min=1.0)[:, None]

    cx = (torch.floor(true_div(points[:, 0] - cfg.x_range[0],
                               cfg.pillar_size))
          + 0.5) * cfg.pillar_size + cfg.x_range[0]
    cy = (torch.floor(true_div(points[:, 1] - cfg.y_range[0],
                               cfg.pillar_size))
          + 0.5) * cfg.pillar_size + cfg.y_range[0]

    refl = (points[:, 3] if points.shape[1] > 3
            else torch.zeros_like(points[:, 0]))
    feats = torch.stack([
        points[:, 0], points[:, 1], points[:, 2], refl,
        points[:, 0] - means[:, 0],
        points[:, 1] - means[:, 1],
        points[:, 2] - means[:, 2],
        points[:, 0] - cx,
        points[:, 1] - cy,
    ], dim=-1)
    feats = feats * w[:, None]
    return feats, ids, in_grid


def scatter_bev(embedded, ids, in_grid, cfg: PillarGridConfig,
                batch: int = 1):
    """Max-pool per pillar and dense BEV scatter in one op.

    Args:
      embedded: (B*P, C) per-point embeddings (after linear, BN, ReLU: >= 0).
      ids / in_grid: from :func:`point_features` (batch-offset ids).

    Returns (B, ny, nx, C) float32, zeros where a pillar has no point.
    """
    n_pillars = batch * cfg.nx * cfg.ny
    c = embedded.shape[-1]
    vals = torch.where(in_grid[:, None], embedded, 0.0)
    grid = embedded.new_zeros((n_pillars, c))
    grid.scatter_reduce_(0, ids[:, None].expand(-1, c), vals, "amax")
    return grid.reshape(batch, cfg.ny, cfg.nx, c)
