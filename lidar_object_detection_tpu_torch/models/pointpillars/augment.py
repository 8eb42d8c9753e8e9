"""Point-in-box test of the PointPillars host pipeline.

Counterpart of ``points_in_box7`` in
``lidar_object_detection_tpu/models/pointpillars/augment.py`` (lines
28-60), which ``pipelines.pointpillars.cap_points_protected`` uses.  The
augmentation recipe itself (GT-database sampling, global rotation, flip
and scale) is training, ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

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
