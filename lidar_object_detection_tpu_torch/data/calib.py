"""First-party KITTI-360 calibration parsing.

Counterpart of ``lidar_object_detection_tpu/data/calib.py``, kept as its
own copy.  It replaces the ``kitti360scripts`` devkit the reference
imports (``loadCalibrationRigid`` / ``loadCalibrationCameraToPose`` /
``CameraPerspective``, V1_BBox_Pointwise_filtering.py:9-10,301-312) and
keeps the devkit's conventions:

* rigid calib files hold a row-major 3x4 ``[R|t]`` promoted to 4x4,
* ``calib_cam_to_pose.txt`` holds one ``image_XX: <12 floats>`` line per cam,
* the perspective camera reads ``P_rect_XX`` (intrinsics = its left 3x3),
  ``R_rect_XX`` (promoted to 4x4) and ``S_rect_XX`` (width height) from
  ``calibration/perspective.txt``,
* the velodyne->rectified-camera chain is
  ``TrVeloToRect = R_rect @ inv(TrCam0ToVelo @ TrCamkToCam0)``
  (V1:309-312).

Everything here is host-side NumPy in float64, as in the reference; the
pipeline moves the matrices to the device as float32.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

import numpy as np


def _parse_rigid(values) -> np.ndarray:
    mat = np.asarray([float(x) for x in values],
                     dtype=np.float64).reshape(3, 4)
    out = np.eye(4, dtype=np.float64)
    out[:3, :] = mat
    return out


def load_calibration_rigid(path: str) -> np.ndarray:
    """Load a 3x4 rigid transform file as a 4x4 homogeneous matrix."""
    with open(path, "r") as f:
        values = f.read().split()
    # Some files prefix a key like "name:"; keep only numeric tokens.
    values = [v for v in values if not v.endswith(":")]
    return _parse_rigid(values[:12])


def load_calibration_camera_to_pose(path: str) -> Dict[str, np.ndarray]:
    """Load ``calib_cam_to_pose.txt`` as a dict of 4x4 matrices keyed by
    ``image_00`` .. ``image_03``."""
    out: Dict[str, np.ndarray] = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, _, rest = line.partition(":")
            out[key.strip()] = _parse_rigid(rest.split()[:12])
    return out


@dataclasses.dataclass(frozen=True)
class CameraCalibration:
    """Rectified perspective camera (the devkit's ``CameraPerspective``).

    ``intrinsics`` is the left 3x3 of ``P_rect_XX``; ``rect`` is the 4x4
    rectifying rotation; ``width``/``height`` come from ``S_rect_XX``.
    """

    cam_id: int
    intrinsics: np.ndarray       # (3, 3) float64
    rect: np.ndarray             # (4, 4) float64
    width: int
    height: int

    def cam2image(self, points):
        """Project 3xN (or 3,) camera-frame points to integer pixel coords.

        Devkit-parity semantics: ``depth`` is the raw z row; zero depths are
        replaced by ``-1e-6``; ``u``/``v`` are ``round(x / |depth|)`` cast to
        int (note the *absolute* depth in the divisor and numpy's
        round-half-to-even).
        """
        points = np.asarray(points, dtype=np.float64)
        squeeze = points.ndim == 1
        if squeeze:
            points = points[:, None]
        proj = self.intrinsics @ points
        depth = proj[2, :].copy()
        depth[depth == 0] = -1e-6
        u = np.round(proj[0, :] / np.abs(depth)).astype(int)
        v = np.round(proj[1, :] / np.abs(depth)).astype(int)
        if squeeze:
            return u[0], v[0], depth[0]
        return u, v, depth


def load_perspective_camera(kitti360_root: str,
                            cam_id: int = 0) -> CameraCalibration:
    """Parse ``calibration/perspective.txt`` for one camera."""
    path = os.path.join(kitti360_root, "calibration", "perspective.txt")
    intrinsics = None
    rect = None
    width = height = -1
    p_key = f"P_rect_{cam_id:02d}:"
    r_key = f"R_rect_{cam_id:02d}:"
    s_key = f"S_rect_{cam_id:02d}:"
    with open(path, "r") as f:
        for line in f:
            tokens = line.split()
            if not tokens:
                continue
            if tokens[0] == p_key:
                p_rect = np.asarray([float(x) for x in tokens[1:13]],
                                    dtype=np.float64).reshape(3, 4)
                intrinsics = p_rect[:, :3]
            elif tokens[0] == r_key:
                rect = np.eye(4, dtype=np.float64)
                rect[:3, :3] = np.asarray(
                    [float(x) for x in tokens[1:10]], dtype=np.float64
                ).reshape(3, 3)
            elif tokens[0] == s_key:
                width = int(float(tokens[1]))
                height = int(float(tokens[2]))
    if intrinsics is None or rect is None or width < 0:
        raise ValueError(f"incomplete perspective calibration in {path}")
    return CameraCalibration(cam_id=cam_id, intrinsics=intrinsics, rect=rect,
                             width=width, height=height)


@dataclasses.dataclass(frozen=True)
class TransformChain:
    """The full velo<->cam transform chain of the reference (V1:304-312).

    GT box corners are annotated in the cam0 frame (``bboxes_3D_cam0``);
    ``corners_cam0_to_cam`` maps them into the frame the configured camera's
    intrinsics project from.  For cam 0 this is the identity -- the reference
    projects cam0-frame corners directly with the cam0 intrinsics (no
    R_rect_00), and our parity tests pin that behavior.  For cam k>0 it is
    ``R_rect_k @ inv(camk_to_cam0)``: move into the cam-k frame, then
    rectify, so corners land in the same frame the point cloud reaches via
    ``velo_to_rect``.  ``corners_to_velo`` maps corners *from that frame*
    back to velodyne -- algebraically ``cam0_to_velo`` composed with the
    inverse corner transform, so corners_velo is identical for every camera.
    """

    velo_to_cam: np.ndarray         # (4, 4) TrVeloToCam
    cam_to_velo: np.ndarray         # (4, 4) inverse
    velo_to_rect: np.ndarray        # (4, 4) R_rect @ TrVeloToCam
    corners_cam0_to_cam: np.ndarray  # (4, 4) cam0 frame -> projection frame
    corners_to_velo: np.ndarray      # (4, 4) projection frame -> velodyne


def build_transform_chain(kitti360_root: str,
                          camera: CameraCalibration) -> TransformChain:
    calib_dir = os.path.join(kitti360_root, "calibration")
    cam_to_velo_file = os.path.join(calib_dir, "calib_cam_to_velo.txt")
    cam_to_pose_file = os.path.join(calib_dir, "calib_cam_to_pose.txt")
    cam0_to_velo = load_calibration_rigid(cam_to_velo_file)
    cam_to_pose = load_calibration_camera_to_pose(cam_to_pose_file)

    camk_to_cam0 = (np.linalg.inv(cam_to_pose["image_00"])
                    @ cam_to_pose[f"image_{camera.cam_id:02d}"])
    cam_to_velo = cam0_to_velo @ camk_to_cam0
    velo_to_cam = np.linalg.inv(cam_to_velo)
    velo_to_rect = camera.rect @ velo_to_cam
    if camera.cam_id == 0:
        corners_cam0_to_cam = np.eye(4, dtype=np.float64)
        corners_to_velo = cam0_to_velo
    else:
        corners_cam0_to_cam = camera.rect @ np.linalg.inv(camk_to_cam0)
        # corners arrive in the rectified cam-k frame; back to velodyne is
        # cam0_to_velo @ inv(corners_cam0_to_cam) == inv(velo_to_rect).
        corners_to_velo = cam0_to_velo @ np.linalg.inv(corners_cam0_to_cam)
    return TransformChain(velo_to_cam=velo_to_cam,
                          cam_to_velo=np.linalg.inv(velo_to_cam),
                          velo_to_rect=velo_to_rect,
                          corners_cam0_to_cam=corners_cam0_to_cam,
                          corners_to_velo=corners_to_velo)
