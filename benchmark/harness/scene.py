# Frozen copy of chip_smoke.py:259-272 and 290-370 at 072d88e (the calibration and make_scene); write_calibration adapted from chip_smoke.py:385-413.
"""Synthetic scenes and the KITTI-360-like calibration of the benchmark.

``make_scene`` gives one frame's Velodyne scan and GT boxes: a 3D box
behind each car a detector found, filled with points, more boxes scattered
in front of the camera up to ``num_valid``, and background points.
``write_calibration`` writes the calibration files of a KITTI-360 tree
(sequence 0, camera 0) with these matrices, all that the pipeline reads
when the frames and scans come from memory.
"""

import os

import numpy as np

P, G = 131072, 384

# KITTI-360-like calibration: perspective.txt's P_rect_00 intrinsics and
# the Velodyne -> rectified-camera axis swap (x right = -y_velo, y down =
# -z_velo, z forward = x_velo).
INTRINSICS = np.array([[552.554261, 0.0, 682.049453],
                       [0.0, 552.554261, 238.769549],
                       [0.0, 0.0, 1.0]], np.float32)
VELO_TO_RECT = np.array([[0.0, -1.0, 0.0, 0.0],
                         [0.0, 0.0, -1.0, 0.0],
                         [1.0, 0.0, 0.0, 0.0],
                         [0.0, 0.0, 0.0, 1.0]], np.float32)
CAM_TO_VELO = np.linalg.inv(VELO_TO_RECT).astype(np.float32)

P, G, D = 131072, 384, 32


def box_corners(center, size, yaw):
    """(8, 3) cam0-frame corners of a box on the ground plane (y down):
    corners 0-3 bottom face, 4-7 top, edges c1-c0 (width), c3-c0
    (length), c4-c0 (height)."""
    w, h, l = size
    c, s = np.cos(yaw), np.sin(yaw)
    base = np.array([[-w / 2, 0, -l / 2], [w / 2, 0, -l / 2],
                     [w / 2, 0, l / 2], [-w / 2, 0, l / 2]])
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    bottom = base @ rot.T + center
    top = bottom - np.array([0, h, 0])
    return np.concatenate([bottom, top]).astype(np.float32)


def sample_in_box(rng, corners, n):
    """n points uniformly inside the parallelepiped of ``corners``."""
    c0 = corners[0]
    e = np.stack([corners[1] - c0, corners[3] - c0, corners[4] - c0])
    t = rng.uniform(0.02, 0.98, (n, 3))
    return (c0 + t @ e).astype(np.float32)


def to_velo(points_cam):
    return points_cam @ CAM_TO_VELO[:3, :3].T + CAM_TO_VELO[:3, 3]


def make_scene(rng, det_boxes, det_valid, num_points=P, num_boxes=G,
               num_valid=300, intrinsics=INTRINSICS, surround=False):
    """One frame's synthetic scan and GT boxes.

    Each valid detection gets a 3D box at 8-20 m whose projection covers
    its 2D box, filled with points; the other valid slots hold boxes
    scattered in front of the camera, some filled with points; the rest of
    the scan is background: in front of the camera, or with ``surround``
    all around the sensor at uniform azimuth, as a Velodyne sweep lies, so
    that most of it falls outside the camera's view.  Returns velodyne
    points (P, 4), point mask, cam0 corners (G, 8, 3) and box mask.
    """
    corners = np.zeros((num_boxes, 8, 3), np.float32)
    box_valid = np.zeros(num_boxes, bool)
    chunks = []
    fx, cx, cy = intrinsics[0, 0], intrinsics[0, 2], intrinsics[1, 2]
    g = 0
    for (x1, y1, x2, y2), ok in zip(det_boxes, det_valid):
        if not ok or g >= num_valid:
            continue
        z = rng.uniform(8.0, 20.0)
        xs = ((x1 - cx) * z / fx, (x2 - cx) * z / fx)
        ys = ((y1 - cy) * z / fx, (y2 - cy) * z / fx)
        c = np.array([(xs[0] + xs[1]) / 2, ys[1], z])
        size = (xs[1] - xs[0], ys[1] - ys[0], 3.0)
        corners[g] = box_corners(c, size, 0.0)
        box_valid[g] = True
        chunks.append(sample_in_box(rng, corners[g], 1024))
        g += 1
    while g < num_valid:
        c = np.array([rng.uniform(-25, 25), 1.6, rng.uniform(4, 60)])
        corners[g] = box_corners(c, (1.8, 1.5, 4.2), rng.uniform(-np.pi,
                                                                np.pi))
        box_valid[g] = True
        if g % 3 == 0:
            chunks.append(sample_in_box(rng, corners[g], 96))
        g += 1
    inside_cam = np.concatenate(chunks) if chunks else np.zeros((0, 3))
    inside_cam = inside_cam[:num_points // 2]
    n_bg = num_points - len(inside_cam) - 1024      # 1024 padding slots
    if surround:
        azimuth = rng.uniform(-np.pi, np.pi, n_bg)
        reach = rng.uniform(3, 70, n_bg)
        bg = np.stack([reach * np.sin(azimuth), rng.uniform(-3, 2, n_bg),
                       reach * np.cos(azimuth)], 1)
    else:
        bg = np.stack([rng.uniform(-40, 40, n_bg), rng.uniform(-3, 2, n_bg),
                       rng.uniform(1, 70, n_bg)], 1)
    pts_cam = np.concatenate([inside_cam, bg]).astype(np.float32)
    points = np.zeros((num_points, 4), np.float32)
    points[:len(pts_cam), :3] = to_velo(pts_cam)
    points[:len(pts_cam), 3] = rng.uniform(0, 1, len(pts_cam))
    point_valid = np.zeros(num_points, bool)
    point_valid[:len(pts_cam)] = True
    return points, point_valid, corners, box_valid


def write_calibration(root):
    """The calibration files of a KITTI-360 tree under ``root``:
    ``perspective.txt`` (INTRINSICS, 1408 x 376), the camera-to-Velodyne
    axis swap and an identity camera-to-pose."""
    calib = os.path.join(root, "calibration")
    os.makedirs(calib, exist_ok=True)
    fmt = lambda a: " ".join(repr(float(x)) for x in np.ravel(a))
    p_rect = np.concatenate([INTRINSICS, np.zeros((3, 1))], 1)
    with open(os.path.join(calib, "perspective.txt"), "w") as f:
        f.write(f"P_rect_00: {fmt(p_rect)}\nR_rect_00: {fmt(np.eye(3))}\n"
                f"S_rect_00: 1408.0 376.0\n")
    with open(os.path.join(calib, "calib_cam_to_velo.txt"), "w") as f:
        f.write(fmt(CAM_TO_VELO[:3]) + "\n")
    with open(os.path.join(calib, "calib_cam_to_pose.txt"), "w") as f:
        f.write(f"image_00: {fmt(np.eye(4)[:3])}\n")
