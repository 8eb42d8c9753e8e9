#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one CUDA card:

1. prints the PyTorch version and the card's name and power limit, and
   fails when CUDA is not available;
2. builds the CUDA kernels of ``lidar_object_detection_tpu_torch`` from the
   checkout's sources (one ``nvcc`` per source, all started together, then
   a link into one ctypes-loaded library);
3. holds each kernel against its plain PyTorch twin on the card at the
   serving path's shapes, and times both with CUDA events: K1 (inside
   counts) on the main path's batch of 4 scans, one scan, and edge cases
   (P not a multiple of a tile, D < 32, no active point, one box, every
   box invalid, points exactly on box faces, boxes whose edges are not
   orthogonal); K3/K2 (mask assembly, one launch each per batch) at
   B = 4 and B = 1 on a dense synthetic case and on the main path's own
   consensus tables, and on edge cases (a frame with no valid detection,
   D = 1, boxes off the image or with infinite or NaN coordinates, edges
   on tile borders and at fractions, guards that fire for some
   detections, a count exactly at the guard's minimum); and K5 (NMS) on
   synthetic hard cases (NaN, infinite and invalid scores, ties, IoUs an
   ulp around the threshold, N = 1024, M > N, a frame with nothing alive)
   and on the decode's real candidates of both views;
4. drives the main path through the port's entry points: the committed
   YOLO11n-seg checkpoint at its sidecar serving point (hflip TTA, guarded
   masks, BatchNorm folded, bf16) over 4 frames of 376 x 1408 (two real
   camera frames and their mirrors), then ``fuse_batch`` over synthetic
   131072-point scans with 384 box slots, then ``frame_statistics``.  The
   kernels' launch counters are zeroed just before and read just after,
   and every kernel must have run once for the batch.  The
   same network outputs are then decoded on the CPU by the twins, and the
   fusion is rerun with the plain inside-count, as references;
5. writes the same frames and scans as a KITTI-360 directory tree (the
   committed PNG files as they are, their mirrors as adaptively filtered
   PNGs, ``.bin``, box JSON, calibration; one frame without boxes, which
   the loader must skip) and runs the ``csv_eval`` entry, the erosion
   study and the CLI from it, with the YOLO detector as the CLI serves it
   (float32, unfolded weights, its own precision pinned: the script sets
   no global TF32 switch).  Every kernel must launch once in the
   csv_eval run (one batch); its detections and master CSV must equal those of the same run
   with the twin NMS.  The loader's part of the run is timed on its own;
6. runs V4, V5 and the exports through the CLI on the card from that
   tree (``run --version v4_iou``, ``run --version v5_projected
   --export-ply --analysis-cloud car_color``, ``depth-maps``), with the
   launch counters zeroed before each run and read after it: the solver
   kernel (``csrc/lap.cu``) must launch once per V5 batch.  The card's
   own detections go through the pipeline on the card and on the CPU:
   matched pairs equal, the CLI's PLY scenes, analysis clouds and
   depth-map figures byte-equal to those of the CPU run.  Then the solver
   is held to its twin on the V5 run's own costs and on seeded V5-shaped
   costs (B = 4 and 1, dense rows, R = C, R = 1, every column masked), its
   totals to scipy's, and timed beside the twin and scipy on the host;
7. serves the JAX headline (``bench.py``): the committed YOLO11x-seg
   checkpoint (its read and load timed), single view, BatchNorm folded,
   bf16, at the sidecar's guarded point, streamed by
   ``FusionPipeline.stream(chunk=8, compact=True)`` through the native
   prefetcher (built from the port's C++ source with ``g++``) into a
   ``MetricStore``, from a KITTI-360 tree of 8 frames with 360-degree
   sweeps of 122880 slots culled to the camera frustum.  Every kernel must
   launch once per chunk; the rows must equal the uncompacted stream's and
   ``run()``'s frame by frame, the store's CSV the rows'; a scan over the
   compaction capacity must raise.  It times the x forward, the stream
   (with the loader's and PNG decode's shares) and detect + fuse on the
   card at B = 8, and holds K1 (compacted scans), K5 (single view), K3 and
   K2 (x's tables) to their twins at those shapes;
8. runs PointPillars inference at the surround grid (640 x 640 pillars,
   the committed ``pp_ssd_surround`` and ``pp_center_surround``
   checkpoints at full width, 131072 points a frame) from a KITTI-360
   tree of 4 frames with pose files, each frame's sweep a different half
   of one synthetic street seen from its own pose: the CLI's
   ``pointpillars-infer --surround --aggregate-sweeps --export-ply`` with
   ``--head ssd`` (rotated-NMS decode) and ``--head center``, and
   ``infer_pointpillars(..., rotated_nms=False)`` (K5), counters zeroed
   before each: the rotated-NMS kernel (``csrc/rotated_nms.cu``) once a
   frame in the SSD run, K5 once a frame in the AABB run.  The card's
   heads are held to a CPU forward, its decodes to CPU decodes of the
   same heads, the CLI's JSON and PLY files to those written from them.
   Then the rotated NMS is held to its twin on the SSD path's own 512
   candidates of each frame and on seeded cases (B = 4, N = 512, M = 64:
   heavy overlap, all invalid, NaN scores, equal scores), IoU rows within
   1e-5, and timed; K5 on the AABB path's candidates;
9. prints one JSON line of the kernels (times, bounds, launches, errors;
   ``headline_*`` for the headline's case, ``matching_launches`` of the
   V4, V5 and depth-map runs, ``pointpillars_launches`` of the three
   PointPillars runs), the card's name and power limit, and last the
   ``{"ok": true, ...}`` line.

Any failed phase raises, and the script exits non-zero without the last
line.  It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "checkpoints", "yolo11n_seg_distill.msgpack")
# bench.py's headline detector
CKPT_X = os.path.join(REPO, "checkpoints", "yolo11x_seg_distill.msgpack")
FRAMES = [os.path.join(REPO, "artifacts", "learned_detector", "seg_overlays",
                       name) for name in ("0000000100.png", "0000002033.png")]

# Published peaks of one H100 SXM (NVIDIA's data sheet) at a 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

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
# the kernels of the serving path (detector and point-count fusion); V5's
# solver, ``lap``, launches only where a run matches by assignment
PATH_KERNELS = ("inside_counts", "mask_assemble", "mask_count", "nms")
# kernels that the serving path never launches: V5's solver and the
# PointPillars decode's rotated NMS
OFF_PATH_KERNELS = ("lap", "rotated_nms")
H0, W0 = 376, 1408
# bench.py's tight shapes: the KITTI-360 sample's largest scan (122,183
# points) padded to a multiple of 4096
P_HEADLINE = 122880


# ---------------------------------------------------------------------------
# synthetic scenes
# ---------------------------------------------------------------------------

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


def ego_pose(k):
    """The rectified-cam0 -> world pose of the k-th frame of a tree: the
    ego drives forward (+z) 1.5 m a frame, drifting right, and turns
    0.02 rad a frame about the camera's vertical axis."""
    a = 0.02 * k
    pose = np.eye(4)
    pose[:3, :3] = [[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                    [-np.sin(a), 0.0, np.cos(a)]]
    pose[:3, 3] = [0.3 * k, 0.0, 1.5 * k]
    return pose


def write_kitti360_tree(root, frames, intrinsics=INTRINSICS, width=W0,
                        height=H0):
    """A KITTI-360 directory tree (sequence 0, camera 0) under ``root``.

    ``frames`` holds ``(frame_id, image, points, corners)``: a (H, W, 3)
    uint8 image (written by the port's ``utils.png.write_png_rgb``), the
    path of a PNG file
    (copied as it is), or None (no PNG); (N, 4) float32 velodyne points, and
    (G, 8, 3) cam0 corners or None (no box JSON).  The calibration holds
    ``intrinsics``, the KITTI axis swap (CAM_TO_VELO) and an identity
    cam0 pose.  The pose files (``data_poses/<seq>/cam0_to_world.txt`` and
    ``poses.txt``, which sweep aggregation reads) give the k-th frame
    ``ego_pose(k)``.
    """
    from lidar_object_detection_tpu_torch.utils.png import write_png_rgb

    seq = "2013_05_28_drive_0000_sync"
    calib = os.path.join(root, "calibration")
    velo = os.path.join(root, "data_3d_raw", seq, "velodyne_points", "data")
    cam = os.path.join(root, "data_2d_raw", seq, "image_00", "data_rect")
    boxes = os.path.join(root, "bboxes_3D_cam0")
    for d in (calib, velo, cam, boxes):
        os.makedirs(d, exist_ok=True)
    fmt = lambda a: " ".join(repr(float(x)) for x in np.ravel(a))
    p_rect = np.concatenate([intrinsics, np.zeros((3, 1))], 1)
    with open(os.path.join(calib, "perspective.txt"), "w") as f:
        f.write(f"P_rect_00: {fmt(p_rect)}\nR_rect_00: {fmt(np.eye(3))}\n"
                f"S_rect_00: {float(width)} {float(height)}\n")
    with open(os.path.join(calib, "calib_cam_to_velo.txt"), "w") as f:
        f.write(fmt(CAM_TO_VELO[:3]) + "\n")
    with open(os.path.join(calib, "calib_cam_to_pose.txt"), "w") as f:
        f.write(f"image_00: {fmt(np.eye(4)[:3])}\n")
    poses = os.path.join(root, "data_poses", seq)
    os.makedirs(poses, exist_ok=True)
    ids = [frame_id for frame_id, *_ in frames]
    with open(os.path.join(poses, "cam0_to_world.txt"), "w") as f:
        f.writelines(f"{i} {fmt(ego_pose(k))}\n" for k, i in enumerate(ids))
    # camera 0 is the pose frame here (identity cam_to_pose and R_rect)
    with open(os.path.join(poses, "poses.txt"), "w") as f:
        f.writelines(f"{i} {fmt(ego_pose(k)[:3])}\n"
                     for k, i in enumerate(ids))
    for frame_id, image, points, corners in frames:
        points.astype(np.float32).tofile(
            os.path.join(velo, "%010d.bin" % frame_id))
        png = os.path.join(cam, "%010d.png" % frame_id)
        if isinstance(image, str):
            shutil.copyfile(image, png)
        elif image is not None:
            write_png_rgb(png, image)
        if corners is not None:
            with open(os.path.join(boxes, f"BBoxes_{frame_id}.json"),
                      "w") as f:
                json.dump([{"index": g, "corners_cam0": c.tolist()}
                           for g, c in enumerate(corners)], f)


def nms_case(rng, batch, n, iou_threshold=0.7):
    """Random NMS candidates (boxes (B, N, 4), scores (B, N), valid (B, N),
    float32 numpy) with the hard cases in every frame: NaN and +-inf
    scores, invalid candidates, tied scores, and pairs whose float32 IoU
    sits exactly at the threshold and one ulp to either side of it."""
    xy = rng.uniform(0, 600, (batch, n, 2))
    wh = rng.uniform(8, 120, (batch, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    # clusters: copies of a few boxes with small shifts overlap heavily
    for b in range(batch):
        src = rng.integers(0, n, n // 4)
        dst = rng.integers(0, n, n // 4)
        boxes[b, dst] = boxes[b, src] + rng.normal(0, 3, (n // 4, 4))
    scores = rng.uniform(0, 0.99, (batch, n)).astype(np.float32)
    valid = rng.random((batch, n)) > 0.15
    thr = np.float32(iou_threshold)
    # boxes (0, 0, 100, H) and (0, 0, 100, h), h < H: in the operation
    # order of geom.boxes.iou_2d_matrix, inter = 100 h and
    # union = (100 H + 100 h) - inter, each rounded to float32
    big = np.float32(np.linspace(80, 120, 4001))[:, None]
    small = (big * thr + np.arange(-8, 9, dtype=np.float32)
             * np.spacing(big * thr)).astype(np.float32)
    hundred = np.float32(100)
    inter = hundred * small
    union = (hundred * big + hundred * small) - inter
    iou = inter / union
    picks = []
    for t in (np.nextafter(thr, np.float32(0)), thr,
              np.nextafter(thr, np.float32(1))):
        i, j = np.argwhere(iou == t)[0]
        picks.append((big[i, 0], small[i, j]))
    if n < 12:
        raise ValueError(f"nms_case needs n >= 12, got {n}")
    for b in range(batch):
        base = 5 * b % (n - 11)
        for j, (hi, lo) in enumerate(picks):
            off = np.float32(700 + 150 * j)
            boxes[b, base + 2 * j] = (off, 0, off + 100, hi)
            boxes[b, base + 2 * j + 1] = (off, 0, off + 100, lo)
            scores[b, base + 2 * j] = 0.999
            scores[b, base + 2 * j + 1] = 0.998
            valid[b, base + 2 * j:base + 2 * j + 2] = True
        others = np.setdiff1d(np.arange(n), np.arange(base, base + 6))
        special = rng.choice(others, 6, replace=False)
        scores[b, special[0]] = np.nan
        scores[b, special[1]] = np.inf
        scores[b, special[2]] = -np.inf
        scores[b, special[3:]] = scores[b, special[3]]   # a tie
    return boxes, scores, valid


def mask_table(rng, batch, d, mh, mw):
    """Smooth random probability tables (B, D, mh, mw) float32: a product
    of sines through a sigmoid, so that a 0.99 cut leaves some detections
    near-empty and the guard fires for them."""
    yy = np.linspace(0, 1, mh)[None, None, :, None]
    xx = np.linspace(0, 1, mw)[None, None, None, :]
    fy = rng.uniform(1, 6, (batch, d, 1, 1))
    fx = rng.uniform(1, 12, (batch, d, 1, 1))
    amp = rng.uniform(2, 9, (batch, d, 1, 1))
    return (1 / (1 + np.exp(-amp * np.sin(fy * 3 * yy + fx)
                            * np.cos(fx * 2 * xx)))).astype(np.float32)


def mask_cases(rng, h=H0, w=W0, mh=42, mw=160):
    """Operands of K2/K3 at an h x w frame: name -> (table (B, D, mh, mw)
    float32, boxes (B, D, 4) float32 xyxy, valid (B, D) bool).

    * dense: 32 slots, 85 % valid, boxes up to 0.43 w x 0.8 h (600 x 300
      at 1408 x 376), at B = 4 and its first frame at B = 1;
    * a frame with no valid detection beside one with some;
    * D = 1;
    * boxes partly or wholly off the image, infinite and NaN coordinates,
      the whole frame;
    * edges on tile and 4-column borders, a hair inside them, at
      fractional coordinates, boxes thinner than a pixel.
    """
    def boxes_of(batch, d):
        x1 = rng.uniform(0, 0.93 * w, (batch, d))
        y1 = rng.uniform(0, 0.84 * h, (batch, d))
        return np.stack([x1, y1, x1 + rng.uniform(0.03 * w, 0.43 * w,
                                                  (batch, d)),
                         y1 + rng.uniform(0.08 * h, 0.8 * h, (batch, d))],
                        -1).astype(np.float32)

    def fixed(rows):
        boxes = boxes_of(1, D)
        boxes[0, :len(rows)] = np.array(rows, np.float32)
        return (mask_table(rng, 1, D, mh, mw), boxes, np.ones((1, D), bool))

    dense = (mask_table(rng, 4, D, mh, mw), boxes_of(4, D),
             rng.random((4, D)) > 0.15)
    none = (dense[0][:2].copy(), dense[1][:2].copy(), dense[2][:2].copy())
    none[2][0] = False
    inf, nan = np.inf, np.nan
    off = fixed([[-50, -20, 0.3 * w, 0.4 * h],
                 [0.8 * w, 0.7 * h, w + 100, h + 50],
                 [w + 5, 10, w + 200, 40], [-300, -100, -1, -2],
                 [10, h, 100, h + 40], [-inf, 0.2 * h, 0.2 * w, inf],
                 [nan, 10, 100, 50], [20, 10, 120, nan], [0, 0, w, h],
                 [w - 1, 0, w + 1, h]])
    borders = fixed([[4, 8, 68, 16], [3.5, 7.5, 67.5, 15.5],
                     [4.0001, 8.0001, 64.9999, 23.9999], [0, 0, 4, 1],
                     [w - 4, h - 1, w, h], [1.25, 2.75, 9.75, 3.25],
                     [5, 5, 5.5, 9], [6.2, 6.2, 6.8, 6.8],
                     [16, 32, 16, 40], [0.5, 0.5, w - 0.5, h - 0.5]])
    return {
        "dense B=4": dense,
        "dense B=1": tuple(a[:1] for a in dense),
        "no valid detection": none,
        "D=1": (mask_table(rng, 2, 1, mh, mw), boxes_of(2, 1),
                np.ones((2, 1), bool)),
        "off the image": off,
        "borders and fractions": borders,
    }

def lap_case(rng, batch, r=D, c=G, row_share=0.4, col_share=0.1):
    """V5-shaped assignment operands (numpy): costs (B, R, C) float32 of 1
    - score, scores in [0, 1) (every third frame rounded to quarters, so
    that many costs tie), and sparse row (B, R) and column (B, C) masks,
    row 0 of each frame real."""
    cost = (1.0 - rng.random((batch, r, c))).astype(np.float32)
    cost[::3] = np.round(cost[::3] * 4) / 4
    row_mask = rng.random((batch, r)) < row_share
    row_mask[:, 0] = True
    col_mask = rng.random((batch, c)) < col_share
    return cost, row_mask, col_mask

# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_gpu(fn, reps=20, warmup=3, head_start=True):
    """Median milliseconds of ``fn`` on the card, CUDA events around each
    call.  With ``head_start`` the card first sleeps ~1 ms so that the
    host's launch overhead is not timed: the call is queued before the
    start event is reached."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if head_start:
            torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_events(torch, fn, iters=10):
    """(ms per call of ``fn`` back to back, CUDA events around ``iters``
    calls after one warm-up, and the last call's result)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, out


def bound_ms(n_bytes, n_ops):
    """The least time for the work: bytes at the memory rate or fp32
    operations at the peak rate, whichever is larger."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def phase(name, t0):
    print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s", flush=True)


# ---------------------------------------------------------------------------
# kernels against their twins
# ---------------------------------------------------------------------------

def random_words(rng, point_valid, share=0.5):
    """Random 32-bit membership words for ``share`` of the valid points,
    as int32 (0 elsewhere)."""
    n = len(point_valid)
    words = rng.integers(0, 2 ** 32, n, dtype=np.uint64)
    words = np.where(rng.random(n) < share, words, 0) \
        * point_valid.astype(np.uint64)
    return words.astype(np.uint32).view(np.int32)


def face_case(rng, num_points=4099):
    """Points exactly on the faces of axis-aligned boxes whose frames are
    exact in float32 (edges 2, 4 and 1 m from corners on a 1/8 m grid), so
    that projections equal 0 and 1, and points one ulp to either side of
    a face, whose projections round to either side of 0 or 1.
    Returns velodyne points (P, 3), words (P,), corners (G, 8, 3) and the
    box mask."""
    g = 6
    c0 = np.array([[8 * i, -3, -1] for i in range(g)], np.float32) \
        + rng.integers(0, 16, (g, 3)).astype(np.float32) / 8
    edges = np.diag(np.array([2.0, 4.0, 1.0], np.float32))
    corners = np.zeros((g, 8, 3), np.float32)
    for i, j in ((1, 0), (3, 1), (4, 2)):
        corners[:, i] = c0 + edges[j]
    corners[:, 0] = c0
    corners[:, 2] = c0 + edges[0] + edges[1]
    for i in range(4):
        corners[:, 4 + i] = corners[:, i] + edges[2]
    box = rng.integers(0, g, num_points)
    # each coordinate at a face (0 or 1), one ulp outside or inside it, or
    # strictly inside
    t = rng.integers(0, 6, (num_points, 3))
    lo, hi = c0[box], c0[box] + np.diag(edges)[None, :]
    pts = np.where(t == 0, lo, np.where(t == 1, hi, (lo + hi) / 2))
    pts = np.where(t == 2, np.nextafter(lo, -np.inf), pts)
    pts = np.where(t == 3, np.nextafter(hi, np.inf), pts)
    pts = np.where(t == 4, np.nextafter(lo, np.inf), pts).astype(np.float32)
    words = rng.integers(1, 2 ** 32, num_points, dtype=np.uint64)
    return (pts, words.astype(np.uint32).view(np.int32), corners,
            np.ones(g, bool))


def skew_case(rng, skew, num_boxes=24, num_points=6151):
    """Boxes whose edges are not orthogonal (``skew``: the cosine between
    the first two edges), with points around the faces of the region the
    frame's three slabs hold, which reaches past the corners' bounds.
    Returns velodyne points (P, 3), words (P,), corners (G, 8, 3) and the
    box mask."""
    corners = np.zeros((num_boxes, 8, 3), np.float64)
    duals = []
    for g in range(num_boxes):
        c0 = np.array([6.0 * g - 70, rng.uniform(-5, 5), -1.0])
        yaw = rng.uniform(-np.pi, np.pi)
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                        [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        e1 = rot @ np.array([4.2, 0, 0])
        e2 = rot @ (1.8 * np.array([skew, np.sqrt(1 - skew ** 2), 0]))
        e3 = np.array([0, 0, 1.5])
        corners[g, 0] = c0
        corners[g, 1], corners[g, 3], corners[g, 4] = c0 + e1, c0 + e2, \
            c0 + e3
        corners[g, 2] = c0 + e1 + e2
        corners[g, 5:] = corners[g, [1, 2, 3]] + e3
        edges = np.stack([e1, e2, e3])
        axes = edges / (edges ** 2).sum(1, keepdims=True)
        duals.append((c0, np.linalg.inv(axes)))
    box = rng.integers(0, num_boxes, num_points)
    # slab coordinates near 0 and 1, inside and out
    t = rng.choice([-0.02, -1e-4, 0.0, 1e-4, 0.5, 1 - 1e-4, 1.0, 1.02],
                   (num_points, 3)) + rng.normal(0, 1e-3, (num_points, 3))
    pts = np.stack([duals[g][0] + duals[g][1] @ t[i]
                    for i, g in enumerate(box)])
    words = rng.integers(1, 2 ** 32, num_points, dtype=np.uint64)
    return (pts.astype(np.float32), words.astype(np.uint32).view(np.int32),
            corners.astype(np.float32), np.ones(num_boxes, bool))


def k1_launcher(torch, dev, pts, bits, corners, mask, d=D):
    """A call of K1's C entry point alone on prepared operands, for
    timing: no launch counted, no output checked."""
    from lidar_object_detection_tpu_torch.geom.boxes import masked_box_frame
    from lidar_object_detection_tpu_torch.ops import kernel_lib

    lib = kernel_lib.library()
    sms = kernel_lib.sm_count(dev)
    b, p = bits.shape
    g = corners.shape[1]
    axes, offsets = masked_box_frame(corners, mask)
    frame = torch.cat([axes, offsets[..., None]], -1).reshape(b, g, 12)
    frame = frame.contiguous()
    c_out = torch.zeros((b, d, g), dtype=torch.int32, device=dev)
    t_out = torch.zeros((b, d), dtype=torch.int32, device=dev)

    def run():
        kernel_lib.check(lib.inside_counts_launch(
            pts.data_ptr(), bits.data_ptr(), frame.data_ptr(),
            corners.data_ptr(), mask.data_ptr(), b, p, g, d,
            c_out.data_ptr(), t_out.data_ptr(), sms,
            kernel_lib.stream_handle(dev)), "inside_counts_launch")
    return run


def k1_bytes(bits, mask, d=D):
    """The bytes K1's function must move: every membership word read once,
    the coordinates of the active points only (a point whose word is 0
    needs none), counted in the 32-byte sectors they lie in, the valid
    boxes' corners, the box mask, and the counts written once."""
    import torch

    b, p = bits.shape
    g = mask.shape[1]
    frame, point = (bits != 0).nonzero(as_tuple=True)
    first = (frame * p + point) * 12           # (B, P, 3) float32
    sectors = torch.cat([first // 32, (first + 11) // 32]).unique().numel()
    return (b * p * 4 + sectors * 32 + int(mask.sum()) * 8 * 3 * 4
            + b * (g + d * g * 4 + d * 4))


def k1_bound(pts, bits, corners, mask, d=D):
    """K1's bound: 15 operations per (active point, valid box) pair of
    each frame (an invalid box holds no point by definition, so the
    function does no work for it), and ``k1_bytes``.  Returns (active
    points, pairs, (ms, by))."""
    active = (bits != 0).sum(dim=1)
    pairs = int((active * mask.sum(dim=1)).sum())
    return int(active.sum()), pairs, bound_ms(k1_bytes(bits, mask, d),
                                              pairs * 15)


def nms_launcher(torch, dev, bx, sc, va, thr, m):
    """A call of K5's C entry point alone, for timing."""
    from lidar_object_detection_tpu_torch.ops import kernel_lib

    lib = kernel_lib.library()
    b, n = sc.shape
    out_idx = torch.empty((b, m), dtype=torch.int64, device=dev)
    out_keep = torch.empty((b, m), dtype=torch.bool, device=dev)

    def run():
        kernel_lib.check(lib.nms_launch(
            bx.data_ptr(), sc.data_ptr(), va.data_ptr(), b, n, m, thr,
            out_idx.data_ptr(), out_keep.data_ptr(),
            kernel_lib.stream_handle(dev)), "nms_launch")
    return run


def nms_bound(picks, b, n, m):
    """K5's bound.  Greedy NMS needs the IoU of each pick with the n
    candidates, not the full (n, n) matrix: 11 operations per (pick,
    candidate) pair (2 min, 2 max, 4 add or subtract, 1 multiply, 1
    divide, 1 compare with the threshold), 3 per box for its area, and n
    compares per argmax step; a frame makes one step per pick and one more
    that finds none left.  ``picks`` holds each frame's kept count."""
    n_ops = sum(k * n * 11 + min(k + 1, m) * n + 3 * n for k in picks)
    n_bytes = b * n * (16 + 4 + 1) + b * m * (8 + 1)
    return bound_ms(n_bytes, n_ops)


def check_inside_counts(torch, dev, rng, scenes):
    """K1 against its twin: the main path's batch of 4 scenes, a single
    frame with 32 detections in a row, and edge cases; timed at B = 4 (the
    main path's one launch per batch) and at B = 1 on the single frame."""
    from lidar_object_detection_tpu_torch.geom.boxes import (
        transform_corners)
    from lidar_object_detection_tpu_torch.ops import inside_counts as ic

    cam_to_velo = torch.from_numpy(CAM_TO_VELO)

    def batch_of(frames):
        pts, words, corners, mask = zip(*frames)
        return (torch.from_numpy(np.stack(pts)).to(dev).contiguous(),
                torch.from_numpy(np.stack(words)).to(dev),
                torch.from_numpy(np.stack(corners)).to(dev).contiguous(),
                torch.from_numpy(np.stack(mask)).to(dev))

    def frame_of(points, pvalid, corners_cam, bvalid, share=0.5):
        velo = transform_corners(torch.from_numpy(corners_cam), cam_to_velo)
        return (np.ascontiguousarray(points[:, :3]),
                random_words(rng, pvalid, share), velo.numpy(), bvalid)

    # the main path's scenes; a single frame (32 detections in a row)
    main = batch_of([frame_of(*s) for s in scenes])
    dets = np.stack([np.array([x, 150, x + 120, 260], np.float32)
                     for x in np.linspace(50, 1250, D)])
    one = batch_of([frame_of(*make_scene(rng, dets, np.ones(D, bool)))])
    # edge cases
    odd_p = [frame_of(*make_scene(rng, dets, np.ones(D, bool),
                                  num_points=100003)) for _ in range(2)]
    face = face_case(rng)
    skewed = batch_of([skew_case(rng, 0.4), skew_case(rng, 3e-4)])
    cases = {
        "main B=4": (main, D),
        "single frame B=1": (one, D),
        "P=100003 B=2": (batch_of(odd_p), D),
        "D=5": (main, 5),
        "D=1": (one, 1),
        "all-zero words": ((main[0], torch.zeros_like(main[1])) + main[2:],
                           D),
        "G=1": ((main[0], main[1], main[2][:, :1].contiguous(),
                 torch.ones_like(main[3][:, :1])), D),
        "every box invalid": (main[:3] + (torch.zeros_like(main[3]),), D),
        "points on faces": (batch_of([face]), D),
        "skewed boxes": (skewed, D),
    }
    mismatches, compared, max_err, hits, failed = 0, 0, 0, {}, []
    for name, (args, d) in cases.items():
        counts, totals = ic.inside_counts_cuda(*args, d)
        ref_counts, ref_totals = ic.inside_counts_plain(*args, d)
        torch.cuda.synchronize()
        bad = int((counts != ref_counts).sum() + (totals != ref_totals).sum())
        mismatches += bad
        compared += counts.numel() + totals.numel()
        if bad:
            failed.append(f"{name}: {bad}")
        max_err = max(max_err, int((counts - ref_counts).abs().max()),
                      int((totals - ref_totals).abs().max()))
        hits[name] = int(counts.sum())
    if mismatches:
        raise AssertionError(f"K1 differs from its twin in {mismatches} of "
                             f"{compared} entries ({failed})")
    if hits["main B=4"] == 0 or hits["single frame B=1"] == 0 \
            or hits["points on faces"] == 0 or hits["skewed boxes"] == 0:
        raise AssertionError(f"K1 check is degenerate: hits {hits}")
    if hits["all-zero words"] or hits["every box invalid"]:
        raise AssertionError(f"K1 counted points it must not: {hits}")

    launcher = lambda *args: k1_launcher(torch, dev, *args)
    bound_of = k1_bound

    ms = time_gpu(launcher(*main))
    ms_one = time_gpu(launcher(*one))
    plain_ms = time_gpu(lambda: ic.inside_counts_plain(*main, D), reps=10,
                        head_start=False)
    active, pairs, (bound, by) = bound_of(*main)
    active_one, pairs_one, (bound_one, _) = bound_of(*one)
    print(f"K1 inside_counts: equal to the twin on {len(cases)} cases, "
          f"{compared} entries (hits {hits}); B=4: {ms:.4f} ms for {active} "
          f"active points, {pairs} (active point, valid box) pairs (twin "
          f"{plain_ms:.4f}, bound {bound:.4g} by {by}); B=1: {ms_one:.4f} "
          f"ms for {active_one} active points, {pairs_one} pairs (bound "
          f"{bound_one:.4g})", flush=True)
    return {"name": "inside_counts", "route": "cuda",
            "source": "lidar_object_detection_tpu_torch/csrc/"
                      "inside_counts.cu",
            "replaces": "lidar_object_detection_tpu/ops/pallas_count.py:76",
            "max_abs_err": max_err, "mismatches": mismatches,
            "compared": compared, "ms": ms,
            "kernel_ms": ms, "ms_b1": ms_one, "bound_ms_b1": bound_one,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def mask_bound(ops, count):
    """Bound of K3 (``count``) or K2 on ``ops``.

    Bytes: for each valid box with pixels, the table rows y0[cy0] ..
    y0[cy1 - 1] + 1 and columns x0[cx0] .. x0[cx1 - 1] + 1 that its pixel
    range [cx0, cx1) x [cy0, cy1) reaches; the taps of the output rows and
    columns some box covers; every slot's box, flag and cut; the counts
    written (K3) or read (K2) and, for K2, the words written once.
    Operations: 3 for each (output row, reached table column) of a box
    (the y interpolation, shared by the row's pixels) and 4 for each
    (pixel, detection) pair inside a valid box (the x interpolation and
    the compare)."""
    b, d, mh, mw = ops.table.shape
    h, w = ops.shape
    y0 = ops.y0.cpu().numpy()
    x0 = ops.x0.cpu().numpy()
    bx = ops.boxes.cpu().numpy().astype(np.float64)
    ok = ops.valid.cpu().numpy() & (bx[..., 0] < bx[..., 2]) \
        & (bx[..., 1] < bx[..., 3])
    cx = np.clip(np.ceil(np.nan_to_num(bx[..., [0, 2]])), 0, w).astype(int)
    cy = np.clip(np.ceil(np.nan_to_num(bx[..., [1, 3]])), 0, h).astype(int)
    table_bytes, ops_count = 0, 0.0
    row_used = np.zeros(h, bool)
    col_used = np.zeros(w, bool)
    for i in zip(*np.nonzero(ok & (cx[..., 0] < cx[..., 1])
                             & (cy[..., 0] < cy[..., 1]))):
        (xa, xb), (ya, yb) = cx[i], cy[i]
        n_rows = min(y0[yb - 1] + 1, mh - 1) - y0[ya] + 1
        n_cols = min(x0[xb - 1] + 1, mw - 1) - x0[xa] + 1
        table_bytes += n_rows * n_cols * 4
        ops_count += 3 * (yb - ya) * n_cols + 4 * (yb - ya) * (xb - xa)
        row_used[ya:yb] = True
        col_used[xa:xb] = True
    n_bytes = table_bytes + (int(row_used.sum()) + int(col_used.sum())) * 12 \
        + b * d * (16 + 1 + 4) + b * d * 4
    if not count:
        n_bytes += b * h * w * 4
    return bound_ms(n_bytes, ops_count)


def check_mask_kernels(torch, dev, rng, detector, images):
    """K3 and K2 against their twins, one launch each per batch, on the
    dense synthetic case and the main path's own consensus tables at B = 4
    and B = 1, and on the edge cases of ``mask_cases``: K2 with the plain
    cut, with the serving guard and with a guard whose ``min_pixels``
    equals a count.  Timed at B = 4 and B = 1 on the dense and the
    main-path case."""
    from lidar_object_detection_tpu_torch.models.yolo.postprocess import (
        postprocess_batch)
    from lidar_object_detection_tpu_torch.models.yolo.tta import (
        consensus_tables)
    from lidar_object_detection_tpu_torch.ops import mask_assembly as ma

    p = detector.params
    thr, floor, min_pixels = (p.mask_threshold, p.mask_threshold_floor,
                              p.mask_min_pixels)
    outputs = detector.forward(images)
    det = postprocess_batch(outputs, p, masks=False)
    b = len(images)
    main = (consensus_tables(det, outputs["proto"], p,
                             detector.tta_match_iou),
            det["boxes"][:b], det["det_valid"][:b])
    cases = {name: tuple(torch.from_numpy(a).to(dev) for a in arrays)
             for name, arrays in mask_cases(rng).items()}
    cases["main path B=4"] = main
    cases["main path B=1"] = tuple(a[:1] for a in main)
    ops_of = {name: ma.prepare_operands(*args, H0, W0, thr)
              for name, args in cases.items()}
    bad = {"mask_count": 0, "mask_assemble": 0}
    compared = {"mask_count": 0, "mask_assemble": 0}
    k3_err, k2_err, failed, stats = 0, 0, [], {}
    for name, ops in ops_of.items():
        counts = ma.count_above_cuda(ops)
        ref_counts = ma.count_above_plain(ops)
        n_bad = int((counts != ref_counts).sum())
        if counts.numel():
            k3_err = max(k3_err, int((counts - ref_counts).abs().max()))
        nonzero = counts[counts > 0]
        at = int(nonzero.min()) if nonzero.numel() else 1
        words_bad = 0
        for guard in (None, ma.Guard(counts, floor, min_pixels),
                      ma.Guard(counts, floor, at)):
            words = ma.assemble_masks_cuda(ops, guard)
            ref_words = ma.assemble_masks_plain(ops, guard)
            words_bad += int((words != ref_words).sum())
            # the largest difference of any one mask bit (0 or 1)
            k2_err = max(k2_err, int((words ^ ref_words).ne(0).any()))
            compared["mask_assemble"] += words.numel()
        torch.cuda.synchronize()
        bad["mask_count"] += n_bad
        bad["mask_assemble"] += words_bad
        compared["mask_count"] += counts.numel()
        if n_bad or words_bad:
            failed.append(f"{name}: {n_bad} counts, {words_bad} words")
        under = (ref_counts < min_pixels) & ops.valid
        stats[name] = {"valid": int(ops.valid.sum()),
                       "guard fires": int(under.sum()),
                       "guard keeps": int((~under & ops.valid).sum()),
                       "pixels": int(ref_counts.sum())}
    if failed:
        raise AssertionError(f"K3/K2 differ from their twins: {bad} "
                             f"({failed})")
    dense, real = stats["dense B=4"], stats["main path B=4"]
    if not (dense["guard fires"] and dense["guard keeps"]) \
            or real["pixels"] == 0 or stats["D=1"]["pixels"] == 0 \
            or stats["off the image"]["pixels"] == 0 \
            or stats["borders and fractions"]["pixels"] == 0:
        raise AssertionError(f"mask check is degenerate: {stats}")

    def timer(name, ops):
        out = torch.empty((ops.table.shape[0], H0, W0), dtype=torch.int32,
                          device=dev)
        counts = torch.zeros(ops.table.shape[:2], dtype=torch.int32,
                             device=dev)
        guard = ma.Guard(ma.count_above_plain(ops), floor, min_pixels)
        if name == "mask_count":
            return lambda: ma.launch("mask_count_launch", ops, counts)
        return lambda: ma.launch("mask_assemble_launch", ops, out, guard)

    timed = {"": "main path B=4", "_b1": "main path B=1",
             "_synthetic": "dense B=4", "_synthetic_b1": "dense B=1"}
    entries = []
    src = "lidar_object_detection_tpu_torch/csrc/mask_assembly.cu"
    for name, line, err in (("mask_count", 282, k3_err),
                            ("mask_assemble", 246, k2_err)):
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": "lidar_object_detection_tpu/ops/"
                             f"pallas_masks.py:{line}",
                 "max_abs_err": err, "mismatches": bad[name],
                 "compared": compared[name], "cases": len(ops_of)}
        for suffix, case in timed.items():
            ops = ops_of[case]
            entry["ms" + suffix] = time_gpu(timer(name, ops))
            entry["bound_ms" + suffix], by = mask_bound(
                ops, name == "mask_count")
            if not suffix:
                entry["bound_by"] = by
        entry["kernel_ms"] = entry["ms"]
        main_ops = ops_of["main path B=4"]
        if name == "mask_count":
            plain = lambda: ma.count_above_plain(main_ops)
        else:
            guard = ma.Guard(ma.count_above_plain(main_ops), floor,
                             min_pixels)
            plain = lambda: ma.assemble_masks_plain(main_ops, guard)
        entry["plain_ms"] = time_gpu(plain, reps=10, head_start=False)
        entry["library_ms"] = None
        entries.append(entry)
        print(f"{name}: equal to the twin on {len(ops_of)} cases "
              f"({compared[name]} entries); main path B=4 "
              f"{entry['ms']:.4f} ms (bound {entry['bound_ms']:.4g} by "
              f"{entry['bound_by']}), B=1 {entry['ms_b1']:.4f} (bound "
              f"{entry['bound_ms_b1']:.4g}); dense B=4 "
              f"{entry['ms_synthetic']:.4f} (bound "
              f"{entry['bound_ms_synthetic']:.4g}), B=1 "
              f"{entry['ms_synthetic_b1']:.4f} (bound "
              f"{entry['bound_ms_synthetic_b1']:.4g}); twin "
              f"{entry['plain_ms']:.4f}", flush=True)
    print(f"mask cases: {stats}", flush=True)
    return entries


def check_nms(torch, dev, rng, detector, images):
    """K5 against its twin: synthetic hard cases at B = 8, N = 1024, M > N,
    a frame with nothing alive, and the real candidates of the main path's
    decode (both views, 2B frames); timed on those 2B frames, the one
    launch the main path makes per batch."""
    from lidar_object_detection_tpu_torch.models.yolo.postprocess import (
        nms_candidates)
    from lidar_object_detection_tpu_torch.ops import nms as nms_lib

    p = detector.params
    thr, m = p.iou_threshold, p.max_detections
    on_card = lambda arrays: tuple(torch.from_numpy(a).to(dev)
                                   for a in arrays)
    outputs = detector.forward(images)
    _, real_boxes, real_scores, real_valid = nms_candidates(outputs, p)
    real = (real_boxes.contiguous(), real_scores.contiguous(),
            real_valid.contiguous())
    dead = list(on_card(nms_case(rng, 4, 256, thr)))
    dead[2] = dead[2].clone()
    dead[2][1] = False                     # frame 1: nothing alive
    cases = {
        "synthetic B=8": (on_card(nms_case(rng, 8, 256, thr)), m),
        "N=1024": (on_card(nms_case(rng, 3, 1024, thr)), 40),
        "M>N": (on_card(nms_case(rng, 2, 20, thr)), 32),
        "nothing alive": (tuple(dead), m),
        "decode 2B": (real, m),
    }
    kept, mismatches, compared, max_err, failed = {}, 0, 0, 0, []
    for name, ((bx, sc, va), mm) in cases.items():
        idx, keep = nms_lib.nms_cuda(bx, sc, va, thr, mm)
        ref_idx, ref_keep = nms_lib.nms_plain(bx, sc, va, thr, mm)
        torch.cuda.synchronize()
        bad = int((idx != ref_idx).sum() + (keep != ref_keep).sum())
        mismatches += bad
        compared += idx.numel() + keep.numel()
        if bad:
            failed.append(f"{name}: {bad}")
        # the largest difference of a picked index or a keep flag
        max_err = max(max_err, int((idx - ref_idx).abs().max()),
                      int((keep != ref_keep).any()))
        kept[name] = keep.sum(dim=1).tolist()
    if mismatches:
        raise AssertionError(f"K5 differs from its twin in {mismatches} of "
                             f"{compared} slots ({failed})")
    if sum(kept["decode 2B"]) == 0 or sum(kept["synthetic B=8"]) < 8 \
            or kept["nothing alive"][1] != 0:
        raise AssertionError(f"K5 check is degenerate: kept {kept}")

    bx, sc, va = real
    b, n = sc.shape
    ms = time_gpu(nms_launcher(torch, dev, bx, sc, va, thr, m))
    plain_ms = time_gpu(lambda: nms_lib.nms_plain(bx, sc, va, thr, m),
                        reps=10, head_start=False)
    picks = kept["decode 2B"]
    bound, by = nms_bound(picks, b, n, m)
    print(f"K5 nms: equal to the twin on {len(cases)} cases, {compared} "
          f"slots (kept "
          f"{kept}); {ms:.4f} ms (twin {plain_ms:.4f}, bound {bound:.3g} "
          f"by {by}) for {b} frames x {n} candidates, {picks} picks",
          flush=True)
    return {"name": "nms", "route": "cuda",
            "source": "lidar_object_detection_tpu_torch/csrc/nms.cu",
            "replaces": "lidar_object_detection_tpu/ops/pallas_nms.py:74",
            "max_abs_err": max_err, "mismatches": mismatches,
            "compared": compared, "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def lap_launcher(torch, dev, cost, row_mask, col_mask):
    """A call of the solver's C entry point alone, for timing."""
    from lidar_object_detection_tpu_torch.ops import kernel_lib

    lib = kernel_lib.library()
    b, r, c = cost.shape
    out = torch.empty((b, r), dtype=torch.int32, device=dev)

    def run():
        kernel_lib.check(lib.lap_launch(
            cost.data_ptr(), row_mask.data_ptr(), col_mask.data_ptr(), b, r,
            c, out.data_ptr(), kernel_lib.stream_handle(dev)), "lap_launch")
    return run


def lap_bound(cost, scans):
    """The solver's bound on these inputs.  Bytes: the costs, both masks
    and col4row, each once.  Operations: 6 per column for each column a
    Dijkstra step scans (the candidate's 3 adds, its compare, the select
    and the argmin's compare), with each frame's scanned columns from the
    twin (``lap_plain(..., return_scans=True)``)."""
    b, r, c = cost.shape
    n_bytes = b * r * c * 4 + b * r + b * c + b * r * 4
    return bound_ms(n_bytes, 6 * c * int(scans.sum()))


def scipy_total(cost, row_mask, col_mask):
    """Per frame, scipy's optimal total on the real rows and columns, and
    the real pairs' total of each given assignment; float64."""
    from scipy.optimize import linear_sum_assignment

    out = []
    for b in range(cost.shape[0]):
        rows = np.nonzero(row_mask[b])[0]
        cols = np.nonzero(col_mask[b])[0]
        real = cost[b][np.ix_(rows, cols)].astype(np.float64)
        sr, sc = linear_sum_assignment(real)
        out.append(real[sr, sc].sum())
    return np.asarray(out)


def check_lap(torch, dev, rng, path):
    """The assignment solver against its twin: the V5 run's own costs
    (``path``: the csv_eval tree's batch of 4, and its first frame) and
    seeded V5-shaped costs at B = 4 and 1, with dense rows, R = C, R = 1
    and every column masked (all costs tie).  Every row's column must
    equal the twin's, and on the real rows and columns the assignment's
    total must equal scipy's optimum (within 1e-5, float32 costs summed in
    float64).  Timed at B = 4 and 1 (seeded) and on the path's batch;
    beside it the twin on the card and scipy on the host."""
    from lidar_object_detection_tpu_torch.ops import lap as lap_lib

    on_card = lambda arrays: tuple(torch.from_numpy(a).to(dev)
                                   for a in arrays)
    seeded = on_card(lap_case(rng, 4))
    cases = {
        "V5 path B=4": path,
        "V5 path B=1": tuple(a[:1] for a in path),
        "seeded B=4": seeded,
        "seeded B=1": tuple(a[:1] for a in seeded),
        "dense rows": on_card(lap_case(rng, 2, row_share=1.0, col_share=0.5)),
        "R=C=32": on_card(lap_case(rng, 3, D, D, 1.0, 1.0)),
        "R=1": on_card(lap_case(rng, 3, 1, 7, 1.0, 0.5)),
        "every column masked": on_card(lap_case(rng, 2, col_share=0.0)),
    }
    mismatches, compared, failed, scans_of, gap = 0, 0, [], {}, 0.0
    for name, (cost, rmask, cmask) in cases.items():
        got = lap_lib.lap_cuda(cost, rmask, cmask)
        ref, scans = lap_lib.lap_plain(cost, rmask, cmask, return_scans=True)
        torch.cuda.synchronize()
        bad = int((got != ref).sum())
        mismatches += bad
        compared += got.numel()
        scans_of[name] = scans.tolist()
        if bad:
            failed.append(f"{name}: {bad}")
        c_np, r_np, k_np = (a.cpu().numpy() for a in (cost, rmask, cmask))
        col4row = got.cpu().numpy()
        for b in range(c_np.shape[0]):
            pairs = [(i, j) for i, j in enumerate(col4row[b])
                     if r_np[b, i] and k_np[b, j]]
            total = sum(float(c_np[b, i, j]) for i, j in pairs)
            best = scipy_total(c_np[b:b + 1], r_np[b:b + 1], k_np[b:b + 1])
            gap = max(gap, abs(total - float(best[0])))
            if len(set(col4row[b].tolist())) != col4row.shape[1]:
                failed.append(f"{name}: a column assigned twice")
    if mismatches or failed:
        raise AssertionError(f"the solver differs from its twin in "
                             f"{mismatches} of {compared} rows ({failed})")
    if gap > 1e-5:
        raise AssertionError(f"the solver's total is {gap} off scipy's")
    if sum(scans_of["V5 path B=4"]) < 4:
        raise AssertionError(f"degenerate V5 costs: scans {scans_of}")

    entry = {"name": "lap", "route": "cuda",
             "source": "lidar_object_detection_tpu_torch/csrc/lap.cu",
             "replaces": "lidar_object_detection_tpu/ops/lap.py:36",
             "max_abs_err": 0, "mismatches": mismatches,
             "compared": compared, "cases": len(cases),
             "scipy_gap": gap, "library_ms": None}
    for suffix, name in (("", "V5 path B=4"), ("_b1", "seeded B=1"),
                         ("_b4", "seeded B=4")):
        cost, rmask, cmask = cases[name]
        entry["ms" + suffix] = time_gpu(lap_launcher(torch, dev, *cases[name]))
        _, scans = lap_lib.lap_plain(cost, rmask, cmask, return_scans=True)
        bound, by = lap_bound(cost, scans)
        entry["bound_ms" + suffix] = bound
        if not suffix:
            entry["bound_by"] = by
        # the dependent chain: each frame's scanned columns one after
        # another, then as many augmentation edges at most
        entry["chain_steps" + suffix] = int(scans.max())
    entry["kernel_ms"] = entry["ms"]
    cost, rmask, cmask = path
    entry["plain_ms"] = time_gpu(
        lambda: lap_lib.lap_plain(cost, rmask, cmask), reps=5, warmup=1,
        head_start=False)
    host = tuple(a.cpu().numpy() for a in path)
    times = []
    for _ in range(20):
        t = time.perf_counter()
        scipy_total(*host)
        times.append((time.perf_counter() - t) * 1e3)
    entry["scipy_host_ms"] = float(np.median(times))
    entry["shape"] = (f"B={cost.shape[0]} R={cost.shape[1]} "
                      f"C={cost.shape[2]}, real rows "
                      f"{rmask.sum(dim=1).tolist()}, real columns "
                      f"{cmask.sum(dim=1).tolist()}, scans "
                      f"{scans_of['V5 path B=4']}")
    print(f"lap: equal to the twin on {len(cases)} cases ({compared} rows), "
          f"scipy's total within {gap:.3g}; V5 path B=4 {entry['ms']:.4f} ms "
          f"(bound {entry['bound_ms']:.3g} by {entry['bound_by']}, chain "
          f"{entry['chain_steps']} steps), seeded B=4 {entry['ms_b4']:.4f}, "
          f"B=1 {entry['ms_b1']:.4f}; twin {entry['plain_ms']:.3f} ms, scipy "
          f"on the host {entry['scipy_host_ms']:.4f} ms; {entry['shape']}; "
          f"scans {scans_of}", flush=True)
    return entry


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def load_serving(torch, dev, rng):
    """The committed n checkpoint at its serving point (bf16, BatchNorm
    folded), the 4 frames (two real ones and their mirrors), and one
    synthetic scene per frame with boxes placed behind a first detection's
    cars.  Returns (detector, images, scenes)."""
    from lidar_object_detection_tpu_torch.models.yolo.serving import (
        load_serving_checkpoint)
    from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

    t0 = time.perf_counter()
    detector, step, resolved = load_serving_checkpoint(
        CKPT, (H0, W0), device=dev, dtype=torch.bfloat16, fold_weights=True)
    if resolved["tta"] != "hflip" or resolved["mask_threshold_floor"] is None:
        raise AssertionError(f"unexpected serving point {resolved}")
    real = [read_png_rgb(path) for path in FRAMES]
    images = np.stack(real + [im[:, ::-1] for im in real])
    images = np.ascontiguousarray(images)
    print(f"checkpoint step {step}, serving point {resolved}, frames "
          f"{images.shape}", flush=True)
    first = detector.detect(images)
    scenes = [make_scene(rng, first["boxes"][b].float().cpu().numpy(),
                         first["det_valid"][b].cpu().numpy())
              for b in range(len(images))]
    phase("load checkpoint, frames and scenes", t0)
    return detector, images, scenes


def main_path(torch, dev, smi, detector, images, scenes):
    from lidar_object_detection_tpu_torch.config import (
        FusionConfig, FusionParams, PipelineVersion)
    from lidar_object_detection_tpu_torch.eval.statistics import (
        frame_statistics, summarize)
    from lidar_object_detection_tpu_torch.fusion.associate import fuse_batch
    from lidar_object_detection_tpu_torch.ops import kernel_lib

    t0 = time.perf_counter()
    points, pvalid, corners, bvalid = (
        torch.from_numpy(np.stack([s[i] for s in scenes])).to(dev)
        for i in range(4))
    calib = tuple(torch.from_numpy(m).to(dev)
                  for m in (VELO_TO_RECT, CAM_TO_VELO, INTRINSICS))
    cfg = FusionConfig.for_version(PipelineVersion.CSV_EVAL)
    params = FusionParams.from_config(cfg)

    def run():
        det = detector.detect(images)
        fused = fuse_batch(points, pvalid, det["mask_bits"],
                           det["det_valid"], corners, bvalid, *calib,
                           params=params)
        rows = [r for b in range(len(images)) for r in frame_statistics(
            b, fused["total_points"][b], fused["best_box"][b],
            fused["points_inside"][b], fused["matched"][b],
            det["det_valid"][b], fused["box_visible"][b])]
        return det, fused, rows

    torch.cuda.synchronize()
    kernel_lib.reset_launches()
    det, fused, rows = run()
    torch.cuda.synchronize()
    launches = dict(kernel_lib.LAUNCHES)
    print(f"main-path launches: {launches}", flush=True)
    if any(launches[k] != 1 for k in PATH_KERNELS) or any(
            launches[k] for k in OFF_PATH_KERNELS):
        raise AssertionError(f"the main path launched {launches} for one "
                             f"batch, expected each kernel once")

    # the outputs, by the repo's own means
    n_det = det["det_valid"].sum(dim=1).tolist()
    if not bool(torch.isfinite(det["boxes"]).all()):
        raise AssertionError("non-finite boxes")
    if det["mask_bits"].shape != (len(images), H0, W0):
        raise AssertionError(f"mask_bits shape {det['mask_bits'].shape}")
    if n_det[0] == 0 or not bool((det["mask_bits"][0] != 0).any()):
        raise AssertionError("no car found in the real camera frame")
    summary = summarize(rows)
    if summary["matched"] == 0:
        raise AssertionError("no detection matched a box")

    # reference 1: the same network outputs decoded on the CPU by the twins
    outputs = detector.forward(images)
    cpu_out = {k: [x.float().cpu() for x in v] if isinstance(v, list)
               else v.float().cpu() for k, v in outputs.items()}
    gpu_out = {k: [x.float() for x in v] if isinstance(v, list)
               else v.float() for k, v in outputs.items()}
    ref = detector.decode(cpu_out)
    got = detector.decode(gpu_out)
    if not torch.equal(ref["det_valid"], got["det_valid"].cpu()):
        raise AssertionError("det_valid differs between card and CPU twins")
    box_err = float((ref["boxes"] - got["boxes"].cpu()).abs().max())
    word_mismatch = float((ref["mask_bits"] != got["mask_bits"].cpu())
                          .float().mean())
    # the decode's tables come from float32 einsums that round differently
    # on the two devices, so a pixel within an ulp of its cut may flip
    if box_err > 1e-2 or word_mismatch > 1e-3:
        raise AssertionError(f"card vs CPU decode: box error {box_err}, "
                             f"mask-word mismatch share {word_mismatch}")
    # reference 2: the fusion with the plain inside-count
    plain = fuse_batch(points, pvalid, det["mask_bits"], det["det_valid"],
                       corners, bvalid, *calib,
                       params=dataclasses.replace(params, count_impl="plain"))
    for key in ("counts", "total_points", "best_box", "matched"):
        if not torch.equal(plain[key], fused[key]):
            raise AssertionError(f"fusion {key}: kernel and twin differ")
    print(f"detections per frame {n_det}; cars {summary['total_cars']}, "
          f"matched {summary['matched']}, mean inside "
          f"{summary['avg_inside_pct']:.2f} %; card vs CPU decode: box "
          f"error {box_err:.3g} px, mask-word mismatch share "
          f"{word_mismatch:.3g}; fusion equal to the plain count",
          flush=True)

    iters = 10
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    batch_ms = start.elapsed_time(end) / iters
    fps = len(images) / batch_ms * 1e3
    print(f"main path: {fps:.2f} frames/s ({batch_ms:.2f} ms per batch of "
          f"{len(images)}, detect + fuse + statistics, CUDA events over "
          f"{iters} batches) on {smi}", flush=True)
    stage_times(torch, detector, images, points, pvalid, corners, bvalid,
                calib, params)
    profile_once(torch, run)
    phase("main path", t0)
    return launches


def csv_eval_phase(torch, dev, smi, images, scenes, tmp):
    """The csv_eval entry and the erosion study from a KITTI-360 tree
    written under ``tmp``, with the YOLO detector as the CLI serves it
    (float32, unfolded weights, the sidecar's point), which pins its own
    precision: nothing here sets a global TF32 switch.  Returns the
    csv_eval run's launches and the tree's root."""
    import copy

    from lidar_object_detection_tpu_torch.config import (
        FusionConfig, PipelineVersion)
    from lidar_object_detection_tpu_torch.data import Kitti360Dataset
    from lidar_object_detection_tpu_torch.eval.erosion_study import (
        run_erosion_study)
    from lidar_object_detection_tpu_torch.models.yolo.serving import (
        load_serving_checkpoint)
    from lidar_object_detection_tpu_torch.ops import kernel_lib
    from lidar_object_detection_tpu_torch.pipelines import cli
    from lidar_object_detection_tpu_torch.pipelines.runner import (
        FusionPipeline, csv_eval)

    t0 = time.perf_counter()
    detector, _, _ = load_serving_checkpoint(CKPT, (H0, W0),
                                             default_scale="x", device=dev)
    # one float32 forward first, so that the timed run below does not
    # include cuDNN's first choice of float32 convolution plans
    detector.forward(images)
    plain = copy.copy(detector)
    plain.params = dataclasses.replace(detector.params, nms_impl="plain")
    root = os.path.join(tmp, "kitti360")
    # the real frames' PNG files as they are committed (rows filtered
    # Paeth and Sub, as a camera's encoder writes them); their mirrors
    # encoded with adaptive filters
    frames = []
    for b, (points, pvalid, corners, bvalid) in enumerate(scenes):
        image = FRAMES[b] if b < len(FRAMES) else images[b]
        frames.append((100 + b, image, points[pvalid], corners[bvalid]))
    # a frame without a box JSON, which the loader must skip
    frames.append((200, FRAMES[0], scenes[0][0][scenes[0][1]], None))
    write_kitti360_tree(root, frames)
    ds = Kitti360Dataset(root)
    records = ds.load_frames()
    if [r.frame_id for r in records] != [100 + b for b in
                                          range(len(scenes))]:
        raise AssertionError(f"the loader kept frames "
                             f"{[r.frame_id for r in records]}")
    phase("write and load the KITTI-360 tree", t0)

    out = os.path.join(tmp, "out")
    master = os.path.join(out, "master_car_statistics.csv")
    stamp = "2026-01-01T00:00:00"
    torch.cuda.synchronize()
    kernel_lib.reset_launches()
    t1 = time.perf_counter()
    analysis = csv_eval(root, master, detector=detector, device=dev,
                        timestamp=stamp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(kernel_lib.LAUNCHES)
    print(f"csv_eval launches: {launches}", flush=True)
    if any(launches[k] != 1 for k in PATH_KERNELS) or any(
            launches[k] for k in OFF_PATH_KERNELS):
        raise AssertionError(f"csv_eval launched {launches} for its one "
                             f"batch, expected each kernel once")
    fps = len(records) / wall
    # the loader's part of that run, timed again on its own: scans and
    # boxes, the batch, and the PNG decode
    t1 = time.perf_counter()
    batch = ds.make_batch(ds.load_frames())
    t2 = time.perf_counter()
    loaded = ds.load_images(batch)
    t3 = time.perf_counter()
    if not np.array_equal(loaded, images):
        raise AssertionError("the loader's frames differ from the "
                             "committed PNGs and their mirrors")
    print(f"csv_eval from disk: {fps:.2f} frames/s ({len(records)} "
          f"frames in {wall:.3f} s, host clock: load, detect, fuse, "
          f"CSV, analysis) on {smi}; loader {t3 - t1:.3f} s "
          f"({(t3 - t1) / wall:.3f} of the run: scans and boxes "
          f"{t2 - t1:.3f} s, PNG decode {t3 - t2:.3f} s); analysis "
          f"{analysis}", flush=True)

    study_csv = os.path.join(out, "erosion_study.csv")
    study_xlsx = os.path.join(out, "master_car_statistics.csv.xlsx")
    study = run_erosion_study(root, detector=detector,
                              output_csv=study_csv,
                              output_xlsx=study_xlsx, device=dev)
    print(f"erosion study: {study.summary()}", flush=True)

    # rows: one per valid detection; the same run with the twin NMS
    cfg = FusionConfig.for_version(PipelineVersion.CSV_EVAL)
    dets = FusionPipeline(ds, cfg, detector, device=dev).detect(
        records, batch)
    dets_plain = FusionPipeline(ds, cfg, plain, device=dev).detect(
        records, batch)
    for key in dets:
        if not torch.equal(dets[key], dets_plain[key]):
            raise AssertionError(f"csv_eval detections {key}: K5 and "
                                 f"the twin NMS differ")
    master_plain = os.path.join(out, "master_plain.csv")
    csv_eval(root, master_plain, detector=plain, device=dev,
             timestamp=stamp)
    with open(master) as f, open(master_plain) as g:
        lines, lines_plain = f.read(), g.read()
    if lines != lines_plain:
        raise AssertionError("the master CSV differs between K5 and the "
                             "twin NMS")
    # the CLI as a user runs it on the card: the same rows
    cli_out = os.path.join(tmp, "cli")
    if cli.main(["run", "--dataset", root, "--version", "csv_eval",
                 "--detector", "yolo", "--weights", CKPT, "--output",
                 cli_out]) != 0:
        raise AssertionError("the CLI run failed")
    with open(os.path.join(cli_out, "master_car_statistics.csv")) as f:
        cli_lines = f.read()
    strip = lambda text: [row.rsplit(",", 1)[0]
                          for row in text.splitlines()]
    if strip(cli_lines) != strip(lines):
        raise AssertionError("the CLI's master CSV differs from "
                             "csv_eval's")
    n_rows = len(lines.splitlines()) - 1
    n_valid = int(dets["det_valid"].sum())
    if n_rows != n_valid or analysis["total_detections"] != n_rows:
        raise AssertionError(f"master CSV has {n_rows} rows for "
                             f"{n_valid} valid detections")
    with open(study_csv) as f:
        n_study = len(f.read().splitlines()) - 1
    if n_study != len(study.rows) or not os.path.getsize(study_xlsx):
        raise AssertionError("erosion-study outputs are incomplete")
    print(f"master CSV: {n_rows} rows for {n_valid} valid detections, "
          f"byte-equal with the twin NMS, and the CLI's rows equal; "
          f"erosion study: {n_study} rows "
          f"and a {os.path.getsize(study_xlsx)}-byte workbook",
          flush=True)
    phase("csv_eval from disk", t0)
    return launches, root


def run_cli(argv):
    """Run the port's CLI, echo its output, and return the output; a
    non-zero exit raises."""
    from lidar_object_detection_tpu_torch.pipelines import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli.main(argv)
    text = buf.getvalue()
    print(text, end="", flush=True)
    if code != 0:
        raise AssertionError(f"the CLI exited {code}: {argv}")
    return text


def same_pairs(got, ref, what):
    """Matched pairs equal key by key, floats and corners exactly."""
    if len(got) != len(ref):
        raise AssertionError(f"{what}: {len(got)} pairs against {len(ref)}")
    for p, q in zip(got, ref):
        if list(p) != list(q) or any(
                not np.array_equal(np.asarray(p[k]), np.asarray(q[k]))
                for k in q):
            raise AssertionError(f"{what}: pair {p} differs from {q}")


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def matching_phase(torch, dev, smi, root, tmp):
    """V4, V5 and the exports through the CLI on the card, from the
    csv_eval phase's KITTI-360 tree (4 frames of 376 x 1408, P = 131072, G
    = 384 slots, 300 boxes each), with the n checkpoint as the CLI serves
    it: ``run --version v4_iou``, ``run --version v5_projected
    --export-ply --analysis-cloud car_color`` and ``depth-maps``.  The
    launch counters are zeroed before each and read after it: the
    detector's kernels once per run, K1 once per fusion (the V5 run fuses
    again for its analysis clouds), the solver once per V5 batch and
    nowhere else.

    The references are the card's own detections (the detector as the CLI
    builds it) through the pipeline on the card and on the CPU: V4 and V5
    matched pairs equal (indices, IoUs and scores exactly), the CLI's
    printed counts equal the card run's, and the CLI's PLY scenes,
    analysis clouds and depth-map figures byte-equal to those written from
    the CPU run.  It times the CLI runs (host clock), the V4 and V5
    matching of the batch and the batch's depth-map scatter (CUDA events).
    Returns each run's launches and the V5 run's assignment operands on
    the card."""
    from lidar_object_detection_tpu_torch.config import (
        FusionConfig, PipelineVersion)
    from lidar_object_detection_tpu_torch.data import Kitti360Dataset
    from lidar_object_detection_tpu_torch.fusion.associate import (
        hungarian_cost)
    from lidar_object_detection_tpu_torch.models.yolo.serving import (
        load_serving_checkpoint)
    from lidar_object_detection_tpu_torch.ops import kernel_lib
    from lidar_object_detection_tpu_torch.ops.masks import unpack_point_bits
    from lidar_object_detection_tpu_torch.ops.scatter import (
        scatter_depth_maps)
    from lidar_object_detection_tpu_torch.pipelines.runner import (
        FusionPipeline)
    from lidar_object_detection_tpu_torch.viz.export import (
        export_fusion_scene, write_ply)
    from lidar_object_detection_tpu_torch.viz.overlay import depth_map_figure

    t0 = time.perf_counter()
    base = ["--dataset", root, "--detector", "yolo", "--weights", CKPT]
    runs = {"v4": ["run", "--version", "v4_iou"],
            "v5": ["run", "--version", "v5_projected", "--export-ply",
                   "--analysis-cloud", "car_color"],
            "depth_maps": ["depth-maps"]}
    outs, texts, launches, walls = {}, {}, {}, {}
    for name, argv in runs.items():
        outs[name] = os.path.join(tmp, f"cli_{name}")
        torch.cuda.synchronize()
        kernel_lib.reset_launches()
        t = time.perf_counter()
        texts[name] = run_cli(argv[:1] + base + argv[1:]
                              + ["--output", outs[name]])
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
        launches[name] = dict(kernel_lib.LAUNCHES)
    print(f"matching and export launches: {launches}; CLI wall s "
          f"{walls}", flush=True)
    for name, k1, solver in (("v4", 1, 0), ("v5", 2, 1),
                             ("depth_maps", 1, 0)):
        want = dict(inside_counts=k1, mask_assemble=1, mask_count=1, nms=1,
                    lap=solver, rotated_nms=0)
        if launches[name] != want:
            raise AssertionError(f"the {name} CLI run launched "
                                 f"{launches[name]}, expected {want}")
    phase("matching and exports: the CLI on the card", t0)

    detector, _, _ = load_serving_checkpoint(CKPT, (H0, W0),
                                             default_scale="x", device=dev)
    line = re.compile(r"^frame (\d+): (\d+) detections, (\d+) visible "
                      r"boxes, (\d+) matched$", re.M)
    summary, problem = {}, None
    for name, version in (("v4", PipelineVersion.V4_IOU),
                          ("v5", PipelineVersion.V5_PROJECTED)):
        cfg = FusionConfig.for_version(version)
        ds = Kitti360Dataset(root, shapes=cfg.shapes)
        card = FusionPipeline(ds, cfg, detector, device=dev)
        records = ds.load_frames()
        batch = ds.make_batch(records)
        dets = card.detect(records, batch)
        cpu_dets = {k: v.cpu() for k, v in dets.items()}
        got = card.run(detections=dets)
        fused = card.fuse(batch, dets)
        match_ms, _ = time_events(torch,
                                  lambda: card.match(batch, dets, fused))
        cpu = FusionPipeline(ds, cfg, device="cpu")
        ref = cpu.run(detections=cpu_dets)
        for a, b in zip(got.frames, ref.frames, strict=True):
            same_pairs(a.matched_pairs, b.matched_pairs,
                       f"{name} frame {a.frame_id}, card against CPU")
        counts = [(str(f.frame_id), str(f.num_detections),
                   str(f.num_visible_boxes),
                   str(sum(not p.get("unmatched") for p in f.matched_pairs)))
                  for f in got.frames]
        if line.findall(texts[name]) != counts:
            raise AssertionError(f"the {name} CLI printed "
                                 f"{line.findall(texts[name])}, the card "
                                 f"run has {counts}")
        matched = sum(int(c[3]) for c in counts)
        grey = sum(bool(p.get("unmatched")) for f in got.frames
                   for p in f.matched_pairs)
        summary[name] = {"matched": matched, "unmatched boxes": grey,
                         "match_ms": match_ms}
        if matched == 0:
            raise AssertionError(f"{name}: no detection matched a box")
        if name != "v5":
            continue
        cost, col_mask, *_ = hungarian_cost(
            dets["boxes"].to(torch.float32), dets["det_valid"],
            card._gt_corners(batch),
            torch.from_numpy(batch.box_valid).to(dev), card._intrinsics,
            cfg.score_weight_iou, cfg.score_weight_center,
            cfg.score_weight_size, cfg.center_norm)
        problem = (cost.contiguous(), dets["det_valid"].contiguous(),
                   col_mask.contiguous())
        ref_path = os.path.join(tmp, "ref.ply")
        for fr, rec in zip(ref.frames, records):
            export_fusion_scene(ref_path, rec.points[:, :3], None,
                                fr.matched_pairs)
            cli_path = os.path.join(outs[name],
                                    f"frame_{fr.frame_id:010d}.ply")
            if read_bytes(cli_path) != read_bytes(ref_path):
                raise AssertionError(f"{cli_path} differs from the CPU "
                                     f"run's scene")
        clouds = cpu.analysis_clouds(mode="car_color", detections=cpu_dets)
        colored = 0
        for frame_id, pts, colors, _ in clouds:
            write_ply(ref_path, pts, colors)
            cli_path = os.path.join(outs[name],
                                    f"analysis_{frame_id:010d}.ply")
            if read_bytes(cli_path) != read_bytes(ref_path):
                raise AssertionError(f"{cli_path} differs from the CPU "
                                     f"run's analysis cloud")
            colored += int((colors != 0.5).any(axis=1).sum())
        summary["v5"]["coloured cloud points"] = colored
        if not colored:
            raise AssertionError("the analysis clouds colour no point")

    cfg = FusionConfig.for_version(PipelineVersion.DEPTH_MAPS)
    ds = Kitti360Dataset(root, shapes=cfg.shapes)
    card = FusionPipeline(ds, cfg, detector, device=dev)
    records = ds.load_frames()
    batch = ds.make_batch(records)
    dets = card.detect(records, batch)
    fused = card.fuse(batch, dets)
    scatter_ms, _ = time_events(torch, lambda: scatter_depth_maps(
        fused["u"], fused["v"], fused["depth"],
        unpack_point_bits(fused["point_bits"], D), fused["point_valid"], H0,
        W0))
    got = list(card.depth_maps(detections=dets))
    ref = list(FusionPipeline(ds, cfg, device="cpu").depth_maps(
        detections={k: v.cpu() for k, v in dets.items()}))
    if [(f, c) for f, c, *_ in got] != [(f, c) for f, c, *_ in ref]:
        raise AssertionError("the card's depth maps are of other cars than "
                             "the CPU's")
    for (f, c, dm, seg), (_, _, rdm, rseg) in zip(got, ref):
        if not (np.array_equal(dm, rdm) and np.array_equal(seg, rseg)):
            raise AssertionError(f"depth map of frame {f} car {c}: card "
                                 f"and CPU differ")
    names = [f"{f:010d},depth_map_car_{c:02d}_.png" for f, c, *_ in ref]
    if sorted(os.listdir(outs["depth_maps"])) != sorted(names) or not names:
        raise AssertionError(f"the depth-maps CLI wrote "
                             f"{sorted(os.listdir(outs['depth_maps']))}")
    ref_png = os.path.join(tmp, "ref.png")
    for name, (f, c, dm, seg) in zip(names, ref):
        depth_map_figure(dm, seg, c, f, ref_png)
        if read_bytes(os.path.join(outs["depth_maps"], name)) != \
                read_bytes(ref_png):
            raise AssertionError(f"{name} differs from the CPU run's")
    summary["depth_maps"] = {"maps": len(names), "pixels": int(sum(
        (dm > 0).sum() for *_, dm, _ in ref)), "scatter_ms": scatter_ms}
    summary["cli_wall_s"] = walls
    print(f"matching and exports: V4 and V5 pairs equal to the CPU run on "
          f"the card's detections, the CLI's counts to the card run's; PLY "
          f"scenes, analysis clouds and depth-map figures byte-equal to the "
          f"CPU's, on {smi}", flush=True)
    print(json.dumps({"matching": summary}), flush=True)
    phase("matching and exports", t0)
    return launches, problem


# ---------------------------------------------------------------------------
# PointPillars inference (the pure-LiDAR detector) and its rotated NMS
# ---------------------------------------------------------------------------

PP_CKPTS = {head: os.path.join(REPO, "checkpoints",
                               f"pp_{head}_surround.msgpack")
            for head in ("ssd", "center")}
PP_FRAMES = (200, 201, 202, 203)
# The SSD runs' score threshold.  The SSD checkpoint scores the synthetic
# street's cars below the default 0.3 (sigmoid of logits up to about -1.2
# on the CPU), the center checkpoint above it; at 0.1 the SSD decode has
# candidates to suppress.
PP_SSD_THRESHOLD = 0.1
PP_IOU_THRESHOLD, PP_MAX_DETECTIONS = 0.5, 64
# rotated IoU rows of kernel and twin agree within this; picks must be
# equal up to the first step with a deciding IoU this close to 0.5
PP_IOU_TOL = 1e-5
# fp32 operations of the clip of one (pick, alive candidate) pair: per
# clip edge its direction (2) and per vertex of a 4-vertex ring the
# offset (2), the cross product (3) and the inside test (1); the shoelace
# over 4 vertices (3 each); the union, the division and the threshold (4)
PP_CLIP_OPS = 4 * (2 + 4 * 6) + 4 * 3 + 4


def pillars_world(rng, n_points=2 * P):
    """A street in frame 0's velodyne coordinates (x forward, y left, z
    up, the sensor 1.73 m over the road): parked cars on both sides,
    their sensor-facing sides and roofs sampled densely near the sensor
    and sparsely far away (in proportion to ``n_points``), the road
    surface, and building fronts at +-12 m.  Returns points (n_points, 4)
    float32 and the cars' boxes7."""
    cars = []
    for side in (-1, 1):
        for x in np.arange(-45.0, 45.0, 6.5):
            if rng.uniform() < 0.3:
                continue
            cars.append([x + rng.uniform(-0.5, 0.5),
                         side * (4.5 + rng.uniform(-0.3, 0.3)), -0.95,
                         1.8, 4.3, 1.5, rng.uniform(-0.1, 0.1)])
    cars = np.asarray(cars, np.float32)
    chunks = []
    density = n_points / (2 * P)
    for x, y, z, w, l, h, yaw in cars:
        n = int(density * np.clip(90000 / max(np.hypot(x, y), 3) ** 1.2,
                                  80, 9000))
        u = rng.uniform(-0.5, 0.5, (n, 3))
        face = rng.integers(0, 3, n)
        u[face == 0, 1] = -0.5 * np.sign(y)
        u[face == 1, 0] = -0.5 * np.sign(x)
        u[face == 2, 2] = 0.5
        c, s = np.cos(yaw), np.sin(yaw)
        lx, ly = u[:, 0] * l, u[:, 1] * w
        chunks.append(np.stack([x + lx * c - ly * s, y + lx * s + ly * c,
                                z + u[:, 2] * h], 1))
    used = sum(len(c) for c in chunks)
    n_ground = (n_points - used) * 2 // 3
    r = np.sqrt(rng.uniform(2.0 ** 2, 60.0 ** 2, n_ground))
    a = rng.uniform(-np.pi, np.pi, n_ground)
    chunks.append(np.stack([r * np.cos(a), r * np.sin(a),
                            np.full(n_ground, -1.73)], 1))
    n_wall = n_points - used - n_ground
    chunks.append(np.stack([rng.uniform(-60, 60, n_wall),
                            np.where(rng.uniform(size=n_wall) < 0.5, -12.0,
                                     12.0),
                            rng.uniform(-1.7, 3.0, n_wall)], 1))
    xyz = np.concatenate(chunks).astype(np.float32)
    refl = rng.uniform(0, 1, (len(xyz), 1)).astype(np.float32)
    return np.concatenate([xyz, refl], 1), cars


def pillars_tree(root, rng):
    """A KITTI-360 tree of PP_FRAMES: each frame's scan a different half of
    one street (``pillars_world``), seen from the ego pose of its frame
    (``ego_pose``, as the tree's pose files say), and its cars' cam0
    corners; no images.  Aggregating the sweeps puts the street back
    together in the target frame's coordinates."""
    import torch

    from lidar_object_detection_tpu_torch.models.pointpillars import (
        boxes7_to_corners)

    world, cars = pillars_world(rng)
    v2r = VELO_TO_RECT.astype(np.float64)
    corners0 = boxes7_to_corners(torch.from_numpy(cars)).numpy()
    frames = []
    for k, fid in enumerate(PP_FRAMES):
        pose = ego_pose(k)
        # frame 0's velodyne -> world -> frame k's velodyne (pose 0 is I)
        to_k = np.linalg.inv(pose @ v2r) @ v2r
        sel = np.sort(rng.choice(len(world), P, replace=False))
        pts = world[sel].copy()
        pts[:, :3] = pts[:, :3] @ to_k[:3, :3].T + to_k[:3, 3]
        # world -> frame k's cam0
        to_cam = np.linalg.inv(pose) @ v2r
        cam = corners0 @ to_cam[:3, :3].T + to_cam[:3, 3]
        frames.append((fid, None, pts.astype(np.float32),
                       cam.astype(np.float32)))
    write_kitti360_tree(root, frames)
    return len(cars)


def rotated_nms_cases(rng, batch=4, n=512):
    """Seeded rotated-NMS operands on the host, (B, N, 7) boxes7, (B, N)
    scores and validity: car-sized boxes of any yaw, with heavy overlap
    (in a 12 m square), every candidate invalid, a quarter of the scores
    NaN (and some infinite), and scores that tie in groups."""
    def boxes(spread):
        b = np.zeros((batch, n, 7), np.float32)
        b[..., 0] = rng.uniform(-spread, spread, (batch, n))
        b[..., 1] = rng.uniform(-spread, spread, (batch, n))
        b[..., 2] = rng.uniform(-2, 0, (batch, n))
        b[..., 3] = rng.uniform(1.4, 2.2, (batch, n))
        b[..., 4] = rng.uniform(3.2, 5.0, (batch, n))
        b[..., 5] = rng.uniform(1.3, 1.8, (batch, n))
        b[..., 6] = rng.uniform(-np.pi, np.pi, (batch, n))
        b[:, 1::7] = b[:, 0::7][:, :b[:, 1::7].shape[1]]    # exact copies
        return b

    def scores():
        return rng.uniform(0, 1, (batch, n)).astype(np.float32)

    cases = {}
    s = scores()
    cases["heavy overlap"] = (boxes(6.0), s, s > 0.1)
    s = scores()
    cases["all invalid"] = (boxes(6.0), s, np.zeros((batch, n), bool))
    s = scores()
    s[rng.uniform(size=(batch, n)) < 0.25] = np.nan
    s[:, 3] = np.inf
    s[:, 5] = -np.inf
    cases["NaN scores"] = (boxes(10.0), s, np.ones((batch, n), bool))
    s = np.round(scores() * 8).astype(np.float32) / 8
    cases["equal scores"] = (boxes(10.0), s, s > 0.2)
    return cases


def rotated_nms_launcher(torch, dev, bx, sc, va, thr, m):
    """A call of the rotated-NMS C entry point alone, for timing."""
    from lidar_object_detection_tpu_torch.ops import kernel_lib

    lib = kernel_lib.library()
    b, n = sc.shape
    out_idx = torch.empty((b, m), dtype=torch.int32, device=dev)
    out_keep = torch.empty((b, m), dtype=torch.bool, device=dev)

    def run():
        kernel_lib.check(lib.rotated_nms_launch(
            bx.data_ptr(), sc.data_ptr(), va.data_ptr(), b, n, m, thr,
            out_idx.data_ptr(), out_keep.data_ptr(), None,
            kernel_lib.stream_handle(dev)), "rotated_nms_launch")
    return run


def rotated_nms_bound(pairs, b, n, m, steps):
    """The rotated NMS's bound on these inputs.  Bytes: the boxes7, scores
    and validity once, and the M slots' indices and flags.  Operations:
    PP_CLIP_OPS per (pick, alive candidate) pair, the pairs counted by the
    twin (``rotated_nms_plain(..., return_pairs=True)``), and N compares
    per argmax step."""
    n_bytes = b * n * (7 * 4 + 4 + 1) + b * m * (4 + 1)
    return bound_ms(n_bytes, PP_CLIP_OPS * pairs + n * steps)


def replay_rotated_nms(rows, idx, keep, scores, valid, thr):
    """Per frame, the smallest |IoU - thr| among the IoUs that decided a
    step (the pick's row at the candidates still alive then), replayed
    from the kernel's own rows and picks; and the step at which that gap
    first fell to PP_IOU_TOL or below (M if never)."""
    b, m, n = rows.shape
    gaps, first_close = [], []
    for f in range(b):
        alive = valid[f] & np.isfinite(scores[f])
        gap, close = np.inf, m
        for s in range(m):
            if not keep[f, s]:
                break
            p = idx[f, s]
            deciding = alive.copy()
            deciding[p] = False
            if deciding.any():
                step_gap = float(np.abs(rows[f, s][deciding] - thr).min())
                gap = min(gap, step_gap)
                if step_gap <= PP_IOU_TOL and close == m:
                    close = s
            alive &= ~(rows[f, s] > thr)
            alive[p] = False
        gaps.append(gap)
        first_close.append(close)
    return gaps, first_close


def check_rotated_nms(torch, dev, rng, path):
    """The rotated-NMS kernel against its twin on the card: the SSD
    path's own candidates (``path``: each frame's 512 top boxes7, scores
    and validity from the card's heads, (4, 512, ...)), the same with
    every candidate valid, and seeded cases at B = 4, N = 512, M = 64
    (heavy overlap, all invalid, NaN scores, equal scores).  The kernel's
    IoU rows (each step's pick against every candidate) must agree with
    the twin's matrix rows within PP_IOU_TOL, and its picks with the
    twin's up to the first step with a deciding IoU within PP_IOU_TOL of
    the threshold (the smallest such gap is printed).  Timed at B = 1 on
    each path frame (the launch the decode makes per frame) and at B = 4
    on the seeded overlap; the twin on the card beside it."""
    from lidar_object_detection_tpu_torch.ops import rotated_nms as rn
    from lidar_object_detection_tpu_torch.ops.rotated_iou import (
        rotated_iou_matrix)

    thr, m = PP_IOU_THRESHOLD, PP_MAX_DETECTIONS
    on_card = lambda arrays: tuple(torch.from_numpy(a).to(dev)
                                   for a in arrays)
    boxes, scores, valid = path
    cases = {"SSD path B=4": path,
             "SSD path, all valid": (boxes, scores, torch.ones_like(valid))}
    cases.update({name: on_card(c)
                  for name, c in rotated_nms_cases(rng).items()})
    stats, max_err, min_gap, failed, pairs_of = {}, 0.0, np.inf, [], {}
    for name, (bx, sc, va) in cases.items():
        idx, keep, rows = rn.rotated_nms_cuda(bx, sc, va, thr, m,
                                              iou_rows=True)
        ref_idx, ref_keep, pairs = rn.rotated_nms_plain(
            bx, sc, va, thr, m, return_pairs=True)
        torch.cuda.synchronize()
        pairs_of[name] = pairs.tolist()
        idx_h, keep_h, rows_h = (t.cpu().numpy() for t in (idx, keep, rows))
        ref_idx_h, ref_keep_h = ref_idx.cpu().numpy(), ref_keep.cpu().numpy()
        gaps, close = replay_rotated_nms(rows_h, idx_h, keep_h,
                                         sc.cpu().numpy(), va.cpu().numpy(),
                                         thr)
        min_gap = min(min_gap, *gaps)
        bad = 0
        for f in range(bx.shape[0]):
            c = close[f]
            bad += int((idx_h[f, :c + 1] != ref_idx_h[f, :c + 1]).sum()
                       + (keep_h[f, :c + 1] != ref_keep_h[f, :c + 1]).sum())
            # rows of the steps both took: the kernel's against the
            # twin's matrix at the same pick
            steps = int(min(c + 1, keep_h[f].sum()))
            if steps:
                iou = rotated_iou_matrix(bx[f], bx[f])
                picks = torch.from_numpy(idx_h[f, :steps]).long().to(dev)
                err = float((rows[f, :steps] - iou[picks]).abs().max())
                max_err = max(max_err, err)
        if bad:
            failed.append(f"{name}: {bad} slots")
        stats[name] = {"picks": keep_h.sum(axis=1).tolist(),
                       "min_gap": min(gaps), "close_step": close}
    print(f"rotated NMS cases: {stats}", flush=True)
    if failed or max_err > PP_IOU_TOL:
        raise AssertionError(f"the rotated NMS differs from its twin: "
                             f"{failed}, IoU rows off by up to {max_err}")
    if sum(stats["SSD path, all valid"]["picks"]) == 0 \
            or sum(stats["heavy overlap"]["picks"]) < 8 \
            or sum(stats["all invalid"]["picks"]) != 0:
        raise AssertionError(f"degenerate rotated NMS cases: {stats}")

    entry = {"name": "rotated_nms", "route": "cuda",
             "source": "lidar_object_detection_tpu_torch/csrc/"
                       "rotated_nms.cu",
             "replaces": "lidar_object_detection_tpu/models/pointpillars/"
                         "decode.py:146",
             "max_abs_err": max_err, "min_gap": min_gap,
             "mismatches": 0, "cases": len(cases), "library_ms": None,
             "pairs": pairs_of}
    per_frame, bounds = [], []
    for f in range(boxes.shape[0]):
        one = tuple(t[f:f + 1].contiguous() for t in path)
        per_frame.append(time_gpu(rotated_nms_launcher(torch, dev, *one, thr,
                                                       m)))
        _, keep, pairs = rn.rotated_nms_plain(*one, thr, m,
                                              return_pairs=True)
        steps = min(m, int(keep.sum()) + 1)
        bounds.append(rotated_nms_bound(int(pairs.sum()), 1, 512, m, steps))
    entry["ms_per_frame"] = per_frame
    entry["ms"] = float(np.median(per_frame))
    entry["bound_ms"], entry["bound_by"] = bounds[int(np.argsort(
        per_frame)[len(per_frame) // 2])]
    bx, sc, va = cases["heavy overlap"]
    entry["ms_b4"] = time_gpu(rotated_nms_launcher(torch, dev, bx, sc, va,
                                                   thr, m))
    _, keep, pairs = rn.rotated_nms_plain(bx, sc, va, thr, m,
                                          return_pairs=True)
    steps = int(np.minimum(keep.sum(dim=1).cpu().numpy() + 1, m).sum())
    entry["bound_ms_b4"], _ = rotated_nms_bound(int(pairs.sum()), 4, 512, m,
                                                steps)
    one = tuple(t[:1].contiguous() for t in path)
    entry["plain_ms"] = time_gpu(lambda: rn.rotated_nms_plain(*one, thr, m),
                                 reps=5, warmup=1, head_start=False)
    print(f"rotated NMS: equal to the twin on {len(cases)} cases (IoU rows "
          f"within {max_err:.3g}, smallest deciding gap {min_gap:.3g}); "
          f"SSD path B=1 {entry['ms']:.4f} ms per frame ({per_frame}; bound "
          f"{entry['bound_ms']:.3g} by {entry['bound_by']}), seeded B=4 "
          f"{entry['ms_b4']:.4f} (bound {entry['bound_ms_b4']:.3g}); twin "
          f"{entry['plain_ms']:.3f} ms; pairs {pairs_of}", flush=True)
    return entry


def check_pp_aabb(torch, dev, operands):
    """K5 on the PointPillars AABB decode's operands (the first frame's 512
    candidates' BEV extents, B = 1, M = 64): equal to its twin, timed,
    with its bound."""
    from lidar_object_detection_tpu_torch.ops import nms as nms_lib

    bx, sc, va = operands
    thr, m = PP_IOU_THRESHOLD, PP_MAX_DETECTIONS
    idx, keep = nms_lib.nms_cuda(bx, sc, va, thr, m)
    ref_idx, ref_keep = nms_lib.nms_plain(bx, sc, va, thr, m)
    torch.cuda.synchronize()
    if not (torch.equal(idx, ref_idx) and torch.equal(keep, ref_keep)):
        raise AssertionError("K5 differs from its twin on the PointPillars "
                             "AABB candidates")
    picks = keep.sum(dim=1).tolist()
    ms = time_gpu(nms_launcher(torch, dev, bx, sc, va, thr, m))
    bound, _ = nms_bound(picks, 1, bx.shape[1], m)
    print(f"K5 on the PointPillars AABB path: {ms:.4f} ms for 1 x "
          f"{bx.shape[1]} candidates, {picks} picks (bound {bound:.3g})",
          flush=True)
    return {"pointpillars_aabb_ms": ms, "pointpillars_aabb_bound_ms": bound,
            "pointpillars_aabb_picks": picks}


def same_detections(got, ref, what, box_atol, score_atol):
    """Two decodes of one frame: validity, classes exact; boxes7 and
    scores within the tolerances."""
    import torch

    ok = ref["valid"].cpu()
    if not torch.equal(got["valid"].cpu(), ok) or not torch.equal(
            got["classes"].cpu()[ok], ref["classes"].cpu()[ok]):
        raise AssertionError(f"{what}: detections differ: "
                             f"{got['valid'].sum()} vs {ok.sum()}")
    box_err = float((got["boxes7"].cpu()[ok] - ref["boxes7"].cpu()[ok])
                    .abs().max()) if ok.any() else 0.0
    score_err = float((got["scores"].cpu() - ref["scores"].cpu())
                      .abs().max())
    if box_err > box_atol or score_err > score_atol:
        raise AssertionError(f"{what}: boxes7 off by {box_err}, scores by "
                             f"{score_err}")
    return box_err, score_err


def same_pillars_outputs(got_dir, ref_dir, frames, box_atol, score_atol):
    """The CLI's detections_*.json and scene_*.ply against those written
    from a reference decode: keys, frames, classes, steps and counts
    exact; boxes7, scores and PLY coordinates within the tolerances; PLY
    headers, colours and edges exact.  Returns the detection count."""
    total = 0
    for frame in frames:
        with open(os.path.join(got_dir, f"detections_{frame:010d}.json")) \
                as f:
            got = json.load(f)
        with open(os.path.join(ref_dir, f"detections_{frame:010d}.json")) \
                as f:
            ref = json.load(f)
        if sorted(got) != sorted(ref) or any(
                got[k] != ref[k] for k in ("frame", "classes", "ckpt_step")):
            raise AssertionError(f"detections_{frame:010d}.json differs: "
                                 f"{got} vs {ref}")
        gb = np.asarray(got["boxes7"]).reshape(-1, 7)
        rb = np.asarray(ref["boxes7"]).reshape(-1, 7)
        if gb.shape != rb.shape or (len(rb) and (
                np.abs(gb - rb).max() > box_atol or np.abs(
                    np.asarray(got["scores"]) - ref["scores"]).max()
                > score_atol)):
            raise AssertionError(f"detections_{frame:010d}.json: boxes7 or "
                                 f"scores beyond the tolerance")
        total += len(rb)
        with open(os.path.join(got_dir, f"scene_{frame:010d}.ply")) as f:
            g_lines = f.read().splitlines()
        with open(os.path.join(ref_dir, f"scene_{frame:010d}.ply")) as f:
            r_lines = f.read().splitlines()
        end = r_lines.index("end_header")
        n = int(r_lines[2].split()[-1])
        gv = np.array([ln.split() for ln in g_lines[end + 1:end + 1 + n]],
                      float)
        rv = np.array([ln.split() for ln in r_lines[end + 1:end + 1 + n]],
                      float)
        if g_lines[:end + 1] != r_lines[:end + 1] \
                or g_lines[end + 1 + n:] != r_lines[end + 1 + n:] \
                or not np.array_equal(gv[:, 3:], rv[:, 3:]) \
                or np.abs(gv[:, :3] - rv[:, :3]).max() > box_atol:
            raise AssertionError(f"scene_{frame:010d}.ply differs beyond "
                                 f"the tolerance")
    return total


def pointpillars_phase(torch, dev, smi, tmp):
    """PointPillars inference on the card at the surround grid (640 x 640
    pillars, the committed checkpoints at full width, P = 131072 points a
    frame, one frame a forward), from a KITTI-360 tree of 4 frames whose
    sweeps are aggregated (``pillars_tree``):

    * the CLI ``pointpillars-infer --surround --aggregate-sweeps
      --export-ply`` with ``--head ssd`` (its default rotated-NMS decode,
      at PP_SSD_THRESHOLD) and ``--head center``, counters zeroed before
      each: the rotated NMS once per frame in the SSD run, no kernel in the
      center run;
    * ``infer_pointpillars(..., rotated_nms=False)`` through the Python
      API: K5 once per frame;
    * references: the card's heads against a CPU forward of the port
      (first frame of each head, within 2e-3); each frame's card decode
      against the CPU decode of the card's own heads (validity and
      classes exact, boxes7 within 1e-4, scores within 1e-6); the CLI's
      JSON and PLY files against those written from the CPU decode
      (counts and classes exact, boxes7 and coordinates within 2e-3,
      scores within 2e-4: the CLI's forward is another run, and the
      pillar sums are float atomics);
    * CUDA-event times of the forward and the decodes, and a traced frame.

    Returns each run's launches, the SSD path's candidates on the card
    (4, 512, ...) and AABB operands of its first frame, and a summary."""
    from lidar_object_detection_tpu_torch.config import ShapeConfig
    from lidar_object_detection_tpu_torch.data import Kitti360Dataset
    from lidar_object_detection_tpu_torch.models.pointpillars import (
        PillarsConfig, bev_aabb, decode_predictions)
    from lidar_object_detection_tpu_torch.models.pointpillars.decode import (
        decode_candidates)
    from lidar_object_detection_tpu_torch.ops import kernel_lib
    from lidar_object_detection_tpu_torch.pipelines import pointpillars as pp

    t0 = time.perf_counter()
    root = os.path.join(tmp, "pp_kitti360")
    n_cars = pillars_tree(root, np.random.default_rng(2))
    n = len(PP_FRAMES)
    base = ["pointpillars-infer", "--dataset", root, "--surround",
            "--aggregate-sweeps", "--export-ply", "--device", str(dev)]
    thresholds = {"ssd": PP_SSD_THRESHOLD, "center": 0.3}
    launches, outs, texts, walls = {}, {}, {}, {}
    for head in ("ssd", "center"):
        outs[head] = os.path.join(tmp, f"pp_cli_{head}")
        argv = base + ["--ckpt", PP_CKPTS[head], "--head", head,
                       "--output", outs[head]]
        if head == "ssd":
            argv += ["--score-threshold", str(PP_SSD_THRESHOLD)]
        torch.cuda.synchronize()
        kernel_lib.reset_launches()
        t = time.perf_counter()
        texts[head] = run_cli(argv)
        torch.cuda.synchronize()
        walls[head] = time.perf_counter() - t
        launches[head] = dict(kernel_lib.LAUNCHES)
    cfgs = {head: dataclasses.replace(PillarsConfig.kitti360_surround(),
                                      head=head) for head in ("ssd", "center")}
    torch.cuda.synchronize()
    kernel_lib.reset_launches()
    t = time.perf_counter()
    aabb_dets = pp.infer_pointpillars(
        root, PP_CKPTS["ssd"], cfg=cfgs["ssd"], aggregate=True,
        score_threshold=PP_SSD_THRESHOLD, rotated_nms=False, device=dev)
    torch.cuda.synchronize()
    walls["ssd_aabb"] = time.perf_counter() - t
    launches["ssd_aabb"] = dict(kernel_lib.LAUNCHES)
    print(f"PointPillars launches: {launches}; wall s {walls}", flush=True)
    zero = {k: 0 for k in kernel_lib.LAUNCHES}
    for run, want in (("ssd", dict(zero, rotated_nms=n)), ("center", zero),
                      ("ssd_aabb", dict(zero, nms=n))):
        if launches[run] != want:
            raise AssertionError(f"the PointPillars {run} run launched "
                                 f"{launches[run]}, expected {want}")
    if len(aabb_dets) != n:
        raise AssertionError(f"the AABB run gave {len(aabb_dets)} frames")
    phase("PointPillars: the CLI and the API on the card", t0)

    ds = Kitti360Dataset(root)
    p_max = ShapeConfig().max_points
    clouds = list(pp.pillars_clouds(ds, PP_FRAMES, cfgs["ssd"], True, p_max))
    summary = {"cars in the street": n_cars, "cli_wall_s": walls,
               "points": [len(c) for c in clouds]}
    path, aabb = None, None
    for head in ("ssd", "center"):
        cfg, thr = cfgs[head], thresholds[head]
        card, step = pp.load_pillars_model(PP_CKPTS[head], cfg, dev)
        ref_dir = os.path.join(tmp, f"pp_ref_{head}")
        os.makedirs(ref_dir)
        cands, errs = [], []
        for i, (frame, pts) in enumerate(zip(PP_FRAMES, clouds)):
            points, pv = pp.padded_cloud(pts, p_max, dev)
            with torch.inference_mode():
                raw = card(points, pv)
                one = {k: v[0] for k, v in raw.items()}
                det = decode_predictions(one, cfg, score_threshold=thr,
                                         rotated_nms=True)
                one_cpu = {k: v.cpu() for k, v in one.items()}
                ref = decode_predictions(one_cpu, cfg, score_threshold=thr,
                                         rotated_nms=True)
                if i == 0:
                    cpu_model, _ = pp.load_pillars_model(PP_CKPTS[head], cfg,
                                                         "cpu")
                    raw_cpu = cpu_model(points.cpu(), pv.cpu())
                    head_err = max(float((raw[k].cpu() - raw_cpu[k]).abs()
                                         .max()) for k in raw)
                    if head_err > 2e-3:
                        raise AssertionError(f"{head} heads: card and CPU "
                                             f"differ by {head_err}")
                    summary[f"{head}_head_err"] = head_err
                if head == "ssd":
                    boxes7, _, top_idx, top_scores, valid = \
                        decode_candidates(one, cfg, thr)
                    cands.append((boxes7[top_idx], top_scores, valid))
                    if i == 0:
                        aabb = (bev_aabb(boxes7[top_idx])[None].contiguous(),
                                top_scores[None].contiguous(),
                                valid[None].contiguous())
            errs.append(same_detections(det, ref, f"{head} frame {frame}",
                                        1e-4, 1e-6))
            pp.write_detections(pp.detection_record(frame, ref, step), pts,
                                ref_dir, export_ply=True)
        total = same_pillars_outputs(outs[head], ref_dir, PP_FRAMES, 2e-3,
                                     2e-4)
        line = re.search(r"(\d+) frames, (\d+) detections", texts[head])
        if not line or (int(line[1]), int(line[2])) != (n, total):
            raise AssertionError(f"the {head} CLI printed {texts[head]!r}, "
                                 f"the reference has {total} detections")
        summary[head] = {"detections": total,
                         "decode_err_boxes_scores": errs}
        if head == "ssd":
            path = tuple(torch.stack(t).contiguous() for t in zip(*cands))

        # times: forward and decode of the first frame, CUDA events
        points, pv = pp.padded_cloud(clouds[0], p_max, dev)
        with torch.inference_mode():
            fwd_ms, raw = time_events(torch, lambda: card(points, pv), 5)
            one = {k: v[0] for k, v in raw.items()}
            modes = {"rotated": True, "aabb": False} if head == "ssd" \
                else {"peaks": False}
            for mode, rot in modes.items():
                ms, _ = time_events(torch, lambda: decode_predictions(
                    one, cfg, score_threshold=thr, rotated_nms=rot), 5)
                summary[head][f"decode_{mode}_ms"] = ms
            summary[head]["forward_ms"] = fwd_ms
            if head == "ssd":
                print("traced SSD frame (forward + rotated decode):",
                      flush=True)
                profile_once(torch, lambda: decode_predictions(
                    {k: v[0] for k, v in card(points, pv).items()}, cfg,
                    score_threshold=thr, rotated_nms=True))
        del card
    if sum(summary[h]["detections"] for h in ("ssd", "center")) == 0:
        raise AssertionError("PointPillars found nothing in the street")
    print(f"PointPillars: card decodes equal the CPU's on the card's heads, "
          f"the CLI's JSON and PLY files the reference's, on {smi}",
          flush=True)
    print(json.dumps({"pointpillars": summary}), flush=True)
    phase("PointPillars", t0)
    return launches, path, aabb


# ---------------------------------------------------------------------------
# the JAX headline's serving path, streamed from disk
# ---------------------------------------------------------------------------

def frustum_points(rng, n, intrinsics=INTRINSICS, width=W0, height=H0):
    """n velodyne points (n, 4) that all project into the image, at depths
    of 2-45 m: a scan that no compaction to half its size can hold."""
    u = rng.uniform(0, width - 1, n)
    v = rng.uniform(0, height - 1, n)
    z = rng.uniform(2, 45, n)
    k = intrinsics.astype(np.float64)
    cam = np.stack([(u - k[0, 2]) * z / k[0, 0], (v - k[1, 2]) * z / k[1, 1],
                    z], 1)
    points = np.zeros((n, 4), np.float32)
    points[:, :3] = to_velo(cam)
    points[:, 3] = rng.uniform(0, 1, n)
    return points


def load_headline(torch, dev):
    """``bench.py``'s headline detector through the port: the x checkpoint
    at its sidecar's guarded point (0.99, floor 0.5 at 200 px), single
    view, BatchNorm folded, bf16.  Returns (detector, seconds to read and
    load it)."""
    from lidar_object_detection_tpu_torch.models.yolo.serving import (
        load_serving_checkpoint)

    t0 = time.perf_counter()
    detector, step, resolved = load_serving_checkpoint(
        CKPT_X, (H0, W0), tta="none", device=dev, dtype=torch.bfloat16,
        fold_weights=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want = {"scale": "x", "tta": "none", "mask_threshold": 0.99,
            "mask_threshold_floor": 0.5, "mask_min_pixels": 200}
    if any(resolved[k] != v for k, v in want.items()):
        raise AssertionError(f"unexpected serving point {resolved}")
    print(f"headline detector: {os.path.basename(CKPT_X)} step {step}, "
          f"serving point {resolved}, read and loaded in {seconds:.2f} s",
          flush=True)
    return detector, seconds


def headline_stream(torch, dev, rng, detector, root):
    """The streaming path of the JAX headline from a KITTI-360 tree written
    under ``root``: 8 frames (the two committed frames, their mirrors, and
    the four again) with 360-degree sweeps of ``P_HEADLINE`` slots, a frame
    without boxes, and one whose in-view points exceed the compaction
    capacity.  ``stream(chunk=8, compact=True)`` reads them through the
    native prefetcher into a ``MetricStore``; on the card every kernel must
    launch once per chunk.  Its rows must equal, frame by frame, those of
    the uncompacted stream (one loader thread) and of ``run()`` over the
    same frames in one batch; the store's CSV must equal the master CSV
    written from the rows; the frame over capacity must raise.

    Returns the stream's launches, its host times and the device-resident
    operands of the timed and checked cases."""
    from lidar_object_detection_tpu_torch.config import (
        FusionConfig, PipelineVersion)
    from lidar_object_detection_tpu_torch.data import Kitti360Dataset, native
    from lidar_object_detection_tpu_torch.eval.statistics import (
        append_to_master_csv)
    from lidar_object_detection_tpu_torch.eval.store import MetricStore
    from lidar_object_detection_tpu_torch.ops import kernel_lib
    from lidar_object_detection_tpu_torch.pipelines.runner import (
        FusionPipeline)
    from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

    t0 = time.perf_counter()
    sync = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" \
        else (lambda: None)
    t = time.perf_counter()
    native.build()
    build_s = time.perf_counter() - t
    real = [read_png_rgb(path) for path in FRAMES]
    four = real + [np.ascontiguousarray(im[:, ::-1]) for im in real]
    images = np.ascontiguousarray(np.stack(four * 2))
    b = len(images)
    first = detector.detect(images)
    boxes = first["boxes"].float().cpu().numpy()
    valid = first["det_valid"].cpu().numpy()
    frames = []
    for i in range(b):
        points, pvalid, corners, bvalid = make_scene(
            rng, boxes[i], valid[i], num_points=P_HEADLINE, surround=True)
        # the committed PNG files as they are; the mirrors re-encoded
        image = FRAMES[i % 4] if i % 4 < len(FRAMES) else images[i]
        frames.append((100 + i, image, points[pvalid], corners[bvalid]))
    frames.append((200, FRAMES[0], frames[0][2], None))
    frames.append((300, FRAMES[0], frustum_points(rng, P_HEADLINE - 20000),
                   frames[0][3]))
    write_kitti360_tree(root, frames)
    cfg = FusionConfig.for_version(PipelineVersion.CSV_EVAL)
    cfg = dataclasses.replace(cfg, shapes=Kitti360Dataset(root)
                              .tight_shapes())
    ds = Kitti360Dataset(root, shapes=cfg.shapes)
    pipe = FusionPipeline(ds, cfg, detector, device=dev)
    spec = pipe.compaction_spec()
    if (cfg.shapes.max_points, spec.max_out) != (P_HEADLINE,
                                                 P_HEADLINE // 2):
        raise AssertionError(f"shapes {cfg.shapes}, capacity {spec.max_out}")
    ids = [100 + i for i in range(b)]
    stamp = "2026-01-01T00:00:00"
    store_path = os.path.join(root, "store.jsonl")
    phase("headline: tree written", t0)

    sync()
    kernel_lib.reset_launches()
    t = time.perf_counter()
    compact = dict(pipe.stream(ids + [200], chunk=8, compact=True,
                               store=MetricStore(store_path),
                               timestamp=stamp))
    sync()
    wall = time.perf_counter() - t
    launches = dict(kernel_lib.LAUNCHES)
    chunks = -(-b // 8)
    print(f"headline stream launches: {launches} for {chunks} chunk(s)",
          flush=True)
    if sorted(compact) != ids:
        raise AssertionError(f"the stream gave frames {sorted(compact)}")
    if dev.type == "cuda" and any(launches[k] != chunks
                                  for k in PATH_KERNELS):
        raise AssertionError(f"the headline stream launched {launches}, "
                             f"expected each kernel once per chunk")
    # the same again, timed warm; then the references
    sync()
    t = time.perf_counter()
    again = dict(pipe.stream(ids, chunk=8, compact=True))
    sync()
    wall_warm = time.perf_counter() - t
    plain = dict(pipe.stream(ids, chunk=8, compact=False, num_threads=1))
    whole = {f.frame_id: f.statistics for f in pipe.run(ids).frames}
    rows = lambda d: {k: [vars(r) for r in v] for k, v in d.items()}
    for name, other in (("the warm compacted stream", again),
                        ("the uncompacted stream", plain),
                        ("run()", whole)):
        if rows(other) != rows(compact):
            raise AssertionError(f"the compacted stream's rows differ from "
                                 f"{name}'s")
    flat = [r for fid in sorted(compact) for r in compact[fid]]
    matched = sum(r.is_matched for r in flat)
    if not flat or not matched:
        raise AssertionError(f"degenerate headline rows: {len(flat)} rows, "
                             f"{matched} matched")
    store_csv = os.path.join(root, "store.csv")
    rows_csv = os.path.join(root, "rows.csv")
    MetricStore(store_path).export_csv(store_csv)
    append_to_master_csv(flat, rows_csv, stamp)
    with open(store_csv, "rb") as f, open(rows_csv, "rb") as g:
        if f.read() != g.read():
            raise AssertionError("the store's CSV differs from the rows'")
    try:
        list(pipe.stream([300], chunk=8, compact=True))
    except ValueError as e:
        if "after compaction" not in str(e):
            raise
        overflow = str(e)
    else:
        raise AssertionError("a scan over the compaction capacity streamed")

    # the loader's and the PNG decode's parts, timed on their own
    t = time.perf_counter()
    loaded = sorted(native.ScanPrefetcher(
        [ds.scan_path(f) for f in ids], cfg.shapes.max_points,
        queue_depth=16, compaction=spec))
    corners = [ds.load_boxes(f) for f in ids]
    loader_s = time.perf_counter() - t
    batch = pipe._assemble_stream_batch(
        [(fid, pts, pv, n, c) for fid, (_, pts, pv, n), c
         in zip(ids, loaded, corners)])
    t = time.perf_counter()
    decoded = ds.load_images(batch)
    decode_s = time.perf_counter() - t
    if not np.array_equal(decoded, images):
        raise AssertionError("the decoded frames differ from the PNGs'")
    kept = [n for *_, n in loaded]
    raw = [os.path.getsize(ds.scan_path(f)) // 16 for f in ids]
    print(f"headline stream: {b} frames, {len(flat)} rows, {matched} "
          f"matched, equal to the uncompacted stream's and run()'s, and the "
          f"store's CSV to the rows'; compaction kept {kept} of {raw} "
          f"points; over capacity: {overflow}; loader built in "
          f"{build_s:.2f} s", flush=True)

    # several chunks, for the rate: the eight frames three times more (the
    # PNG files copied), so that the producer thread decodes a chunk while
    # the card serves the one before
    more = [(fid + b * k, ds.image_path(fid), pts, c)
            for k in range(1, 4) for fid, _, pts, c in frames[:b]]
    write_kitti360_tree(root, more)
    many = ids + [fid for fid, *_ in more]
    sync()
    kernel_lib.reset_launches()
    t = time.perf_counter()
    streamed = dict(pipe.stream(
        many, chunk=8, compact=True,
        store=MetricStore(os.path.join(root, "many.jsonl")),
        timestamp=stamp))
    sync()
    wall_many = time.perf_counter() - t
    launches_many = dict(kernel_lib.LAUNCHES)
    chunks_many = len(many) // 8
    if sorted(streamed) != sorted(many):
        raise AssertionError(f"the stream of {len(many)} frames gave "
                             f"{sorted(streamed)}")
    if dev.type == "cuda" and any(launches_many[k] != chunks_many
                                  for k in PATH_KERNELS):
        raise AssertionError(f"the stream of {chunks_many} chunks launched "
                             f"{launches_many}")
    # the chunks' composition follows the loader threads' completion order
    same = sum(
        [dict(vars(r), frame=0) for r in streamed[fid]]
        == [dict(vars(r), frame=0) for r in compact[ids[(fid - 100) % b]]]
        for fid in many)
    t = time.perf_counter()
    for fid in many:
        read_png_rgb(ds.image_path(fid))
    decode_many_s = time.perf_counter() - t
    times = {"build_s": build_s, "stream_s": wall, "stream_warm_s": wall_warm,
             "loader_s": loader_s, "decode_s": decode_s,
             "kept_share": sum(kept) / sum(raw), "frames_many": len(many),
             "chunks_many": chunks_many, "stream_many_s": wall_many,
             "decode_many_s": decode_many_s, "same_rows_many": same,
             "launches_many": launches_many}
    print(f"headline stream of {len(many)} frames in {chunks_many} chunks: "
          f"launches {launches_many}; {same} of {len(many)} frames' rows "
          f"equal to their copy's in the one-chunk stream", flush=True)
    phase("headline stream", t0)
    return launches, times, (images, batch, pipe)


def headline_device(torch, dev, smi, detector, operands, times):
    """The headline on the card: the x forward, the stream's frames/s with
    the loader's and the PNG decode's shares, detect + fuse device-resident
    at B = 8 (CUDA events), and K1, K3, K2 and K5 held to their twins at
    the path's shapes and timed.  Returns each kernel's headline entries."""
    from lidar_object_detection_tpu_torch.fusion.associate import fuse_batch
    from lidar_object_detection_tpu_torch.models.yolo.postprocess import (
        cropped_prob_table, nms_candidates, postprocess_batch)
    from lidar_object_detection_tpu_torch.ops import inside_counts as ic
    from lidar_object_detection_tpu_torch.ops import mask_assembly as ma
    from lidar_object_detection_tpu_torch.ops import nms as nms_lib

    t0 = time.perf_counter()
    images, batch, pipe = operands
    b = len(images)
    gpu_images = torch.from_numpy(images).to(dev)
    points = torch.from_numpy(batch.points).to(dev)
    pvalid = torch.from_numpy(batch.point_valid).to(dev)
    bvalid = torch.from_numpy(batch.box_valid).to(dev)
    corners = pipe._gt_corners(batch)
    calib = (pipe._velo_to_rect, pipe._corners_to_velo, pipe._intrinsics)

    events = lambda fn: time_events(torch, fn)
    forward_ms, outputs = events(lambda: detector.forward(gpu_images))

    def step():
        det = detector.detect(gpu_images)
        return det, fuse_batch(points, pvalid, det["mask_bits"],
                               det["det_valid"], corners, bvalid, *calib,
                               params=pipe.params)

    step_ms, (det, fused) = events(step)
    print(f"headline x forward: {forward_ms:.2f} ms per batch of {b} "
          f"(bf16, folded, single view, CUDA events over 10 batches) on "
          f"{smi}", flush=True)
    print(f"headline stream: {b / times['stream_s']:.2f} frames/s cold, "
          f"{b / times['stream_warm_s']:.2f} warm (host clock: prefetch "
          f"and compaction, boxes, PNG decode, detect, fuse, rows, store) "
          f"on {smi}; loader {times['loader_s']:.3f} s "
          f"({times['loader_s'] / times['stream_warm_s']:.3f} of the warm "
          f"stream), PNG decode {times['decode_s']:.3f} s "
          f"({times['decode_s'] / times['stream_warm_s']:.3f}); compaction "
          f"kept {times['kept_share']:.3f} of the points", flush=True)
    print(f"headline detect + fuse, device-resident: "
          f"{b / step_ms * 1e3:.2f} frames/s ({step_ms:.2f} ms per batch of "
          f"{b}, CUDA events over 10 batches) on {smi}", flush=True)
    n, k = times["frames_many"], times["chunks_many"]
    wall_many, decode_many = times["stream_many_s"], times["decode_many_s"]
    serial_s = k * (times["loader_s"] + step_ms / 1e3) + decode_many
    print(f"headline stream of {n} frames in {k} chunks: "
          f"{n / wall_many:.2f} frames/s ({wall_many:.3f} s, host clock) on "
          f"{smi}; PNG decode of the {n} frames alone {decode_many:.3f} s "
          f"({decode_many / wall_many:.3f} of the stream); loader, decode "
          f"and detect + fuse one after another {serial_s:.3f} s",
          flush=True)

    cases = {}
    p = detector.params
    # K1 on the compacted points and the path's own words
    k1_args = (points[..., :3].contiguous(), fused["point_bits"],
               fused["corners_velo"].contiguous(), fused["box_visible"])
    d = p.max_detections
    got = ic.inside_counts_cuda(*k1_args, d)
    ref = ic.inside_counts_plain(*k1_args, d)
    err = max(int((x - y).abs().max()) for x, y in zip(got, ref))
    if err or int(got[0].sum()) == 0:
        raise AssertionError(f"K1 at the headline's shapes: error {err}, "
                             f"{int(got[0].sum())} hits")
    active, pairs, (bound, by) = k1_bound(*k1_args, d=d)
    cases["inside_counts"] = {
        "headline_ms": time_gpu(k1_launcher(torch, dev, *k1_args, d=d)),
        "headline_plain_ms": time_gpu(
            lambda: ic.inside_counts_plain(*k1_args, d), reps=10,
            head_start=False),
        "headline_bound_ms": bound, "headline_bound_by": by,
        "headline_max_abs_err": err,
        "headline_shape": f"B={b} P={points.shape[1]} G={bvalid.shape[1]} "
                          f"D={d}, {active} active points, {pairs} pairs, "
                          f"{k1_bytes(*k1_args[1::2], d)} bytes"}
    # K5 on the single view's candidates
    _, bx, sc, va = nms_candidates(outputs, p)
    bx, sc, va = bx.contiguous(), sc.contiguous(), va.contiguous()
    thr, m = p.iou_threshold, p.max_detections
    idx, keep = nms_lib.nms_cuda(bx, sc, va, thr, m)
    ref_idx, ref_keep = nms_lib.nms_plain(bx, sc, va, thr, m)
    err = max(int((idx - ref_idx).abs().max()),
              int((keep != ref_keep).any()))
    picks = keep.sum(dim=1).tolist()
    if err or not sum(picks):
        raise AssertionError(f"K5 at the headline's shapes: error {err}, "
                             f"picks {picks}")
    bound, by = nms_bound(picks, b, sc.shape[1], m)
    cases["nms"] = {
        "headline_ms": time_gpu(nms_launcher(torch, dev, bx, sc, va, thr,
                                             m)),
        "headline_plain_ms": time_gpu(
            lambda: nms_lib.nms_plain(bx, sc, va, thr, m), reps=10,
            head_start=False),
        "headline_bound_ms": bound, "headline_bound_by": by,
        "headline_max_abs_err": err,
        "headline_shape": f"B={b} N={sc.shape[1]} M={m}, picks {picks}"}
    # K3 and K2 on the x detector's single-view tables, guarded
    dets = postprocess_batch(outputs, p, masks=False)
    table = cropped_prob_table(outputs["proto"], dets["coef"], p.spec)
    ops = ma.prepare_operands(table, dets["boxes"], dets["det_valid"], H0,
                              W0, p.mask_threshold)
    counts = ma.count_above_cuda(ops)
    ref_counts = ma.count_above_plain(ops)
    guard = ma.Guard(ref_counts, p.mask_threshold_floor, p.mask_min_pixels)
    words = ma.assemble_masks_cuda(ops, guard)
    ref_words = ma.assemble_masks_plain(ops, guard)
    errs = {"mask_count": int((counts - ref_counts).abs().max()),
            "mask_assemble": int((words ^ ref_words).ne(0).any())}
    under = int(((ref_counts < p.mask_min_pixels) & ops.valid).sum())
    if any(errs.values()) or not bool((words != 0).any()):
        raise AssertionError(f"K3/K2 at the headline's shapes: {errs}")
    if not torch.equal(words, det["mask_bits"]):
        raise AssertionError("K2's words differ from the detector's")
    out = torch.empty((b, H0, W0), dtype=torch.int32, device=dev)
    zeros = torch.zeros(ops.table.shape[:2], dtype=torch.int32, device=dev)
    shape = (f"B={b} D={d} table {tuple(ops.table.shape[2:])}, "
             f"{int(ops.valid.sum())} valid, guard fires for {under}")
    for name, launch, plain in (
            ("mask_count", lambda: ma.launch("mask_count_launch", ops,
                                             zeros),
             lambda: ma.count_above_plain(ops)),
            ("mask_assemble", lambda: ma.launch("mask_assemble_launch", ops,
                                                out, guard),
             lambda: ma.assemble_masks_plain(ops, guard))):
        bound, by = mask_bound(ops, name == "mask_count")
        cases[name] = {
            "headline_ms": time_gpu(launch),
            "headline_plain_ms": time_gpu(plain, reps=10, head_start=False),
            "headline_bound_ms": bound, "headline_bound_by": by,
            "headline_max_abs_err": errs[name], "headline_shape": shape}
    # the same tables with a pixel floor above every valid count, so that
    # the guard fires for each detection and K2 cuts all at the floor
    fire = ma.Guard(ref_counts, p.mask_threshold_floor,
                    int(ref_counts[ops.valid].max()) + 1)
    fired = ma.assemble_masks_cuda(ops, fire)
    err = int((fired ^ ma.assemble_masks_plain(ops, fire)).ne(0).any())
    if err or bool((fired == words).all()):
        raise AssertionError(f"K2 with the guard firing: error {err}, or "
                             f"the same words as without it")
    bound, by = mask_bound(ops, False)
    fired_ms = time_gpu(
        lambda: ma.launch("mask_assemble_launch", ops, out, fire))
    fired_plain_ms = time_gpu(lambda: ma.assemble_masks_plain(ops, fire),
                              reps=10, head_start=False)
    cases["mask_assemble"].update({
        "headline_guarded_ms": fired_ms,
        "headline_guarded_plain_ms": fired_plain_ms,
        "headline_guarded_bound_ms": bound,
        "headline_guarded_max_abs_err": err})
    print(f"headline mask_assemble, guard firing for all "
          f"{int(ops.valid.sum())} valid: equal to the twin; {fired_ms:.4f} "
          f"ms (twin {fired_plain_ms:.4f}, bound {bound:.4g} by {by})",
          flush=True)
    for name, case in cases.items():
        print(f"headline {name}: equal to the twin; {case['headline_ms']:.4f}"
              f" ms (twin {case['headline_plain_ms']:.4f}, bound "
              f"{case['headline_bound_ms']:.4g} by "
              f"{case['headline_bound_by']}) at {case['headline_shape']}",
              flush=True)
    print(json.dumps({"headline": {
        "x_forward_ms": forward_ms, "detect_fuse_ms": step_ms,
        "detect_fuse_frames_per_s": b / step_ms * 1e3,
        "stream_frames_per_s": b / times["stream_s"],
        "stream_warm_frames_per_s": b / times["stream_warm_s"],
        "stream_many_frames_per_s": n / wall_many,
        "serial_s": serial_s, **times}}), flush=True)
    phase("headline on the card", t0)
    return cases


def stage_times(torch, detector, images, points, pvalid, corners, bvalid,
                calib, params, reps=5):
    """Median host-clock ms of each stage of the main path, the card
    synchronised between stages."""
    from lidar_object_detection_tpu_torch.eval.statistics import (
        frame_statistics)
    from lidar_object_detection_tpu_torch.fusion.associate import fuse_batch

    times = {"forward": [], "decode": [], "fusion": [], "statistics": []}
    for _ in range(reps):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        outputs = detector.forward(images)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        det = detector.decode(outputs)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        fused = fuse_batch(points, pvalid, det["mask_bits"],
                           det["det_valid"], corners, bvalid, *calib,
                           params=params)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        for b in range(len(images)):
            frame_statistics(b, fused["total_points"][b],
                             fused["best_box"][b], fused["points_inside"][b],
                             fused["matched"][b], det["det_valid"][b],
                             fused["box_visible"][b])
        t.append(time.perf_counter())
        for name, a, b in zip(times, t, t[1:]):
            times[name].append((b - a) * 1e3)
    print(json.dumps({"stage_ms": {k: float(np.median(v))
                                   for k, v in times.items()}}), flush=True)


def profile_once(torch, run):
    """One main-path iteration under torch.profiler: the card's busy share
    of the traced wall time and the kernels that took most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("profile: the profiler recorded no device activity; the busy "
              "share is not measured", flush=True)
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, (lo, hi) = 0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    busy += hi - lo
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0) + (e.time_range.end
                                                    - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({"profile": {
        "traced_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
        "busy_share": busy / wall_us, "device_kernels": len(kernels),
        "top_kernels_ms": [[n[:90], t / 1e3] for n, t in top]}}),
        flush=True)


def main() -> int:
    t0 = time.perf_counter()
    import torch

    print(f"torch {torch.__version__}", flush=True)
    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py runs on a card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from lidar_object_detection_tpu_torch.ops import kernel_lib
    except ImportError as e:
        print(f"the port is not beside this script: {e}", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    kernel_lib.build(verbose=True)
    print(f"kernel build: {kernel_lib.build_info['seconds']:.2f} s",
          flush=True)
    phase("build", t0)

    detector, images, scenes = load_serving(torch, dev, rng)
    kernels = [check_inside_counts(torch, dev, rng, scenes)]
    kernels += check_mask_kernels(torch, dev, rng, detector, images)
    kernels.append(check_nms(torch, dev, rng, detector, images))
    phase("kernels against twins", t0)

    launches = main_path(torch, dev, smi, detector, images, scenes)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    with tempfile.TemporaryDirectory() as tmp:
        csv_launches, root = csv_eval_phase(torch, dev, smi, images, scenes,
                                            tmp)
        match_launches, problem = matching_phase(torch, dev, smi, root, tmp)
    lap = check_lap(torch, dev, rng, problem)
    for k in kernels:
        k["csv_eval_launches"] = csv_launches[k["name"]]
    del detector
    headline, _ = load_headline(torch, dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches, times, operands = headline_stream(
            torch, dev, np.random.default_rng(1), headline,
            os.path.join(tmp, "kitti360"))
        cases = headline_device(torch, dev, smi, headline, operands, times)
    for k in kernels:
        k["headline_launches"] = launches[k["name"]]
        k["headline_launches_4_chunks"] = times["launches_many"][k["name"]]
        k.update(cases[k["name"]])
    del headline
    with tempfile.TemporaryDirectory() as tmp:
        pp_launches, pp_path, pp_aabb = pointpillars_phase(torch, dev, smi,
                                                           tmp)
    rotated = check_rotated_nms(torch, dev, rng, pp_path)
    next(k for k in kernels if k["name"] == "nms").update(
        check_pp_aabb(torch, dev, pp_aabb))
    phase("PointPillars kernels against twins", t0)
    # the solver's main path is the V5 run
    lap.update(launches=match_launches["v5"]["lap"],
               csv_eval_launches=csv_launches["lap"],
               headline_launches=launches["lap"],
               headline_launches_4_chunks=times["launches_many"]["lap"])
    kernels.append(lap)
    # the rotated NMS's main path is the SSD head's CLI run
    rotated.update(launches=pp_launches["ssd"]["rotated_nms"],
                   csv_eval_launches=csv_launches["rotated_nms"],
                   headline_launches=launches["rotated_nms"],
                   headline_launches_4_chunks=times["launches_many"][
                       "rotated_nms"])
    kernels.append(rotated)
    for k in kernels:
        k["matching_launches"] = {run: n[k["name"]]
                                  for run, n in match_launches.items()}
        k["pointpillars_launches"] = {run: n[k["name"]]
                                      for run, n in pp_launches.items()}
    phase("total", t0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
