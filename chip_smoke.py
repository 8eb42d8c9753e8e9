#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one CUDA card.  It:

1. prints the PyTorch version and the card's name and power limit, and
   fails when CUDA is not available;
2. builds the CUDA kernels of ``lidar_object_detection_tpu_torch`` from the
   checkout's sources (one ``nvcc`` per source, all started together, then
   a link into one ctypes-loaded library), and times the empty kernel of
   ``csrc/launch_floor.cu`` as the kernels are timed: the floor under
   every kernel's time (``launch_floor_ms`` in the kernels line);
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
   detections, a count exactly at the guard's minimum, and frames whose
   width is not a multiple of 4: KITTI's 375 x 1242 and 376 x 1241 and
   370 x 1223, boxes on the last quad's columns and clamped to the
   width); and K5 (NMS) on
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
   frame in the SSD run, K5 once a frame in the AABB run.  Each CLI run is
   made twice, and the second must write the first's bytes.  The card's
   heads are held to a CPU forward and to a second forward on the card
   (bit for bit), its decodes to CPU decodes of the same heads, the CLI's
   JSON and PLY files to those written from the card's decode (byte for
   byte) and from the CPU's (within the decode's tolerances).  Then the
   rotated NMS is held to its twin on the SSD path's own 512 candidates
   of each frame and on seeded cases (B = 4, N = 512, M = 64: heavy
   overlap, all invalid, NaN scores, equal scores; B = 64 of degenerate
   boxes, some of whose pairs must take the kernel's ring routine), IoU
   rows within 1e-5, and timed; K5 on the AABB path's candidates;
9. trains PointPillars at the surround grid on that street (full width,
   4 frames of 131072 points a step): the CLI's ``pointpillars-train
   --surround --aggregate-sweeps --max-points 131072 --checkpoint-dir``
   with ``--head ssd`` (8 steps; the assigner's IoU kernel once a step,
   the closing evaluation's rotated NMS once a frame) and ``--head
   center`` (4 steps, no kernel), each run twice with the counters
   zeroed before each: byte-equal checkpoints, finite losses, the SSD
   run's final below its first, the center run's (loss, num_pos) steps
   held to the same run on the CPU; ``pointpillars-infer --ckpt`` on
   what was written;
   one full-width step from the committed SSD variables on the card
   against the CPU port (loss parts, num_pos, gradients within a fixed
   share of each tensor's largest entry; the CPU's one-ulp spread is
   printed beside it); CUDA-event times of the step split into the
   assignment, forward (with and without cuDNN's deterministic flag),
   loss, backward and optimizer, and a traced step.
   Then the assigner's IoU kernel (``rotated_iou_pairs_kernel`` of
   ``csrc/rotated_nms.cu``) is held to its twin on the step's real
   candidate pairs (4 x 64 x 512), a seeded heavy overlap and degenerate
   boxes (some pairs through the ring routine), IoUs within 1e-5, the
   step's assignment replayed from the kernel's IoUs, and timed;
10. trains YOLO11n-seg at full width (80 classes, 192 x 640, 32 targets
   a frame) on a KITTI-360 tree of the two committed frames and their
   mirrors, each scan built around the n checkpoint's detections: the
   distillation runner's labels built on the card equal the CPU's; one
   step from the committed n variables on the card against the CPU's
   (loss parts, gradients within a fixed share of each tensor's largest
   entry; the CPU's one-ulp spread printed beside); the runner's ``main``
   twice at ``--steps 8 --ema-decay 0.9``, byte-equal checkpoints, its
   closing evaluation launching K5 and K2 once each and a step nothing;
   ``--eval-only`` with the same TP, FP and FN on the card and the CPU;
   CUDA-event times of the n step (forward, loss, backward, AdamW, EMA)
   and of the committed x variables' step, and a traced n step;
11. trains in bfloat16 mixed precision (``bf16_train_phase``:
   ``YoloTrainer`` and ``PillarsTrainer`` with ``dtype=torch.bfloat16``,
   float32 master weights): the n step on the YOLO phase's batch and the
   PointPillars SSD step at the surround grid from the committed
   variables against the CPU's bfloat16 steps, in units of the CPU's
   bfloat16 drift from float32; 8 n and 8 SSD steps twice, byte-equal,
   the SSD steps launching ``rotated_iou_pairs`` once each, the kernel
   against its twin on the bfloat16 step's pairs; float32 and bfloat16
   step times alternated (n split into forward, loss, backward, AdamW
   and EMA; x; SSD) and traced steps; the center head's 4 steps card
   against CPU.  It prints its ``{"bf16_train": ...}`` line with the
   card's name and power limit;
12. runs the scale-out layer (``scale_out_phase``): a world of one on NCCL
   in this process, where the mesh trainer's full-width n step is
   byte-equal to the one-card step and point-sharded and frame-sharded
   fusion of the main path's 4 scans equal ``fuse_batch`` (K1 once per
   frame, once per batch); then two ranks on the one card over gloo
   (fresh processes): the n step at data 2 and at model 2 and the
   PointPillars SSD step at the surround grid (2 + 2 frames) against
   the one-process steps, point-sharded fusion, the pipeline against the
   sequential chain, and the distillation runner twice under 2 ranks
   (rank 0 alone writes, the same bytes); step times (one card and mesh
   alternated, and the mesh with local BatchNorm statistics), all-reduce
   times and a traced mesh step;
13. runs the KITTI 2D evaluation from a KITTI_Selection tree of three
   images cut from the committed frames at KITTI's shapes (375 x 1242,
   370 x 1224, 376 x 1241), labelled with the n checkpoint's cars and a
   KITTI-like calib: the CLI's ``kitti2d`` on the card (YOLO11x's
   detection head at full width, 224 x 640 after the letterbox, random
   weights from seed 0, as the JAX CLI's) and with ``--device cpu``, TP /
   FP / FN equal, K5 once per image and no other kernel; the default
   detector's boxes on the card against the CPU's and the result lines
   where both truncations agree; then ``run_kitti2d_eval`` with a
   ``detect_fn`` on the n checkpoint on the card and the CPU.  It prints
   the per-image forward and decode times (CUDA events) and the CLI's
   host seconds.  Then JPEG (``jpeg_phase``): the port's codec (host C++
   and its numpy twin) decodes the committed Pillow fixtures of
   ``tests/fixtures/jpeg`` to the recorded hashes of Pillow's pixels and
   encodes a crop to the recorded hash of Pillow's bytes; the same KITTI
   2D tree with its images written as JPEG by the port's encoder goes
   through ``kitti2d`` on the card and the CPU (K5 once per image and no
   other kernel, TP / FP / FN equal, the ``.jpg.txt`` lines, annotated
   JPEGs that decode); it prints the codec's host milliseconds for a
   375 x 1242 image, and fails past 60 s;
14. decodes the n float32 detector's raw outputs on the committed frames
   (B = 4) in the modes the serving path does not run -- logit at 0.9,
   relative at 0.5 (the peak pass, then K2), ``emit_coef`` with
   ``mask_prob_fields`` and ``pack_thresholded_masks`` -- and YOLO11x's
   detection-only decode, each on the card and on the CPU: mask words
   equal bit for bit.  The relative cut's peak pass
   (``mask_peak_kernel`` of ``csrc/mask_assembly.cu``) is held to its
   twin, float bits equal, on those tables and on ``mask_cases``, and
   timed over 20 launches;
15. runs the PointPillars tools and the long cloud
   (``pillars_tools_phase``), each stage timed by
   ``utils.profiling.StageTimer``: the surround runner
   (``pipelines.pillars_surround``, full surround grid, 65536 points a
   frame, 4 frames a step) resumed twice from a full checkpoint of the
   committed SSD variables at step 15000, for 3 steps and its evaluation,
   the two runs' checkpoints, caches and reports equal; the gate on both
   committed checkpoints, its line the same on the card and the CPU; the
   diagnosis tool on the runner's checkpoint, and the rotated NMS at
   M = 128 on its candidates against the twin; ``pipelines.longcloud`` on
   a 20-sweep aggregate of 1,310,720 points, and K1 against its twin on
   those operands and tiled to 5,242,880 points (past 132 blocks of
   32,768);
16. runs the serving-quality protocol and the YOLO-side tools
   (``quality_phase``) from a KITTI-360 tree of the main path's 4 frames
   (frame 100 first): ``pipelines.quality``'s ``knob-sweep``,
   ``threshold-cv``, ``flip-probe`` and ``imgsz-probe --imgsz 640 1408``
   with YOLO11x-seg at full width on the card, each launching what its
   configurations should; the x forward at imgsz 640 and 1408 and a
   configuration's decode and fusions, timed; K3, K2 and the peak pass on
   the imgsz-1408 tables (94 x 352) and K1 on a configuration's operands
   against their twins; ``tools/forward_times.py --top-ops`` on the
   card (a positive op total, the port's kernels among the ops); then,
   on a light tree of frames 100 and 101, the four subcommands with
   YOLO11n-seg twice on the card (the same payloads but for their
   timings) and on the CPU (at most ``QUALITY_WORD_SHARE`` of a fusion's
   mask words different, the rows of the detections whose words are
   equal exact, percentages within ``QUALITY_PCT_TOL``);
   ``pipelines.regen_artifacts`` twice on the card and on the CPU, held
   the same way from the detections each run fused;
   ``yolo_distill --eval-targets`` on the card and the CPU;
   ``yolo-export`` of the n checkpoint served back through ``run
   --weights``;
17. prints one JSON line of the kernels (times, bounds, launches, errors;
   ``headline_*`` for the headline's case, ``matching_launches`` of the
   V4, V5 and depth-map runs, ``pointpillars_launches`` of the three
   PointPillars runs, ``pointpillars_train_launches`` of the four
   training runs, ``yolo_train_launches`` of a YOLO step and of the
   runner's first run, ``bf16_train_launches`` of the bfloat16 n and SSD
   runs, ``scale_out_launches`` of each scale-out path,
   ``kitti2d_launches`` of the card's ``kitti2d`` run,
   ``kitti2d_jpeg_launches`` of its run on the JPEG tree,
   ``relative_decode_launches``, ``pillars_tools_launches``,
   ``quality_launches`` of each quality run and ``regen_launches`` of the
   regeneration's, and ``*_imgsz1408`` and ``*_quality`` for the kernels
   on the quality phase's operands), the
   card's name and power limit, and
   last the ``{"ok": true, ...}`` line.

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
# kernels that the serving path never launches: V5's solver, the
# PointPillars decode's rotated NMS, the relative cut's peak pass and the
# PointPillars training assigner's rotated IoU
OFF_PATH_KERNELS = ("lap", "rotated_nms", "mask_peak", "rotated_iou_pairs")
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


def quality_tree(root, images, scenes, first_id=100):
    """A KITTI-360 tree of one frame per scene, ids from ``first_id``
    (frame 100, the regeneration's V5 frame, first): the committed PNG
    files for the first two frames as they are, ``images[b]`` for the
    others, and each scene's scan and boxes (``make_scene``'s tuples)."""
    frames = []
    for b, (points, pvalid, corners, bvalid) in enumerate(scenes):
        image = FRAMES[b] if b < len(FRAMES) else images[b]
        frames.append((first_id + b, image, points[pvalid], corners[bvalid]))
    write_kitti360_tree(root, frames)
    return root


# KITTI's image shapes vary a little; these three exercise the KITTI 2D
# evaluation's per-shape detector cache
KITTI2D_SHAPES = ((375, 1242), (370, 1224), (376, 1241))


def write_kitti2d_tree(root, samples, ext=".png"):
    """A KITTI_Selection tree under ``root``: for each ``(name, image,
    labels, calib)`` of ``samples``, ``images/<name><ext>`` (a (H, W, 3)
    uint8 array, written as PNG or JPEG by ``utils.image.write_image_rgb``),
    and, unless None, ``labels/<name>.txt`` (rows ``class x1 y1 x2 y2
    distance``) and ``calib/<name>.txt`` (a 3 x 3 or 3 x 4 camera
    matrix)."""
    from lidar_object_detection_tpu_torch.utils.image import write_image_rgb

    for d in ("images", "labels", "calib"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for name, image, labels, calib in samples:
        write_image_rgb(os.path.join(root, "images", name + ext), image)
        if labels is not None:
            with open(os.path.join(root, "labels", name + ".txt"), "w") as f:
                f.writelines(f"{row[0]} " + " ".join(repr(float(v))
                                                     for v in row[1:]) + "\n"
                             for row in labels)
        if calib is not None:
            np.savetxt(os.path.join(root, "calib", name + ".txt"),
                       np.asarray(calib, np.float64))


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

# frame shapes whose width is not a multiple of 4: KITTI's 1242 and 1241
# (W = 2, 1 mod 4) and one W = 3 mod 4
ODD_SHAPES = ((375, 1242), (376, 1241), (370, 1223))


def odd_width_cases(rng):
    """``mask_cases``' dense B = 4, off-the-image and border cases at each
    of ODD_SHAPES, and a case of boxes on the last quad's columns (the
    columns past the last multiple of 4, a box ending a hair before, at
    and past the true width, boxes clamped to it): name -> (h, w, (table,
    boxes, valid))."""
    out = {}
    for h, w in ODD_SHAPES:
        cases = mask_cases(rng, h, w)
        for name in ("dense B=4", "off the image", "borders and fractions"):
            out[f"{name} {h}x{w}"] = (h, w, cases[name])
        table, boxes, valid = cases["borders and fractions"]
        last = 4 * (w // 4)
        rows = [[last, 0, w, h], [last - 1, 3, w, h - 3],
                [last + 0.5, 1.5, w - 0.25, 40.5], [w - 1, 0, w, h],
                [w - 0.5, 7, w + 0.5, 19], [w - 6, 10, w + 30, 60],
                [last - 3.5, 2, w + 1e6, h + 5], [-10, -10, w + 10, h + 10],
                [w - 2, h - 2, np.inf, np.inf], [last + 1, 0, last + 2, h]]
        boxes = boxes.copy()
        boxes[0, :len(rows)] = np.array(rows, np.float32)
        out[f"last quad {h}x{w}"] = (h, w, (table, boxes, valid))
    return out


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


def empty_launcher(dev):
    """A launch of the empty kernel (``csrc/launch_floor.cu``): the floor
    under every kernel's time."""
    from lidar_object_detection_tpu_torch.ops import kernel_lib

    lib = kernel_lib.library()
    stream = kernel_lib.stream_handle(dev)
    return lambda: kernel_lib.check(lib.empty_launch(stream),
                                    "empty_launch")


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
    ops_of.update({name: ma.prepare_operands(
        *(torch.from_numpy(a).to(dev) for a in arrays), h, w, thr)
        for name, (h, w, arrays) in odd_width_cases(rng).items()})
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
        out = torch.empty((ops.table.shape[0], *ops.shape),
                          dtype=torch.int32, device=dev)
        counts = torch.zeros(ops.table.shape[:2], dtype=torch.int32,
                             device=dev)
        guard = ma.Guard(ma.count_above_plain(ops), floor, min_pixels)
        if name == "mask_count":
            return lambda: ma.launch("mask_count_launch", ops, counts)
        return lambda: ma.launch("mask_assemble_launch", ops, out, guard)

    odd = f"dense B=4 {ODD_SHAPES[0][0]}x{ODD_SHAPES[0][1]}"
    timed = {"": "main path B=4", "_b1": "main path B=1",
             "_synthetic": "dense B=4", "_synthetic_b1": "dense B=1",
             "_odd_width": odd}
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
              f"{entry['bound_ms_synthetic_b1']:.4g}); {odd} "
              f"{entry['ms_odd_width']:.4f} (bound "
              f"{entry['bound_ms_odd_width']:.4g}); twin "
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
        entry["us_per_step" + suffix] = (entry["ms" + suffix] * 1e3
                                         / entry["chain_steps" + suffix])
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
          f"{entry['chain_steps']} steps, {entry['us_per_step']:.3f} us a "
          f"step), seeded B=4 {entry['ms_b4']:.4f}, "
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
    return launches, det


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


def run_cli(argv, entry=None):
    """Run the port's CLI (or another ``main(argv)``, ``entry``) in this
    process, echo its output, and return the output; a non-zero exit
    raises."""
    from lidar_object_detection_tpu_torch.pipelines import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = (entry or cli.main)(argv)
    text = buf.getvalue()
    print(text, end="", flush=True)
    if code != 0:
        raise AssertionError(f"{argv} exited {code}")
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
                    lap=solver, rotated_nms=0, mask_peak=0,
                    rotated_iou_pairs=0)
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
    NaN (and some infinite), scores that tie in groups, and degenerate
    boxes (``degenerate_boxes``, 16 B frames)."""
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
    cases["degenerate"] = degenerate_boxes(rng, 16 * batch, n)
    return cases


def degenerate_boxes(rng, frames, n):
    """Rotated-NMS operands of degenerate boxes, all valid: per frame,
    copies of one car-sized box near the origin with x, y, w and l moved
    by up to 3 ulps (coincident edges and corners, up to rounding), n / 32
    boxes of width 0 or 1e-10 (areas under the IoU's 1e-9 union cut), and
    the rest in a row along one edge line, ends touching.  The copies'
    rings, clipped by a pick's edges, can flip sides more than twice where
    three vertices lie on a clip line up to rounding, and then outgrow the
    kernel's register slots.  Few pairs do, and which depends on the box's
    bits, so the case has many frames."""
    b = np.zeros((frames, n, 7), np.float32)
    b[..., 2], b[..., 5] = -1.0, 1.5
    m = max(n // 32, 1)
    g = n - 2 * m
    near = lambda: (rng.uniform(0.2, 0.8, (frames, 1))
                    * rng.choice([-1.0, 1.0], (frames, 1)))
    b[:, :g, 0], b[:, :g, 1] = near(), near()
    b[:, :g, 3] = rng.uniform(1.4, 2.2, (frames, 1))
    b[:, :g, 4] = rng.uniform(3.2, 5.0, (frames, 1))
    b[:, :g, 6] = rng.uniform(-np.pi, np.pi, (frames, 1))
    for f in (0, 1, 3, 4):
        ulps = rng.integers(-3, 4, (frames, g)).astype(np.int32)
        b[:, :g, f] = (b[:, :g, f].view(np.int32) + ulps).view(np.float32)
    thin = slice(g, g + m)
    b[:, thin, 0] = rng.uniform(-12, 12, (frames, m))
    b[:, thin, 1] = rng.uniform(-8, 8, (frames, m))
    b[:, thin, 3] = np.where(rng.uniform(size=(frames, m)) < 0.5, 0.0, 1e-10)
    b[:, thin, 4] = rng.uniform(3.0, 5.0, (frames, m))
    b[:, thin, 6] = rng.uniform(-np.pi, np.pi, (frames, m))
    row = slice(g + m, n)
    b[:, row, 0] = -16.0 + 4.0 * np.arange(n - g - m)
    b[:, row, 1] = 14.0
    b[:, row, 3], b[:, row, 4], b[:, row, 6] = 2.0, 4.0, 0.0
    s = rng.uniform(0, 1, (frames, n)).astype(np.float32)
    return b, s, np.ones((frames, n), bool)


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
            out_idx.data_ptr(), out_keep.data_ptr(), None, None,
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


def compare_rotated_nms(torch, dev, cases, thr, m):
    """The rotated-NMS kernel against its twin on each case (``name ->
    (boxes7, scores, valid)`` on the card) at M = ``m``: each frame's picks
    up to the first step with a deciding IoU within PP_IOU_TOL of the
    threshold, and the kernel's IoU rows against the twin's matrix rows.
    Returns (per-case stats, the largest IoU error, the smallest deciding
    gap, the failures, the twin's clipped pairs and the kernel's
    ring-routine pairs per case)."""
    from lidar_object_detection_tpu_torch.ops import rotated_nms as rn
    from lidar_object_detection_tpu_torch.ops.rotated_iou import (
        rotated_iou_matrix)

    stats, max_err, min_gap, failed, pairs_of = {}, 0.0, np.inf, [], {}
    slow_of = {}
    for name, (bx, sc, va) in cases.items():
        idx, keep, rows, slow = rn.rotated_nms_cuda(bx, sc, va, thr, m,
                                                    iou_rows=True)
        ref_idx, ref_keep, pairs = rn.rotated_nms_plain(
            bx, sc, va, thr, m, return_pairs=True)
        torch.cuda.synchronize()
        pairs_of[name] = int(pairs.sum())
        slow_of[name] = int(slow.sum())
        idx_h, keep_h, rows_h = (t.cpu().numpy() for t in (idx, keep, rows))
        ref_idx_h, ref_keep_h = ref_idx.cpu().numpy(), ref_keep.cpu().numpy()
        gaps, close = replay_rotated_nms(rows_h, idx_h, keep_h,
                                         sc.cpu().numpy(), va.cpu().numpy(),
                                         thr)
        min_gap = min(min_gap, *gaps)
        bad, case_err = 0, 0.0
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
                case_err = max(case_err, float(
                    (rows[f, :steps] - iou[picks]).abs().max()))
        max_err = max(max_err, case_err)
        if bad:
            failed.append(f"{name}: {bad} slots")
        stats[name] = {"picks": keep_h.sum(axis=1).tolist(),
                       "min_gap": min(gaps), "close_step": close,
                       "max_abs_err": case_err}
    return stats, max_err, min_gap, failed, pairs_of, slow_of


def check_rotated_nms(torch, dev, rng, path):
    """The rotated-NMS kernel against its twin on the card: the SSD
    path's own candidates (``path``: each frame's 512 top boxes7, scores
    and validity from the card's heads, (4, 512, ...)), the same with
    every candidate valid, and seeded cases at B = 4, N = 512, M = 64
    (heavy overlap, all invalid, NaN scores, equal scores) and B = 64
    (degenerate boxes).  The kernel's IoU rows (each step's pick against
    every candidate) must agree with the twin's matrix rows within
    PP_IOU_TOL, and its picks with the twin's up to the first step with a
    deciding IoU within PP_IOU_TOL of the threshold (the smallest such gap
    is printed).  The degenerate case must send some pairs through the
    kernel's ring routine (counted by the kernel).  Timed at B = 1 on each
    path frame (the launch the decode makes per frame) and at B = 4 on the
    seeded overlap, also per step of the longest frame's chain of picks;
    the twin on the card beside it."""
    from lidar_object_detection_tpu_torch.ops import rotated_nms as rn

    thr, m = PP_IOU_THRESHOLD, PP_MAX_DETECTIONS
    on_card = lambda arrays: tuple(torch.from_numpy(a).to(dev)
                                   for a in arrays)
    boxes, scores, valid = path
    cases = {"SSD path B=4": path,
             "SSD path, all valid": (boxes, scores, torch.ones_like(valid))}
    cases.update({name: on_card(c)
                  for name, c in rotated_nms_cases(rng).items()})
    stats, max_err, min_gap, failed, pairs_of, slow_of = \
        compare_rotated_nms(torch, dev, cases, thr, m)
    print(f"rotated NMS cases: {stats}; pairs through the ring routine "
          f"{slow_of}", flush=True)
    if failed or max_err > PP_IOU_TOL:
        raise AssertionError(f"the rotated NMS differs from its twin: "
                             f"{failed}, IoU rows off by up to {max_err}")
    if sum(stats["SSD path, all valid"]["picks"]) == 0 \
            or sum(stats["heavy overlap"]["picks"]) < 8 \
            or sum(stats["all invalid"]["picks"]) != 0 \
            or slow_of["degenerate"] == 0:
        raise AssertionError(f"degenerate rotated NMS cases: {stats}, "
                             f"ring routine {slow_of}")

    entry = {"name": "rotated_nms", "route": "cuda",
             "source": "lidar_object_detection_tpu_torch/csrc/"
                       "rotated_nms.cu",
             "replaces": "lidar_object_detection_tpu/models/pointpillars/"
                         "decode.py:146",
             "max_abs_err": max_err, "min_gap": min_gap,
             "mismatches": 0, "cases": len(cases), "library_ms": None,
             "pairs": pairs_of, "ring_routine_pairs": slow_of}
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
    picks = keep.sum(dim=1).cpu().numpy()
    steps = int(np.minimum(picks + 1, m).sum())
    entry["bound_ms_b4"], _ = rotated_nms_bound(int(pairs.sum()), 4, 512, m,
                                                steps)
    # the frames run side by side: the chain is the longest frame's steps
    entry["chain_steps_b4"] = int(min(picks.max() + 1, m))
    entry["us_per_step_b4"] = entry["ms_b4"] * 1e3 / entry["chain_steps_b4"]
    one = tuple(t[:1].contiguous() for t in path)
    entry["plain_ms"] = time_gpu(lambda: rn.rotated_nms_plain(*one, thr, m),
                                 reps=5, warmup=1, head_start=False)
    print(f"rotated NMS: equal to the twin on {len(cases)} cases (IoU rows "
          f"within {max_err:.3g}, smallest deciding gap {min_gap:.3g}); "
          f"SSD path B=1 {entry['ms']:.4f} ms per frame ({per_frame}; bound "
          f"{entry['bound_ms']:.3g} by {entry['bound_by']}), seeded B=4 "
          f"{entry['ms_b4']:.4f} (bound {entry['bound_ms_b4']:.3g}; "
          f"{entry['us_per_step_b4']:.3f} us a step over "
          f"{entry['chain_steps_b4']}); twin {entry['plain_ms']:.3f} ms; "
          f"pairs {pairs_of}, through the ring routine {slow_of}", flush=True)
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


# ---------------------------------------------------------------------------
# PointPillars training
# ---------------------------------------------------------------------------

# the CLI runs' steps per head (4 frames a step, the street's 4 frames)
PP_TRAIN_STEPS = {"ssd": 8, "center": 4}
# the assigner's IoU thresholds (models/pointpillars/loss.py pos, neg)
PP_ASSIGN_THRESHOLDS = (0.6, 0.45)
# one full-width float32 step from the committed SSD variables, card
# against the CPU port: loss parts within PP_STEP_LOSS_RTOL relative, and
# every gradient tensor within PP_STEP_GRAD_TOL of its largest entry on
# the CPU.  The card's step agrees within 1.5e-4 of that; a point moved
# into the neighbouring pillar by a reciprocal division (the fault this
# check found) moved some tensor by 7.2e-2.  The gradients of a float32
# step are ill-conditioned: the pillar features subtract each pillar's
# mean from coordinates of up to 100 m, and train-mode BatchNorm over 17
# layers carries their rounding into the deepest block's gradients.  How
# far is printed beside the check, as the CPU's one-ulp spread: the CPU's
# step against the same step with every weight and every point coordinate
# one ulp up or down at random (3.1e-3 at the full-width step).  It is a
# larger change than the card's rounding and is not held to the limit
PP_STEP_LOSS_RTOL, PP_STEP_GRAD_TOL = 1e-3, 2e-3
# frames of that comparison (the CPU's part of the check's time)
PP_STEP_CPU_FRAMES = 2
# The center head's CLI run on the card against the same run on the CPU
# (the same trainer in this process: the seed-0 initial variables of this
# machine's torch, the same four augmented batches): each step's num_pos
# exactly and its loss within PP_CENTER_LOSS_RTOL relative.  Read on an
# H100 with these centres: 0 at step 0, then 1.0e-4, 6.5e-3 and 4.1e-3
# (card 25.9017 / 2700.8972 / 101.1329 / 27.6916, CPU 25.9017 / 2701.1750
# / 100.4828 / 27.5799): the card's float32 gradients differ from the
# CPU's by about 1.5e-4 of a tensor's largest entry (PP_STEP_GRAD_TOL's
# reading), and the first Adam steps from random weights overshoot (the
# loss jumps a hundredfold), which carries that into the later losses.
# The limit is three times the largest reading.  The
# run need not descend: JAX's own trainer from the card's initial
# variables on these batches rises too (25.9071 -> 2688.5771 -> 107.2106
# -> 26.4840); that the port's curve is JAX's is held on the CPU
# (tests/test_torch_pointpillars_train.py, test_training_step_matches_jax
# [center], _center_curve)
PP_CENTER_LOSS_RTOL = 2e-2


def nudge_one_ulp(torch, tensors, seed):
    """Move every entry of ``tensors`` one ulp up or down at random, in
    place."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in tensors:
            up = (torch.rand(p.shape, generator=gen) < 0.5).to(p.device)
            p.copy_(torch.where(up, torch.nextafter(p, p + 1),
                                torch.nextafter(p, p - 1)))


def training_step_grads(torch, cfg, state, batch, device, nudge=None,
                        dtype=None):
    """One training step's loss parts and gradients (Flax layout, on the
    host) from ``state`` on ``device``, the network computing in
    ``dtype`` (float32 by default); ``nudge`` a seed moves every weight
    and every point coordinate one ulp first (``nudge_one_ulp``)."""
    from lidar_object_detection_tpu_torch.models.pointpillars import (
        pillars_flax_from_state)
    from lidar_object_detection_tpu_torch.models.pointpillars import (
        train as ptrain)

    tr = ptrain.PillarsTrainer(cfg, device=device,
                               dtype=dtype or torch.float32)
    tr.model.load_state_dict(state)
    b = tr.batch_tensors(*batch)
    if nudge is not None:
        nudge_one_ulp(torch, [*tr.model.parameters(), b[0][..., :3]], nudge)
    parts = tr.loss(*b)
    grads = tr.gradients(parts["loss"])
    return ({key: float(v.detach()) for key, v in parts.items()},
            pillars_flax_from_state(grads)["params"])


def grad_spread(got, ref, skip=(), path=()):
    """The largest difference of two gradient trees, in units of each
    tensor's largest entry in ``ref``; the leaves whose "/"-joined paths
    are in ``skip`` are left out."""
    worst = 0.0
    for key, value in ref.items():
        where = (*path, key)
        if isinstance(value, dict):
            worst = max(worst, grad_spread(got[key], value, skip, where))
        elif "/".join(where) not in skip:
            scale = max(float(np.abs(value).max()), 1e-30)
            worst = max(worst, float(np.abs(got[key] - value).max()) / scale)
    return worst


def compare_steps(torch, cfg, state, batch, dev):
    """A training step on the card against the CPU's (``PP_STEP_*``):
    returns (card parts, CPU parts, loss parts' relative error, the
    card's gradient error, the CPU's one-ulp spread, a diagnostic)."""
    card_parts, card_grads = training_step_grads(torch, cfg, state, batch,
                                                 dev)
    cpu_parts, cpu_grads = training_step_grads(torch, cfg, state, batch,
                                               "cpu")
    spread = grad_spread(training_step_grads(
        torch, cfg, state, batch, "cpu", nudge=0)[1], cpu_grads)
    loss_err = max(abs(card_parts[key] - cpu_parts[key])
                   / max(abs(cpu_parts[key]), 1e-12)
                   for key in ("loss", "cls", "box", "dir"))
    return (card_parts, cpu_parts, loss_err,
            grad_spread(card_grads, cpu_grads), spread)


def steps_agree(card_parts, cpu_parts, loss_err, grad_err):
    return (card_parts["num_pos"] == cpu_parts["num_pos"]
            and loss_err <= PP_STEP_LOSS_RTOL
            and grad_err <= PP_STEP_GRAD_TOL)


@contextlib.contextmanager
def recorded_steps():
    """While open, every ``PillarsTrainer.train_step`` appends its (loss,
    num_pos) to the list it yields."""
    from lidar_object_detection_tpu_torch.models.pointpillars import (
        train as ptrain)

    steps = []
    original = ptrain.PillarsTrainer.train_step

    def train_step(self, *batch):
        metrics = original(self, *batch)
        steps.append((float(metrics["loss"]), float(metrics["num_pos"])))
        return metrics

    ptrain.PillarsTrainer.train_step = train_step
    try:
        yield steps
    finally:
        ptrain.PillarsTrainer.train_step = original


def curves_agree(card, cpu):
    """The largest relative loss difference of two runs' (loss, num_pos)
    steps, or None where their lengths or a num_pos differ."""
    if len(card) != len(cpu) or any(a[1] != b[1]
                                    for a, b in zip(card, cpu)):
        return None
    return max(abs(a[0] - b[0]) / max(abs(b[0]), 1e-12)
               for a, b in zip(card, cpu))


def train_cli_losses(text):
    """(step 0's loss, the final loss, eval matched, eval GTs) of a
    ``pointpillars-train`` run's output."""
    first = re.search(r"step 0: loss=(\S+) ", text)
    final = re.search(r"final loss: (\S+); eval recall=(\d+)/(\d+)", text)
    if not first or not final:
        raise AssertionError(f"pointpillars-train printed {text!r}")
    return (float(first[1]), float(final[1]), int(final[2]),
            int(final[3]))


def pointpillars_train_phase(torch, dev, smi, tmp):
    """PointPillars training on the card at the surround grid (640 x 640
    pillars, full width, P = 131072 points a frame, 4 frames a step), on
    ``pillars_tree``'s street:

    * the CLI ``pointpillars-train --surround --aggregate-sweeps
      --max-points 131072 --checkpoint-dir`` with ``--head ssd``
      (PP_TRAIN_STEPS, the assigner's IoU kernel once a step, the closing
      evaluation's rotated NMS once a frame) and ``--head center`` (no
      kernel), each run twice, counters zeroed before each: the two
      checkpoints and sidecars byte-equal; finite losses and a recall
      total; the SSD run's final loss below step 0's; the center run held
      step by step to the same run on the CPU (num_pos exact, losses
      within PP_CENTER_LOSS_RTOL);
    * ``pointpillars-infer --ckpt`` on each written checkpoint;
    * one full-width step from the committed SSD variables on the card
      and on the CPU (PP_STEP_CPU_FRAMES frames): num_pos exact, loss
      parts within PP_STEP_LOSS_RTOL, gradients within PP_STEP_GRAD_TOL
      (``compare_steps``);
    * CUDA-event times of the step at B = 4, split into the assignment,
      the train-mode forward (as the step runs it, and under cuDNN's
      deterministic flag, as the backward runs), the eval-mode forward,
      forward + loss, backward and the optimizer; a traced step and a
      traced train-mode forward.

    Returns the runs' launches, a summary, the step's real candidate
    pairs on the card (anchors, top-k indices, GTs, GT validity), and the
    step's batch of 4 frames (numpy)."""
    from lidar_object_detection_tpu_torch.data import Kitti360Dataset
    from lidar_object_detection_tpu_torch.models.common import repeatable
    from lidar_object_detection_tpu_torch.models.pointpillars import (
        PillarsConfig, pillars_state_from_flax)
    from lidar_object_detection_tpu_torch.models.pointpillars import (
        train as ptrain)
    from lidar_object_detection_tpu_torch.models.pointpillars.loss import (
        assign_anchors, iou_bound, top_candidates)
    from lidar_object_detection_tpu_torch.ops import kernel_lib
    from lidar_object_detection_tpu_torch.pipelines import pointpillars as pp
    from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
        read_flax_msgpack)

    t0 = time.perf_counter()
    root = os.path.join(tmp, "pp_train_kitti360")
    n_cars = pillars_tree(root, np.random.default_rng(2))
    n = len(PP_FRAMES)
    base = ["pointpillars-train", "--dataset", root, "--surround",
            "--aggregate-sweeps", "--max-points", str(P), "--device",
            str(dev)]
    zero = {k: 0 for k in kernel_lib.LAUNCHES}
    launches, walls, losses, ckpts, repeated = {}, {}, {}, {}, {}
    curves = {}
    for head, steps in PP_TRAIN_STEPS.items():
        want = (dict(zero, rotated_iou_pairs=steps, rotated_nms=n)
                if head == "ssd" else zero)
        for run in ("", "_again"):
            out = os.path.join(tmp, f"pp_train_{head}{run}")
            torch.cuda.synchronize()
            kernel_lib.reset_launches()
            t = time.perf_counter()
            with recorded_steps() as curves[head + run]:
                text = run_cli(base + ["--head", head, "--steps",
                                       str(steps), "--checkpoint-dir", out])
            torch.cuda.synchronize()
            walls[head + run] = time.perf_counter() - t
            launches[head + run] = dict(kernel_lib.LAUNCHES)
            if launches[head + run] != want:
                raise AssertionError(f"pointpillars-train {head}{run} "
                                     f"launched {launches[head + run]}, "
                                     f"expected {want}")
            first, final, matched, total = train_cli_losses(text)
            if not (np.isfinite(first) and np.isfinite(final)) \
                    or (head == "ssd" and final >= first) or total == 0:
                raise AssertionError(f"pointpillars-train {head}{run}: "
                                     f"loss {first} -> {final}, recall "
                                     f"{matched}/{total}")
            losses[head + run] = {"step0": first, "final": final,
                                  "recall": [matched, total]}
            ckpts[head + run] = os.path.join(
                out, f"pp_{head}_step{steps}.msgpack")
        repeated[head] = same_files(os.path.dirname(ckpts[head + "_again"]),
                                    os.path.dirname(ckpts[head]),
                                    f"the {head} training run's second run")
    print(f"pointpillars-train: the second run of each head wrote the "
          f"first run's checkpoint bytes ({repeated}); losses {losses}; "
          f"wall s {walls}", flush=True)
    # the center run on the CPU, the card's run held to it step by step
    t = time.perf_counter()
    with recorded_steps() as curves["center_cpu"]:
        run_cli(base[:-1] + ["cpu", "--head", "center", "--steps",
                             str(PP_TRAIN_STEPS["center"]),
                             "--checkpoint-dir",
                             os.path.join(tmp, "pp_train_center_cpu")])
    walls["center_cpu"] = time.perf_counter() - t
    center_err = curves_agree(curves["center"], curves["center_cpu"])
    print(f"pointpillars-train --head center, (loss, num_pos) a step: card "
          f"{curves['center']}, CPU {curves['center_cpu']}; losses within "
          f"{center_err} relative (limit {PP_CENTER_LOSS_RTOL}; "
          f"{walls['center_cpu']:.1f} s on the CPU)", flush=True)
    if center_err is None or center_err > PP_CENTER_LOSS_RTOL:
        raise AssertionError(f"the center head's run on the card differs "
                             f"from the CPU's: {curves['center']} against "
                             f"{curves['center_cpu']}")
    infer = {}
    for head in PP_TRAIN_STEPS:
        out = os.path.join(tmp, f"pp_train_infer_{head}")
        text = run_cli(["pointpillars-infer", "--dataset", root, "--ckpt",
                        ckpts[head], "--surround", "--aggregate-sweeps",
                        "--head", head, "--score-threshold", "0.1",
                        "--output", out, "--device", str(dev)])
        line = re.search(r"(\d+) frames, (\d+) detections", text)
        if not line or int(line[1]) != n:
            raise AssertionError(f"pointpillars-infer on the trained {head} "
                                 f"checkpoint printed {text!r}")
        infer[head] = int(line[2])
    phase("PointPillars training: the CLI on the card", t0)

    # one full-width step from the committed SSD variables, card and CPU
    cfg = dataclasses.replace(PillarsConfig.kitti360_surround(), head="ssd")
    ds = Kitti360Dataset(root)
    frames = pp.load_aggregated_frames(ds, PP_FRAMES, grid=cfg.grid,
                                       max_points=P)
    batch = pp.pack_frames(frames, P)
    state = pillars_state_from_flax(read_flax_msgpack(PP_CKPTS["ssd"])["0"])
    k = PP_STEP_CPU_FRAMES
    t = time.perf_counter()
    card_parts, cpu_parts, loss_err, grad_err, spread = compare_steps(
        torch, cfg, state, tuple(a[:k] for a in batch), dev)
    cpu_s = time.perf_counter() - t
    print(f"one full-width step, {k} frames, from the committed SSD "
          f"variables: card {card_parts}, CPU {cpu_parts}; loss parts "
          f"within {loss_err:.3g} relative, gradients within {grad_err:.3g} "
          f"of each tensor's largest, the CPU's one-ulp spread {spread:.3g} "
          f"({cpu_s:.1f} s)", flush=True)
    if not steps_agree(card_parts, cpu_parts, loss_err, grad_err):
        raise AssertionError(f"the card's training step differs from the "
                             f"CPU's: loss parts {loss_err}, gradients "
                             f"{grad_err} (limit {PP_STEP_GRAD_TOL})")

    # times of the step at B = 4 on the card, and a traced step
    tr = ptrain.PillarsTrainer(cfg, device=dev)
    tr.model.load_state_dict(state)
    b = tr.batch_tensors(*batch)
    kernel_lib.reset_launches()
    tr.train_step(*b)
    if kernel_lib.LAUNCHES != dict(zero, rotated_iou_pairs=1):
        raise AssertionError(f"a training step launched {kernel_lib.LAUNCHES}")
    anchors, gt, gv = tr.anchors, b[2], b[4]

    def forward():
        return tr.model(b[0], b[1], train=True)

    def forward_deterministic():
        with repeatable():
            return forward()

    times = {
        "step_ms": time_events(torch, lambda: tr.train_step(*b), 5)[0],
        "assign_ms": time_events(torch, lambda: assign_anchors(
            gt, gv, cfg, anchors), 5)[0],
        "forward_ms": time_events(torch, forward, 5)[0],
        "forward_deterministic_ms": time_events(
            torch, forward_deterministic, 5)[0],
        "forward_eval_ms": time_events(torch, lambda: tr.apply(b[0], b[1]),
                                       5)[0],
        "forward_loss_ms": time_events(torch, lambda: tr.loss(*b), 5)[0],
        "forward_loss_backward_ms": time_events(
            torch, lambda: tr.gradients(tr.loss(*b)["loss"]), 5)[0],
    }
    grads = tr.gradients(tr.loss(*b)["loss"])
    times["optimizer_ms"] = time_events(torch, lambda: ptrain.adamw_update(
        tr.state.params(), grads, tr.state.opt_state, 2e-3, 1e-4), 5)[0]
    times["backward_ms"] = (times["forward_loss_backward_ms"]
                            - times["forward_loss_ms"])
    times["loss_ms"] = times["forward_loss_ms"] - times["forward_ms"]
    print(f"training step at B = {len(batch[0])}, full width, on {smi}: "
          f"{json.dumps(times)}", flush=True)
    print("traced training step (B = 4):", flush=True)
    profile_once(torch, lambda: tr.train_step(*b))
    print("traced train-mode forward (B = 4):", flush=True)
    profile_once(torch, forward)
    idx = top_candidates(iou_bound(anchors, gt))
    summary = {"cars in the street": n_cars, "cli_wall_s": walls,
               "losses": losses, "checkpoints_equal": repeated,
               "center_curves": {k: curves[k] for k in ("center",
                                                        "center_cpu")},
               "center_loss_rel_err": center_err,
               "infer_detections": infer, "step_loss_rel_err": loss_err,
               "step_grad_err": grad_err, "step_grad_spread": spread,
               "compare_s": cpu_s,
               "card_step_parts": card_parts, **times}
    print(json.dumps({"pointpillars_train": summary}), flush=True)
    phase("PointPillars training", t0)
    return launches, summary, (anchors, idx, gt, gv), batch


# ---------------------------------------------------------------------------
# YOLO11-seg training and the distillation runner
# ---------------------------------------------------------------------------

# one full-width float32 n step at B = 4 from the committed variables, card
# against the CPU port: loss parts within YOLO_STEP_LOSS_RTOL relative, and
# every gradient tensor within YOLO_STEP_GRAD_TOL of its largest entry on
# the CPU, but YOLO_ZERO_GRAD_LEAVES.  The limits are PointPillars'
# (PP_STEP_*): the port on the CPU agrees with JAX's step within 2.3e-4 of
# each tensor's largest (tests/test_torch_yolo_train.py).  The CPU's
# one-ulp spread (every weight and every input pixel moved one ulp) is
# printed beside them and gates nothing
YOLO_STEP_LOSS_RTOL, YOLO_STEP_GRAD_TOL = PP_STEP_LOSS_RTOL, PP_STEP_GRAD_TOL
# The biases of three BatchNorms of layer 10 (C2PSA: the attention's
# positional and output convolutions, the feed-forward's second) that no
# activation follows: a constant shift of their output reaches the loss
# only through 1x1 convolutions into a train-mode BatchNorm, which takes
# it out again, so their gradients are 0 but for rounding (2e-9 to 5e-9
# of the step's largest gradient; the smallest other gradient that is not
# 0 is 4e-6 of it, tests/test_torch_yolo_train.py's step).  Each is held
# to YOLO_ZERO_GRAD_SHARE of the step's largest gradient on both sides,
# not to its own largest entry
YOLO_ZERO_GRAD_LEAVES = ("layer10/m0/attn/pe/bn/bias",
                         "layer10/m0/attn/proj/bn/bias",
                         "layer10/m0/ffn1/bn/bias")
YOLO_ZERO_GRAD_SHARE = 1e-7
YOLO_TRAIN_STEPS = 8


def yolo_train_tree(torch, dev, root):
    """A KITTI-360 tree of the two committed frames and their mirrors
    (frames 300-303), each scan built around the committed n float32
    detector's detections of its frame on the card (``make_scene``:
    65536 points and 24 box slots a frame).  Returns the frames' cars."""
    from lidar_object_detection_tpu_torch.models.yolo.serving import (
        load_serving_checkpoint)
    from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

    real = [read_png_rgb(path) for path in FRAMES]
    images = np.ascontiguousarray(np.stack(real + [im[:, ::-1]
                                                   for im in real]))
    det = load_serving_checkpoint(CKPT, (H0, W0), tta="none",
                                  device=dev)[0]
    first = det.detect(images)
    rng = np.random.default_rng(14)
    frames, cars = [], 0
    for b in range(len(images)):
        valid = first["det_valid"][b].cpu().numpy()
        points, pvalid, corners, bvalid = make_scene(
            rng, first["boxes"][b].float().cpu().numpy(), valid,
            num_points=65536, num_boxes=24, num_valid=16)
        image = FRAMES[b] if b < len(FRAMES) else images[b]
        frames.append((300 + b, image, points[pvalid], corners[bvalid]))
        cars += int(valid.sum())
    write_kitti360_tree(root, frames)
    return cars


def yolo_step_grads(torch, variables, images, targets, device, nudge=None,
                    dtype=None):
    """One n training step's loss parts and gradients (Flax layout, on the
    host) from ``variables`` on ``device``, the network computing in
    ``dtype`` (float32 by default); ``nudge`` a seed moves every weight
    and every input pixel one ulp first (``nudge_one_ulp``)."""
    from lidar_object_detection_tpu_torch.models.yolo.model import (
        YoloConfig)
    from lidar_object_detection_tpu_torch.models.yolo.weights import (
        yolo_flax_from_state)
    from lidar_object_detection_tpu_torch.parallel.train import YoloTrainer

    tr = YoloTrainer(YoloConfig(scale="n"), device=device,
                     dtype=dtype or torch.float32)
    tr.load(variables)
    imgs, tg = tr.put(images, targets)
    if nudge is not None:
        nudge_one_ulp(torch, [*tr.model.parameters(), imgs], nudge)
    loss, parts = tr.loss(imgs, tg)
    grads = tr.gradients(loss)
    return ({"loss": float(loss.detach()),
             **{k: float(v.detach()) for k, v in parts.items()}},
            yolo_flax_from_state(grads)["params"])


def largest(tree):
    return max(largest(v) if isinstance(v, dict) else float(np.abs(v).max())
               for v in tree.values())


def zero_grad_share(grads):
    """The largest entry of the YOLO_ZERO_GRAD_LEAVES of a gradient tree,
    in units of the tree's largest entry."""
    def leaf(path):
        tree = grads
        for key in path.split("/"):
            tree = tree[key]
        return float(np.abs(tree).max())
    return max(map(leaf, YOLO_ZERO_GRAD_LEAVES)) / largest(grads)


def check_yolo_grads(card, cpu):
    """The card's gradient tree against the CPU's: returns (the worst
    error in units of each tensor's largest, the YOLO_ZERO_GRAD_LEAVES'
    shares on the card and on the CPU); raises past the limits."""
    err = grad_spread(card, cpu, YOLO_ZERO_GRAD_LEAVES)
    zero = zero_grad_share(card), zero_grad_share(cpu)
    if err > YOLO_STEP_GRAD_TOL or max(zero) > YOLO_ZERO_GRAD_SHARE:
        raise AssertionError(
            f"the card's YOLO gradients differ from the CPU's by {err} "
            f"(limit {YOLO_STEP_GRAD_TOL}); the leaves that are 0 but for "
            f"rounding at {zero} of the largest gradient (limit "
            f"{YOLO_ZERO_GRAD_SHARE})")
    return err, zero


def eval_counts(text):
    """(TP, FP, FN) and the JSON line of an evaluation's output."""
    line = json.loads(text.strip().splitlines()[-1])
    return (line["detections_tp"], line["fp"], line["fn"]), line


def run_distill(argv):
    """The distillation runner's ``main`` through ``run_cli``."""
    from lidar_object_detection_tpu_torch.pipelines import yolo_distill

    return run_cli(argv, yolo_distill.main)


def yolo_train_phase(torch, dev, smi, tmp):
    """YOLO11-seg training and the distillation runner on the card, on
    ``yolo_train_tree``'s 4 frames at 376 x 1408 (192 x 640 letterboxed,
    YOLO11n-seg at full width, 80 classes, MAX_T = 32):

    * the labels built on the card (its point-in-box tests) equal the
      CPU's, array by array;
    * one training step launches no kernel;
    * one step from the committed n variables on the card against the
      CPU's (YOLO_STEP_*, YOLO_ZERO_GRAD_*: ``check_yolo_grads``; the
      CPU's one-ulp spread printed beside);
    * the runner's ``main`` twice at ``--steps 8 --ema-decay 0.9``,
      counters zeroed before each: byte-equal ``.msgpack``, ``.opt`` and
      ``.json`` files; its closing evaluation launches K5 and K2 once
      each and nothing else;
    * ``--eval-only`` on the card and with ``--device cpu``, on the
      trained checkpoint and on a checkpoint of the committed n
      variables: the same TP, FP and FN;
    * CUDA-event times of the n step at B = 4, split into the train-mode
      forward, the loss (on one forward's outputs), the backward (of one
      loss, its graph kept), AdamW and the EMA; the committed x
      variables' step at B = 4 (the card only); a traced n step.

    Returns the launches of a step and of the runner's first run, a
    summary, and the step's batch (images on the card, targets numpy)
    with the CPU's float32 step on it (loss parts, gradient tree)."""
    from lidar_object_detection_tpu_torch.models.yolo.model import (
        YoloConfig)
    from lidar_object_detection_tpu_torch.ops import kernel_lib
    from lidar_object_detection_tpu_torch.parallel import optim
    from lidar_object_detection_tpu_torch.parallel.train import YoloTrainer
    from lidar_object_detection_tpu_torch.pipelines import yolo_distill as yd
    from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
        read_flax_msgpack)

    t0 = time.perf_counter()
    root = os.path.join(tmp, "yolo_kitti360")
    cars = yolo_train_tree(torch, dev, root)
    cache = os.path.join(tmp, "labels.npz")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t = time.perf_counter()
        labels = yd.build_labels(root, cache=cache, device=dev)
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        ref = yd.build_labels(root, device="cpu")
        cpu_s = time.perf_counter() - t
    for key, value in ref.items():
        if labels[key].dtype != value.dtype \
                or not np.array_equal(labels[key], value):
            raise AssertionError(f"the card's labels differ from the CPU's "
                                 f"in {key}")
    n_targets = int(labels["valid"].sum())
    if n_targets < 4:
        raise AssertionError(f"the tree gave {n_targets} targets")
    print(f"labels: {n_targets} targets over {len(labels['images'])} frames "
          f"({cars} detections behind the scans), equal on the card and "
          f"the CPU ({card_s:.2f} s and {cpu_s:.2f} s)", flush=True)
    phase("YOLO training: labels", t0)

    # the step's operands: every frame, letterboxed on the device
    n_vars = read_flax_msgpack(CKPT)["variables"]
    targets = {"boxes": labels["boxes_lb"], "classes": labels["classes"],
               "valid": labels["valid"], "masks": labels["masks_pr"]}
    images = yd.letterboxed(labels["images"], dev)
    zero = {k: 0 for k in kernel_lib.LAUNCHES}
    tr = YoloTrainer(YoloConfig(scale="n"), device=dev, ema_decay=0.9)
    tr.load(n_vars)
    b_imgs, b_tg = tr.put(images, targets)
    kernel_lib.reset_launches()
    tr.train_step(b_imgs, b_tg)
    torch.cuda.synchronize()
    step_launches = dict(kernel_lib.LAUNCHES)
    if step_launches != zero:
        raise AssertionError(f"a training step launched {step_launches}")

    # card against the CPU, from the committed n variables
    t = time.perf_counter()
    cpu_images = images.cpu()
    card_parts, card_grads = yolo_step_grads(torch, n_vars, images, targets,
                                             dev)
    cpu_parts, cpu_grads = yolo_step_grads(torch, n_vars, cpu_images,
                                           targets, "cpu")
    spread = grad_spread(yolo_step_grads(torch, n_vars, cpu_images, targets,
                                         "cpu", nudge=0)[1], cpu_grads,
                         YOLO_ZERO_GRAD_LEAVES)
    loss_err = max(abs(card_parts[k] - cpu_parts[k])
                   / max(abs(cpu_parts[k]), 1e-12) for k in cpu_parts)
    compare_s = time.perf_counter() - t
    print(f"one n step at B = {len(images)} from the committed variables: "
          f"card {card_parts}, CPU {cpu_parts}; loss parts within "
          f"{loss_err:.3g} relative (limit {YOLO_STEP_LOSS_RTOL})",
          flush=True)
    if loss_err > YOLO_STEP_LOSS_RTOL:
        raise AssertionError(f"the card's YOLO step differs from the CPU's: "
                             f"loss parts {loss_err}")
    grad_err, zero_share = check_yolo_grads(card_grads, cpu_grads)
    print(f"gradients within {grad_err:.3g} of each tensor's largest (limit "
          f"{YOLO_STEP_GRAD_TOL}; the CPU's one-ulp spread {spread:.3g}), "
          f"the {len(YOLO_ZERO_GRAD_LEAVES)} leaves that are 0 but for "
          f"rounding at {zero_share[0]:.3g} (card) and "
          f"{zero_share[1]:.3g} (CPU) of the largest gradient "
          f"{largest(cpu_grads):.4g} (limit "
          f"{YOLO_ZERO_GRAD_SHARE}) ({compare_s:.1f} s)", flush=True)
    phase("YOLO training: card step against the CPU", t0)

    # the runner twice, byte-equal files; its evaluation's kernels
    runs, walls, run_launches = [], {}, {}
    want = dict(zero, nms=1, mask_assemble=1)
    for run in ("first", "again"):
        ckpt = os.path.join(tmp, f"yolo_{run}.msgpack")
        torch.cuda.synchronize()
        kernel_lib.reset_launches()
        t = time.perf_counter()
        text = run_distill(["--dataset", root, "--cache", cache, "--ckpt",
                            ckpt, "--steps", str(YOLO_TRAIN_STEPS),
                            "--ema-decay", "0.9", "--device", str(dev)])
        torch.cuda.synchronize()
        walls[run] = time.perf_counter() - t
        run_launches[run] = dict(kernel_lib.LAUNCHES)
        if run_launches[run] != want:
            raise AssertionError(f"the runner's {run} run launched "
                                 f"{run_launches[run]}, expected {want}")
        losses = [float(m) for m in re.findall(r" loss (\S+) ", text)]
        if not losses or not all(np.isfinite(losses)):
            raise AssertionError(f"the runner printed losses {losses}")
        runs.append(ckpt)
    for suffix in ("", ".opt", ".json"):
        if read_bytes(runs[0] + suffix) != read_bytes(runs[1] + suffix):
            raise AssertionError(f"two runs wrote different "
                                 f"{suffix or '.msgpack'} files")
    print(f"yolo_distill: two runs of {YOLO_TRAIN_STEPS} steps wrote the "
          f"same .msgpack, .opt and .json bytes; losses {losses}; wall s "
          f"{walls}", flush=True)

    # --eval-only on the card and the CPU, trained and committed weights
    committed = os.path.join(tmp, "yolo_committed.msgpack")
    yd.save_ckpt(committed, n_vars, tr.opt_state_dict(), 12000)
    evals = {}
    for name, ckpt in (("trained", runs[0]), ("committed", committed)):
        got = {}
        for device in (str(dev), "cpu"):
            got[device] = eval_counts(run_distill(
                ["--dataset", root, "--cache", cache, "--ckpt", ckpt,
                 "--eval-only", "--device", device]))
        if got[str(dev)][0] != got["cpu"][0]:
            raise AssertionError(f"--eval-only of the {name} checkpoint: "
                                 f"card {got[str(dev)][1]}, CPU "
                                 f"{got['cpu'][1]}")
        evals[name] = got[str(dev)][1]
    if evals["committed"]["detections_tp"] == 0:
        raise AssertionError(f"the committed n checkpoint matched no label: "
                             f"{evals['committed']}")
    phase("YOLO training: the runner", t0)

    # times of the n step at B = 4, and of the x step
    del tr
    tr = YoloTrainer(YoloConfig(scale="n"), device=dev, ema_decay=0.9,
                     learning_rate=optim.warmup_cosine_decay_schedule(
                         0.0, 2e-3, 1, 8, 2e-5))
    tr.load(n_vars)
    times = yolo_step_times(torch, tr, b_imgs, b_tg)
    print(f"YOLO11n-seg training step at B = {len(images)}, 192 x 640, on "
          f"{smi}: {json.dumps(times)}", flush=True)
    print("traced n training step (B = 4):", flush=True)
    profile_once(torch, lambda: tr.train_step(b_imgs, b_tg))
    del tr
    x_tr = YoloTrainer(YoloConfig(scale="x"), device=dev)
    x_tr.load(read_flax_msgpack(CKPT_X)["variables"])
    times["x_step_ms"], m = time_events(
        torch, lambda: x_tr.train_step(b_imgs, b_tg), 3)
    if not np.isfinite(float(m["loss"])):
        raise AssertionError(f"the x step's loss is {m['loss']}")
    print(f"YOLO11x-seg training step at B = {len(images)}, 192 x 640, on "
          f"{smi}: {times['x_step_ms']:.3f} ms", flush=True)
    del x_tr
    torch.cuda.empty_cache()
    summary = {"targets": n_targets, "labels_card_s": card_s,
               "labels_cpu_s": cpu_s, "step_loss_rel_err": loss_err,
               "step_grad_err": grad_err, "step_grad_spread": spread,
               "step_zero_grad_share": {"card": zero_share[0],
                                        "cpu": zero_share[1]},
               "card_step_parts": card_parts, "runner_wall_s": walls,
               "evaluations": evals, **times}
    print(json.dumps({"yolo_train": summary}), flush=True)
    phase("YOLO training", t0)
    return ({"step": step_launches, "runner": run_launches["first"]},
            summary, (images, targets, (cpu_parts, cpu_grads)))


def yolo_step_times(torch, tr, images, targets, iters=10):
    """CUDA-event ms of a ``YoloTrainer``'s step on a batch (``put``'s)
    and of its parts, each in the trainer's numerics: the train-mode
    forward, the loss on one forward's outputs, the backward of one loss
    (its graph kept, so that each call runs the same backward), AdamW and
    the EMA.  The trainer trains on while it is timed."""
    from lidar_object_detection_tpu_torch.models.common import (
        numerics, repeatable)
    from lidar_object_detection_tpu_torch.parallel import optim
    from lidar_object_detection_tpu_torch.parallel.train import (
        detection_loss)

    def forward():
        tr.model.train()
        with numerics(tr.dtype):
            return tr.model(images)

    def loss_of(out):
        with numerics(tr.dtype):
            return detection_loss(out, targets, tr.cfg.num_classes,
                                  tr.level_shapes)[0]

    params = list(tr.state.params().values())

    def backward(loss):
        with numerics(tr.dtype), repeatable():
            return torch.autograd.grad(loss, params, retain_graph=True)

    times = {"step_ms": time_events(
        torch, lambda: tr.train_step(images, targets), iters)[0]}
    times["forward_ms"], out = time_events(torch, forward, iters)
    times["loss_ms"], loss = time_events(torch, lambda: loss_of(out), iters)
    times["backward_ms"], grads = time_events(torch, lambda: backward(loss),
                                              iters)
    grads = dict(zip(tr.state.params(), grads))
    times["adamw_ms"] = time_events(torch, lambda: optim.adamw_update(
        tr.state.params(), grads, tr.state.opt_state, 2e-3, 5e-4), iters)[0]
    times["ema_ms"] = time_events(torch, tr.update_ema, iters)[0]
    return times


# ---------------------------------------------------------------------------
# bfloat16 mixed-precision training (Flax's dtype: float32 master weights)
# ---------------------------------------------------------------------------

# A bfloat16 step on the card against the same step on the CPU: the sum of
# the loss parts' absolute differences, and the median tensor's gradient
# deviation (relative to the tensor's largest entry), each within
# BF16_STEP_MULTIPLE of the CPU's bfloat16 drift from its float32 step.
# It is the CPU tests' STEP_MULTIPLE (tests/test_torch_*_train_bf16.py:
# the port's bfloat16 step against JAX's): two bfloat16 steps that sum in
# other orders differ by about as much as either differs from float32,
# the YOLO step's discrete choices (TAL's top-k, the mask loss's
# instances) following the rounding
BF16_STEP_MULTIPLE = 1.5
# steps of each repeated run (byte-equal twice), pairs of alternated
# float32 / bfloat16 timings, and CUDA-event calls a timing
BF16_STEPS, BF16_TIME_PAIRS, BF16_TIME_ITERS = 8, 3, 2
# frames of the PointPillars card-against-CPU checks (the CPU's share of
# the phase's time: a bfloat16 step at the surround grid took 9 s a frame
# on the CPU of the machine that holds the H100)
PP_BF16_CPU_FRAMES = 1
# the center head's bfloat16 steps from the committed center variables,
# card against CPU, on the surround grid's central 320 x 320 pillars
# (+-51.2 m; the CPU's four steps at the whole grid took 36 s): each
# step's loss within PP_BF16_CENTER_RTOL relative.  Read on an H100
# (700 W): 1.9e-3 on this grid, 4.7e-3 on the whole grid; the limit is
# the float32 run's (PP_CENTER_LOSS_RTOL), half of JAX's own bfloat16
# drift from float32 at step 2 of the CPU test's center run (4.9e-2)
PP_BF16_CENTER_STEPS = 4
PP_BF16_CENTER_RANGE = 51.2
PP_BF16_CENTER_RTOL = PP_CENTER_LOSS_RTOL


def median_grad_deviation(got, ref):
    """The median over the tensors of two gradient trees of each
    tensor's largest difference in units of its largest entry in ``ref``
    (tensors whose largest entry is 0 left out)."""
    got, ref = flat_tree(got), flat_tree(ref)
    out = [float(np.abs(got[k].astype(np.float64) - r).max())
           / float(np.abs(r).max()) for k, r in ref.items()
           if np.abs(r).max() > 0]
    return float(np.median(out))


def bf16_agreement(card, cpu, cpu_f32, parts, what):
    """A bfloat16 step on the card against the CPU's (each a (loss parts,
    gradient tree) pair), in units of the CPU's bfloat16 drift from its
    float32 step (BF16_STEP_MULTIPLE); raises past the limit."""
    summed = lambda a, b: sum(abs(a[0][k] - b[0][k]) for k in parts)
    out = {"parts_err": summed(card, cpu), "parts_drift": summed(cpu,
                                                                 cpu_f32),
           "grad_err": median_grad_deviation(card[1], cpu[1]),
           "grad_drift": median_grad_deviation(cpu[1], cpu_f32[1])}
    print(f"{what}: card bf16 {card[0]}, CPU bf16 {cpu[0]}, CPU float32 "
          f"{cpu_f32[0]}; loss parts' summed difference {out['parts_err']:.4g}"
          f" against the CPU's bfloat16 drift {out['parts_drift']:.4g}; the "
          f"median tensor's gradient deviation {out['grad_err']:.4g} against "
          f"{out['grad_drift']:.4g} (limit {BF16_STEP_MULTIPLE} x the "
          f"drift)", flush=True)
    if out["parts_err"] > BF16_STEP_MULTIPLE * out["parts_drift"] \
            or out["grad_err"] > BF16_STEP_MULTIPLE * out["grad_drift"]:
        raise AssertionError(f"{what}: the card's bfloat16 step differs from "
                             f"the CPU's: {out}")
    return out


def float32_tree(torch, tree):
    """A variables tree with every leaf float32 numpy (bfloat16 leaves,
    tensors in ``read_flax_msgpack``'s trees, cast up)."""
    return {k: float32_tree(torch, v) if isinstance(v, dict) else
            (v.float().numpy() if torch.is_tensor(v)
             else np.asarray(v, np.float32)) for k, v in tree.items()}


def repeated_runs(torch, make, step, state_of, what):
    """BF16_STEPS steps of ``step(trainer)`` from a fresh ``make()``, run
    twice, the launch counters zeroed before each: the two final states
    (``state_of(trainer)``, a tree) must hold the same bytes.  Returns
    (launches of the first run, its last metrics)."""
    from lidar_object_detection_tpu_torch.ops import kernel_lib

    states, launches, metrics = [], [], None
    for _ in range(2):
        tr = make()
        torch.cuda.synchronize()
        kernel_lib.reset_launches()
        for _ in range(BF16_STEPS):
            metrics = step(tr)
        torch.cuda.synchronize()
        launches.append(dict(kernel_lib.LAUNCHES))
        states.append(flat_tree(state_of(tr)))
        del tr
    same = states[0].keys() == states[1].keys() and all(
        states[0][k].tobytes() == states[1][k].tobytes() for k in states[0])
    if not same or launches[0] != launches[1]:
        raise AssertionError(f"{what}: two runs of {BF16_STEPS} steps "
                             f"differ (launches {launches})")
    return launches[0], {k: float(v) for k, v in metrics.items()
                         if k != "step"}


def alternated(torch, arms, time_arm):
    """``time_arm(arm)`` for each arm of ``arms`` (name -> arm) in
    BF16_TIME_PAIRS rounds, the order reversed every other round (a b,
    b a, a b): name -> list of results."""
    names = list(arms)
    out = {name: [] for name in names}
    for i in range(BF16_TIME_PAIRS):
        for name in (names if i % 2 == 0 else names[::-1]):
            out[name].append(time_arm(arms[name]))
    return out


def bf16_train_phase(torch, dev, smi, yolo_batch, pp_batch):
    """bfloat16 mixed-precision training on the card (``YoloTrainer`` and
    ``PillarsTrainer`` with ``dtype=torch.bfloat16``: float32 parameters,
    gradients, moments and EMA, the networks computing in bfloat16):

    * YOLO11n-seg on the YOLO phase's batch (B = 4, 192 x 640, EMA 0.9)
      from the committed n variables: the card's step 1 against the
      CPU's (``bf16_agreement``; the CPU's float32 step is the YOLO
      phase's, ``yolo_batch``'s third item); BF16_STEPS steps twice, byte-equal
      (variables, EMA, AdamW's state), no kernel launched; CUDA-event step
      times of float32 and bfloat16 alternated, split into forward, loss,
      backward, AdamW and EMA; a traced bfloat16 step (kernels, busy
      share);
    * YOLO11x-seg from the committed x variables cast to float32 masters:
      step times of float32 and bfloat16 alternated;
    * PointPillars SSD at the surround grid on the PointPillars phase's
      batch (B = 4): the card's step 1 against the CPU's
      (PP_BF16_CPU_FRAMES frames); BF16_STEPS steps twice, byte-equal,
      ``rotated_iou_pairs`` once a step; the kernel against its twin on
      the bfloat16 step's candidate pairs; step times alternated and a
      traced step;
    * PointPillars center from the committed center variables:
      PP_BF16_CENTER_STEPS steps on the card and on the CPU
      (PP_BF16_CPU_FRAMES frames, the grid's central +-PP_BF16_CENTER_RANGE
      m), num_pos exact, each loss within PP_BF16_CENTER_RTOL relative.

    Returns the kernels' launches per run and a summary."""
    from lidar_object_detection_tpu_torch.models.pointpillars import (
        PillarsConfig, pillars_state_from_flax)
    from lidar_object_detection_tpu_torch.models.pointpillars import (
        train as ptrain)
    from lidar_object_detection_tpu_torch.models.pointpillars.loss import (
        iou_bound, top_candidates)
    from lidar_object_detection_tpu_torch.models.yolo.model import (
        YoloConfig)
    from lidar_object_detection_tpu_torch.ops import kernel_lib
    from lidar_object_detection_tpu_torch.ops import rotated_iou_pairs as rip
    from lidar_object_detection_tpu_torch.parallel.train import YoloTrainer
    from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
        read_flax_msgpack)

    t0 = time.perf_counter()
    bf16, f32 = torch.bfloat16, torch.float32
    dtypes = {"float32": f32, "bfloat16": bf16}
    zero = {k: 0 for k in kernel_lib.LAUNCHES}
    summary, launches = {"card": smi}, {}

    # YOLO11n-seg: card against CPU, repeated runs, times, a trace
    images, targets, cpu_f32 = yolo_batch
    n_vars = read_flax_msgpack(CKPT)["variables"]
    t = time.perf_counter()
    steps = {device: yolo_step_grads(torch, n_vars, images.to(device),
                                     targets, device, dtype=bf16)
             for device in (dev, "cpu")}
    summary["yolo_n_step1"] = bf16_agreement(
        steps[dev], steps["cpu"], cpu_f32, ("cls", "box", "dfl", "seg"),
        "YOLO11n-seg bf16 step 1, B = 4")
    summary["yolo_n_step1"]["s"] = time.perf_counter() - t
    del steps

    def yolo_trainer(scale, dtype, variables, ema=0.9):
        tr = YoloTrainer(YoloConfig(scale=scale), device=dev, dtype=dtype,
                         ema_decay=ema)
        tr.load(variables)
        return tr

    trainers = {name: yolo_trainer("n", dt, n_vars)
                for name, dt in dtypes.items()}
    b_imgs, b_tg = trainers["bfloat16"].put(images, targets)

    def yolo_state(tr):
        return {"variables": tr.variables(), "ema": tr.ema_variables(),
                "opt": tr.opt_state_dict()}

    launches["yolo_n"], last = repeated_runs(
        torch, lambda: yolo_trainer("n", bf16, n_vars),
        lambda tr: tr.train_step(b_imgs, b_tg), yolo_state,
        "YOLO11n-seg bf16")
    if launches["yolo_n"] != zero or not np.isfinite(last["loss"]):
        raise AssertionError(f"YOLO11n-seg bf16 steps: launches "
                             f"{launches['yolo_n']}, last metrics {last}")
    times = alternated(torch, trainers, lambda tr: yolo_step_times(
        torch, tr, b_imgs, b_tg, BF16_TIME_ITERS))
    summary["yolo_n_ms"] = times
    print(f"YOLO11n-seg step at B = 4, 192 x 640, float32 and bfloat16 "
          f"alternated, CUDA events, on {smi}: {json.dumps(times)}",
          flush=True)
    print("traced YOLO11n-seg bf16 training step (B = 4):", flush=True)
    summary["yolo_n_profile"] = profile_once(
        torch, lambda: trainers["bfloat16"].train_step(b_imgs, b_tg))
    del trainers
    phase("bf16 training: YOLO11n-seg", t0)

    # YOLO11x-seg: float32 masters cast from the committed bf16 arrays
    x_vars = float32_tree(torch, read_flax_msgpack(CKPT_X)["variables"])
    trainers = {name: yolo_trainer("x", dt, x_vars, ema=0.0)
                for name, dt in dtypes.items()}

    def x_step(tr):
        ms, m = time_events(torch, lambda: tr.train_step(b_imgs, b_tg),
                            BF16_TIME_ITERS)
        if not np.isfinite(float(m["loss"])):
            raise AssertionError(f"the x step's loss is {m['loss']}")
        return ms
    summary["yolo_x_step_ms"] = alternated(torch, trainers, x_step)
    print(f"YOLO11x-seg step at B = 4, 192 x 640, float32 and bfloat16 "
          f"alternated, on {smi}: {summary['yolo_x_step_ms']}", flush=True)
    del trainers, x_vars
    torch.cuda.empty_cache()
    phase("bf16 training: YOLO11x-seg", t0)

    # PointPillars SSD at the surround grid
    cfg = dataclasses.replace(PillarsConfig.kitti360_surround(), head="ssd")
    state = pillars_state_from_flax(read_flax_msgpack(PP_CKPTS["ssd"])["0"])
    small = tuple(a[:PP_BF16_CPU_FRAMES] for a in pp_batch)
    t = time.perf_counter()
    steps = {(device, name): training_step_grads(torch, cfg, state, small,
                                                 device, dtype=dtype)
             for device, name, dtype in ((dev, "bf16", bf16),
                                         ("cpu", "bf16", bf16),
                                         ("cpu", "f32", f32))}
    if len({v[0]["num_pos"] for v in steps.values()}) != 1:
        raise AssertionError(f"PointPillars bf16 step 1: num_pos differs: "
                             f"{[v[0] for v in steps.values()]}")
    summary["pp_ssd_step1"] = bf16_agreement(
        steps[(dev, "bf16")], steps[("cpu", "bf16")], steps[("cpu", "f32")],
        ("cls", "box", "dir"), f"PointPillars SSD bf16 step 1, "
        f"{PP_BF16_CPU_FRAMES} frame(s)")
    summary["pp_ssd_step1"]["s"] = time.perf_counter() - t
    del steps

    def pp_trainer(dtype, cfg=cfg, state=state):
        tr = ptrain.PillarsTrainer(cfg, device=dev, dtype=dtype)
        tr.model.load_state_dict(state)
        return tr

    probe = pp_trainer(bf16)
    batch = probe.batch_tensors(*pp_batch)
    launches["pp_ssd"], last = repeated_runs(
        torch, lambda: pp_trainer(bf16), lambda tr: tr.train_step(*batch),
        lambda tr: dict(zip("vos", tr.state.flax_tree())),
        "PointPillars SSD bf16")
    if launches["pp_ssd"] != dict(zero, rotated_iou_pairs=BF16_STEPS) \
            or not np.isfinite(last["loss"]):
        raise AssertionError(f"PointPillars SSD bf16 steps: launches "
                             f"{launches['pp_ssd']}, last metrics {last}")
    # the kernel on the bf16 step's candidate pairs against its twin
    gt, gv = batch[2], batch[4]
    idx = top_candidates(iou_bound(probe.anchors, gt))
    got = rip.rotated_iou_pairs_cuda(probe.anchors, idx, gt, gv)
    ref = torch.where(gv[..., None], rip.rotated_iou_pairs_plain(
        probe.anchors, idx, gt), 0.0)
    pair_err = float((got - ref).abs().max())
    summary["pp_pairs"] = {"pairs": idx.numel(), "max_abs_err": pair_err}
    print(f"rotated_iou_pairs on the bf16 step's {idx.numel()} pairs: "
          f"within {pair_err:.3g} of the twin (limit {PP_IOU_TOL})",
          flush=True)
    if not pair_err <= PP_IOU_TOL:
        raise AssertionError(f"rotated_iou_pairs differs from its twin on "
                             f"the bf16 step's pairs by {pair_err}")
    del probe
    trainers = {name: pp_trainer(dt) for name, dt in dtypes.items()}
    summary["pp_ssd_step_ms"] = alternated(torch, trainers, lambda tr: (
        time_events(torch, lambda: tr.train_step(*batch),
                    BF16_TIME_ITERS)[0]))
    print(f"PointPillars SSD step at B = 4, surround grid, float32 and "
          f"bfloat16 alternated, on {smi}: {summary['pp_ssd_step_ms']}",
          flush=True)
    print("traced PointPillars SSD bf16 training step (B = 4):", flush=True)
    summary["pp_ssd_profile"] = profile_once(
        torch, lambda: trainers["bfloat16"].train_step(*batch))
    del trainers
    phase("bf16 training: PointPillars SSD", t0)

    # PointPillars center: a short curve, card against CPU
    r = PP_BF16_CENTER_RANGE
    ccfg = dataclasses.replace(cfg, head="center", grid=dataclasses.replace(
        cfg.grid, x_range=(-r, r), y_range=(-r, r)))
    cstate = pillars_state_from_flax(
        read_flax_msgpack(PP_CKPTS["center"])["0"])
    curves = {}
    for device in (dev, "cpu"):
        tr = ptrain.PillarsTrainer(ccfg, device=device, dtype=bf16)
        tr.model.load_state_dict(cstate)
        curves[str(device)] = [
            (float(m["loss"]), float(m["num_pos"])) for m in
            (tr.train_step(*small) for _ in range(PP_BF16_CENTER_STEPS))]
        del tr
    center_err = curves_agree(curves[str(dev)], curves["cpu"])
    summary["pp_center"] = {"curves": curves, "loss_rel_err": center_err}
    print(f"PointPillars center bf16, {PP_BF16_CENTER_STEPS} steps on "
          f"{PP_BF16_CPU_FRAMES} frame(s), {ccfg.grid.nx} x {ccfg.grid.ny} "
          f"pillars, (loss, num_pos): card "
          f"{curves[str(dev)]}, CPU {curves['cpu']}; losses within "
          f"{center_err} relative (limit {PP_BF16_CENTER_RTOL})", flush=True)
    if center_err is None or center_err > PP_BF16_CENTER_RTOL:
        raise AssertionError(f"the center head's bf16 steps on the card "
                             f"differ from the CPU's: {curves}")
    summary["s"] = time.perf_counter() - t0
    print(json.dumps({"bf16_train": summary}), flush=True)
    phase("bf16 training", t0)
    return launches, summary


# ---------------------------------------------------------------------------
# scale-out: the (data, model) mesh over torch.distributed
# ---------------------------------------------------------------------------

# the pipeline check's chain (tests/test_pipeline_parallel.py's stage):
# width, micro-batch rows, stages, micro-batches
PIPE_D, PIPE_MB, PIPE_S, PIPE_M = 16, 4, 2, 3
SCALE_OUT_TIMEOUT = 300


def flat_tree(tree, path=()):
    """A nested dict of arrays as {"a/b/c": copy of the array}."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flat_tree(value, (*path, key)))
        else:
            out["/".join((*path, key))] = np.array(value)
    return out


def pipeline_case():
    rng = np.random.default_rng(15)
    return (rng.normal(0, 0.5, (PIPE_S, PIPE_D, PIPE_D)).astype(np.float32),
            rng.normal(0, 0.1, (PIPE_S, PIPE_D)).astype(np.float32),
            rng.normal(size=(PIPE_M, PIPE_MB, PIPE_D)).astype(np.float32),
            rng.normal(size=(PIPE_M, PIPE_MB, PIPE_D)).astype(np.float32))


def yolo_mesh_step(torch, mesh, variables, images, targets, device):
    """One n step in the trainer's pieces over ``mesh``: the whole batch's
    loss parts and the full gradients (Flax layout, on the host)."""
    from lidar_object_detection_tpu_torch.models.yolo.model import (
        YoloConfig)
    from lidar_object_detection_tpu_torch.models.yolo.weights import (
        yolo_flax_from_state)
    from lidar_object_detection_tpu_torch.parallel import collectives
    from lidar_object_detection_tpu_torch.parallel.train import YoloTrainer

    tr = YoloTrainer(YoloConfig(scale="n"), device=device, mesh=mesh)
    tr.load(variables)
    imgs, tg = tr.local_batch(*tr.put(images, targets))
    loss, parts = tr.loss(imgs, tg)
    grads = tr.gradients(loss)
    shares = {"loss": loss, **parts}
    total = collectives.all_reduce_coalesced(
        [v.detach() for v in shares.values()], tr.data_group)
    return tr, ({k: float(v) for k, v in zip(shares, total)},
                yolo_flax_from_state(tr.full_tree(grads))["params"])


def scale_out_ranks(job, device="cuda"):
    """What each of two ranks on the one card (gloo) checks; returns numpy
    results and each part's kernel launches on this rank.  ``device``
    "cpu" runs the same checks on the CPU, to rehearse them."""
    import torch
    import torch.distributed as dist

    from lidar_object_detection_tpu_torch.config import (
        FusionConfig, FusionParams, PipelineVersion)
    from lidar_object_detection_tpu_torch.models.pointpillars import (
        PillarsConfig, PillarsTrainer, pillars_flax_from_state,
        pillars_state_from_flax)
    from lidar_object_detection_tpu_torch.ops import kernel_lib
    from lidar_object_detection_tpu_torch.parallel import (
        collectives, make_mesh, pipeline_apply, pipeline_loss_fn,
        point_sharded_fuse_frame)
    from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
        read_flax_msgpack)

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    data = dict(np.load(os.path.join(job, "inputs.npz")))
    n_vars = read_flax_msgpack(CKPT)["variables"]
    out = {"rank": dist.get_rank(), "backend": dist.get_backend(),
           "launches": {}}
    images = torch.from_numpy(data["images"]).to(dev)
    targets = {k: data[k] for k in ("boxes", "classes", "valid", "masks")}

    # YOLO: data 2, then model 2 (the kernels in halves over the ranks)
    for name, mp in (("yolo_data2", 1), ("yolo_model2", 2)):
        kernel_lib.reset_launches()
        tr, out[name] = yolo_mesh_step(torch, make_mesh(dev.type, mp),
                                       n_vars, images, targets, dev)
        sync()
        out["launches"][name] = dict(kernel_lib.LAUNCHES)
        if mp == 1:
            out["yolo_data2_step_ms"] = time_events(
                torch, lambda: tr.train_step(images, targets), 3)[0]
            grads = [torch.ones_like(p) for p in tr.state.params().values()]
            out["allreduce_w2_ms"] = time_events(
                torch, lambda: collectives.all_reduce_coalesced(
                    grads, tr.data_group), 5)[0]
        del tr

    # PointPillars: the SSD step at the surround grid, 2 + 2 frames
    cfg = dataclasses.replace(PillarsConfig.kitti360_surround(), head="ssd")
    pp = PillarsTrainer(cfg, device=dev, mesh=make_mesh(dev.type))
    pp.model.load_state_dict(pillars_state_from_flax(
        read_flax_msgpack(PP_CKPTS["ssd"])["0"]))
    batch = pp.local_batch(*pp.batch_tensors(
        *(data[f"pp{i}"] for i in range(5))))
    kernel_lib.reset_launches()
    parts = pp.loss(*batch)
    grads = pp.gradients(parts["loss"])
    sync()
    out["launches"]["pp_step"] = dict(kernel_lib.LAUNCHES)
    keys = ["loss", "cls", "box", "dir"]
    total = collectives.all_reduce_coalesced(
        [parts[k].detach() for k in keys], pp.data_group)
    out["pp_step"] = ({**{k: float(v) for k, v in zip(keys, total)},
                       "num_pos": float(parts["num_pos"])},
                      pillars_flax_from_state(grads)["params"])
    del pp, grads, parts

    # point-sharded fusion: each scan's points in halves over the ranks
    mesh = make_mesh(dev.type, 2)
    params = FusionParams.from_config(
        FusionConfig.for_version(PipelineVersion.CSV_EVAL))
    calib = [torch.from_numpy(m).to(dev)
             for m in (VELO_TO_RECT, CAM_TO_VELO, INTRINSICS)]
    scans = [torch.from_numpy(data[f"fuse{i}"]).to(dev) for i in range(6)]
    kernel_lib.reset_launches()
    fused = [point_sharded_fuse_frame(mesh, *(s[b] for s in scans), *calib,
                                      params)
             for b in range(len(scans[0]))]
    sync()
    out["launches"]["point_sharded"] = dict(kernel_lib.LAUNCHES)
    out["point_sharded"] = {k: np.stack([f[k].cpu().numpy() for f in fused])
                            for k in ("counts", "total_points", "best_box",
                                      "matched")}

    # the pipeline over 2 stages against the sequential chain
    w, b, x, y = (torch.from_numpy(a).to(dev) for a in pipeline_case())
    stage = lambda prm, h: torch.relu(h @ prm["w"] + prm["b"])
    mse = lambda o, t: torch.mean((o - t) ** 2)
    params_p = {"w": w.clone().requires_grad_(True),
                "b": b.clone().requires_grad_(True)}
    loss = pipeline_loss_fn(mesh, stage, mse)(params_p, x, y)
    pipe = (float(loss.detach()), *(g.cpu().numpy() for g in
                                    torch.autograd.grad(loss, [
                                        params_p["w"], params_p["b"]])))
    with torch.no_grad():
        pipe_out = pipeline_apply(mesh, stage, params_p, x).cpu().numpy()
    ws, bs = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    seq_out = []
    for mb in x:
        h = mb
        for i in range(PIPE_S):
            h = stage({"w": ws[i], "b": bs[i]}, h)
        seq_out.append(h)
    seq_out = torch.stack(seq_out)
    seq_loss = mse(seq_out, y)
    seq = (float(seq_loss.detach()), *(g.cpu().numpy() for g in
                                       torch.autograd.grad(seq_loss,
                                                           [ws, bs])))
    out["pipeline"] = {"out": pipe_out, "seq_out": seq_out.detach().cpu()
                       .numpy(), "grads": pipe, "seq_grads": seq}
    return out


def scale_out_runner(argv):
    """The distillation runner's ``main`` on this rank, as torchrun starts
    it; returns this rank's kernel launches."""
    import torch

    from lidar_object_detection_tpu_torch.ops import kernel_lib
    from lidar_object_detection_tpu_torch.pipelines import yolo_distill

    kernel_lib.reset_launches()
    yolo_distill.main(argv)
    torch.cuda.synchronize()
    return dict(kernel_lib.LAUNCHES)


def scale_out_phase(torch, dev, smi, tmp, scenes, serving_det, pp_batch):
    """The scale-out layer on the card:

    * a world of one on NCCL in this process (``make_mesh`` brings it
      up): the full-width n step (80 classes, 192 x 640, MAX_T 32, B = 4,
      the committed variables, EMA on) through the mesh trainer byte-equal
      to the one-card trainer's (metrics, variables, EMA, AdamW state);
      ``point_sharded_fuse_frame`` over each of the main path's 4 scans
      (P = 131072, G = 384, csv_eval's erosion, the serving detections'
      masks) and ``sharded_fuse_batch`` equal to ``fuse_batch`` bit for
      bit, K1 once per frame and once per batch; step times (one card,
      mesh, the mesh with each rank's own BatchNorm statistics, then
      back) and all-reduce times;
    * two ranks on this one card over gloo (NCCL refuses two ranks on a
      device; ``scale_out_ranks``): the n step at data 2 and at model 2
      against the one-process step (``check_yolo_grads``); the
      PointPillars SSD step at the surround grid from the committed
      variables, 2 + 2 frames, against the one-process step (PP_STEP_*),
      the assigner's IoU kernel once per rank; point-sharded fusion over
      2 ranks, counts exact; the pipeline over 2 stages against the
      sequential chain; the world-2 step's time, two processes sharing
      one card (not a scaling number);
    * the distillation runner under 2 ranks (``--steps 4``; gloo, as the
      ranks outnumber the card), twice: rank 0 alone prints and writes,
      the two runs' files byte-equal, K5 and K2 once each on rank 0 (its
      evaluation), nothing on rank 1.

    Prints ``{"scale_out": ...}`` and returns each path's launches of
    every kernel."""
    import torch.distributed as dist

    from lidar_object_detection_tpu_torch.config import (
        FusionConfig, FusionParams, PipelineVersion)
    from lidar_object_detection_tpu_torch.fusion.associate import fuse_batch
    from lidar_object_detection_tpu_torch.models.common import split_batch
    from lidar_object_detection_tpu_torch.models.pointpillars import (
        PillarsConfig, pillars_state_from_flax)
    from lidar_object_detection_tpu_torch.models.yolo.model import (
        YoloConfig)
    from lidar_object_detection_tpu_torch.ops import kernel_lib
    from lidar_object_detection_tpu_torch.parallel import (
        collectives, distributed, make_mesh, point_sharded_fuse_frame,
        sharded_fuse_batch)
    from lidar_object_detection_tpu_torch.parallel.train import YoloTrainer
    from lidar_object_detection_tpu_torch.pipelines import yolo_distill as yd
    from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
        read_flax_msgpack)

    t0 = time.perf_counter()
    root = os.path.join(tmp, "yolo_kitti360")
    cache = os.path.join(tmp, "labels.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        labels = yd.build_labels(root, cache=cache, device=dev)
    targets = {"boxes": labels["boxes_lb"], "classes": labels["classes"],
               "valid": labels["valid"], "masks": labels["masks_pr"]}
    images = yd.letterboxed(labels["images"], dev)
    n_vars = read_flax_msgpack(CKPT)["variables"]
    summary, launches = {}, {}

    # --- a world of one on NCCL, in this process ---
    if dist.is_initialized():
        raise AssertionError("a process group is up before the phase")
    mesh = make_mesh("cuda")
    if (dist.get_backend(), dist.get_world_size()) != ("nccl", 1):
        raise AssertionError(f"make_mesh brought up {dist.get_backend()} "
                             f"at world {dist.get_world_size()}")
    runs, trainers = {}, {}
    for name, m in (("one_card", None), ("mesh", mesh)):
        tr = YoloTrainer(YoloConfig(scale="n"), device=dev, ema_decay=0.9,
                         mesh=m)
        tr.load(n_vars)
        metrics = [tr.train_step(images, targets) for _ in range(2)]
        torch.cuda.synchronize()
        runs[name] = ({k: float(v) for k, v in metrics[-1].items()},
                      flat_tree(tr.variables()), flat_tree(tr.ema_variables()),
                      flat_tree(tr.opt_state_dict()))
        trainers[name] = tr
    a, b = runs["one_card"], runs["mesh"]
    if a[0] != b[0] or any(x.keys() != y.keys() or any(
            x[k].dtype != y[k].dtype or not np.array_equal(x[k], y[k])
            for k in x) for x, y in zip(a[1:], b[1:])):
        raise AssertionError(f"the world-of-one mesh step differs from the "
                             f"one-card step: {a[0]} / {b[0]}")
    # the steps' times, in the order one card, mesh, mesh with each rank's
    # own BatchNorm statistics (no collective in the forward), then back;
    # the last ablates the BatchNorm all-reduces
    tr = trainers["mesh"]
    for name in ("one_card", "mesh", "mesh_bn_local", "mesh_bn_local",
                 "mesh", "one_card"):
        split_batch(tr.model, None if name == "mesh_bn_local"
                    else tr.data_group)
        step = trainers["one_card" if name == "one_card" else "mesh"]
        summary.setdefault(f"step_w1_{name}_ms", []).append(time_events(
            torch, lambda: step.train_step(images, targets), 5)[0])
    print("traced n step through the world-of-one mesh trainer (B = 4):",
          flush=True)
    profile_once(torch, lambda: tr.train_step(images, targets))
    grads = [torch.ones_like(p) for p in tr.state.params().values()]
    summary["allreduce_w1_ms"] = time_events(
        torch, lambda: collectives.all_reduce_coalesced(
            grads, tr.data_group), 10)[0]
    summary["allreduce_mb"] = sum(g.numel() for g in grads) * 4 / 1e6
    del grads, tr, trainers
    print(f"world of one on NCCL: two n steps (B = 4, 192 x 640, EMA) "
          f"through the mesh trainer byte-equal to the one-card trainer's "
          f"(metrics {b[0]}, variables, EMA, AdamW state); step ms, timed "
          f"one card, mesh, mesh with local BatchNorm statistics, then "
          f"back: mesh {summary['step_w1_mesh_ms']}, one card "
          f"{summary['step_w1_one_card_ms']}, local BatchNorm "
          f"{summary['step_w1_mesh_bn_local_ms']}; gradient all-reduce "
          f"{summary['allreduce_w1_ms']:.3f} ms for "
          f"{summary['allreduce_mb']:.2f} MB, CUDA events, on {smi}",
          flush=True)

    points, pvalid, corners, bvalid = (
        torch.from_numpy(np.stack([s[i] for s in scenes])).to(dev)
        for i in range(4))
    calib = [torch.from_numpy(m).to(dev)
             for m in (VELO_TO_RECT, CAM_TO_VELO, INTRINSICS)]
    params = FusionParams.from_config(
        FusionConfig.for_version(PipelineVersion.CSV_EVAL))
    batch = (points, pvalid, serving_det["mask_bits"],
             serving_det["det_valid"], corners, bvalid)
    ref = fuse_batch(*batch, *calib, params=params)
    torch.cuda.synchronize()
    kernel_lib.reset_launches()
    frames = [point_sharded_fuse_frame(mesh, *(t[i] for t in batch), *calib,
                                       params) for i in range(len(points))]
    torch.cuda.synchronize()
    launches["point_sharded_w1"] = dict(kernel_lib.LAUNCHES)
    kernel_lib.reset_launches()
    whole = sharded_fuse_batch(mesh, batch, calib, params)
    torch.cuda.synchronize()
    launches["frame_sharded_w1"] = dict(kernel_lib.LAUNCHES)
    for key in ("counts", "total_points", "best_box", "points_inside",
                "matched"):
        if not torch.equal(torch.stack([f[key] for f in frames]), ref[key]):
            raise AssertionError(f"point-sharded fusion's {key} differs "
                                 f"from fuse_batch's")
    for key, value in ref.items():
        if not torch.equal(whole[key], value):
            raise AssertionError(f"sharded_fuse_batch's {key} differs from "
                                 f"fuse_batch's")
    want_k1 = {"point_sharded_w1": len(points), "frame_sharded_w1": 1}
    for name, n in want_k1.items():
        if launches[name] != {k: n if k == "inside_counts" else 0
                              for k in kernel_lib.LAUNCHES}:
            raise AssertionError(f"{name} launched {launches[name]}")
    counted = int(ref["counts"].sum())
    print(f"world of one: point-sharded fusion of the main path's "
          f"{len(points)} scans ({points.shape[1]} points, "
          f"{corners.shape[1]} boxes, csv_eval) and sharded_fuse_batch equal "
          f"fuse_batch bit for bit ({counted} counted, "
          f"{int(ref['matched'].sum())} matched); K1 launches "
          f"{want_k1}", flush=True)
    del frames, whole, ref
    dist.destroy_process_group()
    phase("scale-out: world of one on NCCL", t0)

    # --- two ranks on the one card over gloo ---
    job = os.path.join(tmp, "scale_out_ranks")
    os.makedirs(job)
    np.savez(os.path.join(job, "inputs.npz"),
             images=images.cpu().numpy(),
             **{k: np.asarray(v) for k, v in targets.items()},
             **{f"pp{i}": np.asarray(a) for i, a in enumerate(pp_batch)},
             **{f"fuse{i}": t.cpu().numpy() for i, t in enumerate(batch)})
    cfg = dataclasses.replace(PillarsConfig.kitti360_surround(), head="ssd")
    state = pillars_state_from_flax(read_flax_msgpack(PP_CKPTS["ssd"])["0"])
    one_yolo = yolo_step_grads(torch, n_vars, images, targets, dev)
    one_pp = training_step_grads(torch, cfg, state, pp_batch, dev)
    k1_counts = fuse_batch(*batch, *calib, params=params)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ranks = [r.value for r in distributed.spawn(
        "chip_smoke:scale_out_ranks", 2, (job,), timeout=SCALE_OUT_TIMEOUT,
        device="cuda", path=[REPO],
        workdir=os.path.join(job, "run"))]
    summary["ranks_w2_wall_s"] = time.perf_counter() - t
    checks = {}
    for res in ranks:
        if res["backend"] != "gloo":
            raise AssertionError(f"two ranks on one card came up on "
                                 f"{res['backend']}, not gloo")
        for name in ("yolo_data2", "yolo_model2"):
            parts, grads = res[name]
            err = max(abs(parts[k] - one_yolo[0][k])
                      / max(abs(one_yolo[0][k]), 1e-12) for k in parts)
            if err > YOLO_STEP_LOSS_RTOL:
                raise AssertionError(f"{name} on rank {res['rank']}: loss "
                                     f"parts {parts} against {one_yolo[0]}")
            checks[f"{name}_rank{res['rank']}"] = (
                err, *check_yolo_grads(grads, one_yolo[1]))
        parts, grads = res["pp_step"]
        loss_err = max(abs(parts[k] - one_pp[0][k])
                       / max(abs(one_pp[0][k]), 1e-12)
                       for k in ("loss", "cls", "box", "dir"))
        grad_err = grad_spread(grads, one_pp[1])
        if not steps_agree(parts, one_pp[0], loss_err, grad_err):
            raise AssertionError(f"the PointPillars step on rank "
                                 f"{res['rank']}: {parts} against "
                                 f"{one_pp[0]}, gradients {grad_err}")
        checks[f"pp_step_rank{res['rank']}"] = (loss_err, grad_err)
        if res["launches"]["pp_step"]["rotated_iou_pairs"] != 1:
            raise AssertionError(f"rank {res['rank']}'s PointPillars step "
                                 f"launched {res['launches']['pp_step']}")
        for key, value in res["point_sharded"].items():
            if not np.array_equal(value, k1_counts[key].cpu().numpy()):
                raise AssertionError(f"rank {res['rank']}'s point-sharded "
                                     f"{key} differs from fuse_batch's")
        if res["launches"]["point_sharded"]["inside_counts"] != len(points):
            raise AssertionError(f"rank {res['rank']}'s point-sharded "
                                 f"fusion launched "
                                 f"{res['launches']['point_sharded']}")
        pipe = res["pipeline"]
        scale = max(float(np.abs(pipe["seq_out"]).max()), 1e-30)
        pipe_err = max(
            float(np.abs(pipe["out"] - pipe["seq_out"]).max()) / scale,
            abs(pipe["grads"][0] - pipe["seq_grads"][0])
            / abs(pipe["seq_grads"][0]),
            *(float(np.abs(g - s).max()) / max(float(np.abs(s).max()),
                                                1e-30)
              for g, s in zip(pipe["grads"][1:], pipe["seq_grads"][1:])))
        if pipe_err > 1e-5:
            raise AssertionError(f"the pipeline on rank {res['rank']} is "
                                 f"{pipe_err} off the sequential chain")
        checks[f"pipeline_rank{res['rank']}"] = pipe_err
    summary["step_w2_gloo_ms"] = [r["yolo_data2_step_ms"] for r in ranks]
    summary["step_w2_gloo_note"] = ("two processes sharing one card over "
                                    "gloo: not a scaling number")
    summary["allreduce_w2_gloo_ms"] = [r["allreduce_w2_ms"] for r in ranks]
    launches["ranks_w2"] = [r["launches"] for r in ranks]
    print(f"two ranks on one card over gloo: every check passed {checks} "
          f"(YOLO: loss parts' error, gradients' error, the zero leaves' "
          f"shares; PointPillars: loss parts, gradients; pipeline); the "
          f"data-2 n step {summary['step_w2_gloo_ms']} ms and its gradient "
          f"all-reduce {summary['allreduce_w2_gloo_ms']} ms per rank, two "
          f"processes sharing one card (not a scaling number), CUDA "
          f"events, on {smi}", flush=True)
    phase("scale-out: two ranks on one card", t0)

    # --- the distillation runner under two ranks, twice ---
    files, runner = [], []
    for run in ("first", "again"):
        ckpt = os.path.join(tmp, f"yolo_w2_{run}.msgpack")
        t = time.perf_counter()
        rank_runs = distributed.spawn(
            "chip_smoke:scale_out_runner", 2,
            (["--dataset", root, "--cache", cache, "--ckpt", ckpt,
              "--steps", "4", "--ema-decay", "0.9", "--device", "cuda"],),
            timeout=SCALE_OUT_TIMEOUT, device="cuda", path=[REPO],
            workdir=os.path.join(tmp, f"runner_{run}"))
        summary.setdefault("runner_w2_wall_s", []).append(
            time.perf_counter() - t)
        zero, one = rank_runs
        if one.stdout or f"[train] ckpt -> {ckpt} @ 4" not in zero.stdout:
            raise AssertionError(f"the runner's ranks printed "
                                 f"{zero.stdout!r} and {one.stdout!r}")
        want = {k: 0 for k in kernel_lib.LAUNCHES}
        if one.value != want or zero.value != dict(want, nms=1,
                                                   mask_assemble=1):
            raise AssertionError(f"the runner's ranks launched "
                                 f"{zero.value} and {one.value}")
        runner.append([zero.value, one.value])
        files.append([read_bytes(ckpt + s) for s in ("", ".opt", ".json")])
        eval_line = zero.stdout.strip().splitlines()[-1]
    if files[0] != files[1]:
        raise AssertionError("two runner runs under 2 ranks wrote different "
                             "files")
    launches["runner_w2"] = runner[0]
    print(f"yolo_distill under 2 ranks (gloo, one card), twice: rank 0 "
          f"alone printed and wrote, the same .msgpack, .opt and .json bytes; "
          f"its evaluation {eval_line}; wall s "
          f"{summary['runner_w2_wall_s']} (host clock) on {smi}",
          flush=True)
    summary["checks"] = checks
    summary["card"] = smi
    print(json.dumps({"scale_out": summary}), flush=True)
    phase("scale-out", t0)
    return launches, summary


def car_boxes(torch, dev, rng, shape, spread):
    """(*shape, 7) float32 car boxes of any yaw on ``dev``, centred in a
    square of half-width ``spread`` m."""
    b = np.zeros((*shape, 7), np.float32)
    b[..., 0] = rng.uniform(-spread, spread, shape)
    b[..., 1] = rng.uniform(-spread, spread, shape)
    b[..., 2], b[..., 5] = -1.0, 1.5
    b[..., 3] = rng.uniform(1.4, 2.2, shape)
    b[..., 4] = rng.uniform(3.2, 5.0, shape)
    b[..., 6] = rng.uniform(-np.pi, np.pi, shape)
    return torch.from_numpy(b).to(dev)


def pair_cases(torch, dev, rng, real):
    """Operands of the assigner's IoU kernel: the training step's real
    candidates (``real``: anchors (N, 7), top-k indices (B, G, K), GTs,
    validity; left out where None), a seeded heavy overlap (4096 car
    boxes of any yaw in a 12 m square as anchors, 4 x 64 GTs among them,
    10 % invalid) and 16 frames of ``degenerate_boxes`` (anchors and GTs
    alike; their copies' pairs can take the ring routine).  name ->
    (anchors, idx, gt, gt_valid)."""
    from lidar_object_detection_tpu_torch.models.pointpillars.loss import (
        iou_bound, top_candidates)

    def cars(shape, spread):
        return car_boxes(torch, dev, rng, shape, spread)

    def case(anchors, gt, gv):
        return anchors, top_candidates(iou_bound(anchors, gt)), gt, gv

    overlap = case(cars((4096,), 6.0), cars((4, 64), 6.0),
                   torch.from_numpy(rng.uniform(size=(4, 64)) > 0.1).to(dev))
    deg, _, _ = degenerate_boxes(rng, 16, 512)
    deg = torch.from_numpy(deg).to(dev)
    degenerate = case(deg.reshape(-1, 7).contiguous(),
                      deg[:, :64].contiguous(),
                      torch.ones((16, 64), dtype=torch.bool, device=dev))
    cases = {"heavy overlap": overlap, "degenerate": degenerate}
    return cases if real is None else {"training step": real, **cases}


def pair_bound(torch, anchors, idx, gt, gv):
    """The assigner's IoU kernel's bound on these operands.  Bytes: the
    GT flags once; the valid GTs once and, for each of their pairs, the
    index and the gathered anchor; the output once per pair (a pair of an
    invalid GT reads nothing but its GT's flag and writes 0).
    Operations: PP_CLIP_OPS for each pair the kernel clips (a valid GT,
    circumcircles within the kernel's reach test)."""
    a = anchors[idx]                                        # (B, G, K, 7)
    g = gt[:, :, None, :]
    rad = lambda x: 0.5 * torch.sqrt(x[..., 3] ** 2 + x[..., 4] ** 2)
    d2 = (a[..., 0] - g[..., 0]) ** 2 + (a[..., 1] - g[..., 1]) ** 2
    reach = rad(a) + rad(g)
    clipped = int(((d2 <= 1.01 * reach * reach + 1.0)
                   & gv[..., None]).sum())
    n_valid = int(gv.sum())
    n_bytes = (gv.numel() + n_valid * (28 + idx.shape[2] * (8 + 28))
               + idx.numel() * 4)
    return bound_ms(n_bytes, PP_CLIP_OPS * clipped), clipped


def check_rotated_iou_pairs(torch, dev, rng, real):
    """The training assigner's IoU kernel against its twin on the card
    (``pair_cases``): IoUs within PP_IOU_TOL over the valid GTs' pairs, 0
    for invalid GTs; on the step's candidates the assignment (matched,
    pos, neg) replayed from the kernel's IoUs equal to the one from the
    twin's except at anchors with a deciding IoU within PP_IOU_TOL of a
    threshold or of the runner-up GT's (their count printed); the
    degenerate case must send pairs through the ring routine.  Timed on
    the step's candidates (B = 4, G = 64, K = 512) beside the twin."""
    from lidar_object_detection_tpu_torch.models.pointpillars.loss import (
        assign_from_iou)
    from lidar_object_detection_tpu_torch.ops import kernel_lib
    from lidar_object_detection_tpu_torch.ops import rotated_iou_pairs as rip

    cases = pair_cases(torch, dev, rng, real)
    stats, max_err, slow_of = {}, 0.0, {}
    for name, (anchors, idx, gt, gv) in cases.items():
        got, slow = rip.rotated_iou_pairs_cuda(anchors, idx, gt, gv,
                                               count_slow=True)
        ref = torch.where(gv[..., None],
                          rip.rotated_iou_pairs_plain(anchors, idx, gt), 0.0)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"assigner IoU kernel: {name}: non-finite")
        err = float((got - ref).abs().max())
        max_err = max(max_err, err)
        slow_of[name] = int(slow.item())
        stats[name] = {"pairs": idx.numel(), "max_abs_err": err,
                       "positive": int((got > 0).sum()),
                       "over 0.6": int((got >= 0.6).sum())}
    # the step's assignment, replayed from the kernel's IoUs
    anchors, idx, gt, gv = real
    b, g, _ = idx.shape
    n = anchors.shape[0]
    flat = (idx * g + torch.arange(g, device=dev)[:, None]).reshape(b, -1)
    dense = {}
    for name, ious in (("kernel", rip.rotated_iou_pairs_cuda(anchors, idx,
                                                              gt, gv)),
                       ("twin", torch.where(gv[..., None],
                                            rip.rotated_iou_pairs_plain(
                                                anchors, idx, gt), 0.0))):
        m = torch.zeros((b, n * g), device=dev)
        m.scatter_(1, flat, torch.clamp(ious, min=0.0).reshape(b, -1))
        dense[name] = m.reshape(b, n, g)
    got = assign_from_iou(dense["kernel"], gv)
    ref = assign_from_iou(dense["twin"], gv)
    differ = torch.zeros((b, n), dtype=torch.bool, device=dev)
    for key in ("matched", "pos", "neg"):
        differ |= got[key] != ref[key]
    iou = torch.where(gv[:, None, :], dense["kernel"], 0.0)
    near = torch.zeros_like(iou, dtype=torch.bool)
    for t in PP_ASSIGN_THRESHOLDS:
        near |= (iou - t).abs() <= PP_IOU_TOL
    top2 = torch.topk(iou, 2, dim=2).values
    close = near.any(dim=2) | ((top2[..., 1] > 0)
                               & (top2[..., 0] - top2[..., 1] <= PP_IOU_TOL))
    n_close = int(close.sum())
    n_differ = int(differ.sum())
    unexplained = int((differ & ~close).sum())
    print(f"assigner IoU cases: {stats}; ring routine pairs {slow_of}; the "
          f"step's assignment from the kernel's IoUs: {n_differ} anchors "
          f"differ from the twin's, {n_close} anchors with a deciding IoU "
          f"within {PP_IOU_TOL} of a threshold or a tie; positives "
          f"{int(got['pos'].sum())}", flush=True)
    if max_err > PP_IOU_TOL or unexplained:
        raise AssertionError(f"the assigner's IoU kernel differs from its "
                             f"twin by {max_err}; {unexplained} anchors' "
                             f"assignments differ without a close IoU")
    if slow_of["degenerate"] == 0 or int(got["pos"].sum()) == 0 \
            or stats["heavy overlap"]["over 0.6"] == 0:
        raise AssertionError(f"degenerate assigner IoU cases: {stats}, "
                             f"{slow_of}")

    lib = kernel_lib.library()
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)

    def launcher():
        kernel_lib.check(lib.rotated_iou_pairs_launch(
            anchors.data_ptr(), n, idx.data_ptr(), gt.data_ptr(),
            gv.data_ptr(), b, g, idx.shape[2], out.data_ptr(), None,
            kernel_lib.stream_handle(dev)), "rotated_iou_pairs_launch")

    (bound, by), clipped = pair_bound(torch, anchors, idx, gt, gv)
    entry = {"name": "rotated_iou_pairs", "route": "cuda",
             "source": "lidar_object_detection_tpu_torch/csrc/"
                       "rotated_nms.cu",
             "replaces": "lidar_object_detection_tpu/models/pointpillars/"
                         "loss.py:80",
             "max_abs_err": max_err, "mismatches": unexplained,
             "assignment_differs": n_differ, "close_anchors": n_close,
             "cases": len(cases), "ring_routine_pairs": slow_of,
             "pairs": idx.numel(), "clipped_pairs": clipped,
             "ms": time_gpu(launcher), "bound_ms": bound, "bound_by": by,
             "plain_ms": time_gpu(lambda: rip.rotated_iou_pairs_plain(
                 anchors, idx, gt), reps=5, warmup=1, head_start=False),
             "library_ms": None}
    entry["kernel_ms"] = entry["ms"]
    print(f"rotated_iou_pairs: within {max_err:.3g} of the twin on "
          f"{len(cases)} cases; the step's {idx.numel()} pairs "
          f"({clipped} clipped) {entry['ms']:.4f} ms (bound {bound:.3g} by "
          f"{by}); twin {entry['plain_ms']:.3f} ms", flush=True)
    return entry


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
    headers, colours and edges exact.  Returns the detection count and the
    worst boxes7, score and PLY coordinate errors."""
    total, box_err, score_err, ply_err = 0, 0.0, 0.0, 0.0
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
        if gb.shape != rb.shape:
            raise AssertionError(f"detections_{frame:010d}.json: "
                                 f"{len(gb)} boxes, the reference {len(rb)}")
        if len(rb):
            box_err = max(box_err, float(np.abs(gb - rb).max()))
            score_err = max(score_err, float(np.abs(
                np.asarray(got["scores"]) - ref["scores"]).max()))
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
                or not np.array_equal(gv[:, 3:], rv[:, 3:]):
            raise AssertionError(f"scene_{frame:010d}.ply differs")
        ply_err = max(ply_err, float(np.abs(gv[:, :3] - rv[:, :3]).max()))
    if box_err > box_atol or ply_err > box_atol or score_err > score_atol:
        raise AssertionError(f"the CLI's files are off by {box_err} "
                             f"(boxes7), {ply_err} (PLY), {score_err} "
                             f"(scores)")
    return total, box_err, score_err, ply_err


def same_files(got_dir, ref_dir, what):
    """Every file of two output directories, byte for byte."""
    names = sorted(os.listdir(ref_dir))
    if sorted(os.listdir(got_dir)) != names:
        raise AssertionError(f"{what}: the files differ: {names}")
    for name in names:
        if read_bytes(os.path.join(got_dir, name)) != read_bytes(
                os.path.join(ref_dir, name)):
            raise AssertionError(f"{what}: {name} differs")
    return len(names)


def pointpillars_phase(torch, dev, smi, tmp):
    """PointPillars inference on the card at the surround grid (640 x 640
    pillars, the committed checkpoints at full width, P = 131072 points a
    frame, one frame a forward), from a KITTI-360 tree of 4 frames whose
    sweeps are aggregated (``pillars_tree``):

    * the CLI ``pointpillars-infer --surround --aggregate-sweeps
      --export-ply`` with ``--head ssd`` (its default rotated-NMS decode,
      at PP_SSD_THRESHOLD) and ``--head center``, each run twice, counters
      zeroed before each: the rotated NMS once per frame in the SSD runs,
      no kernel in the center runs; the second run's JSON and PLY files
      byte-equal to the first's;
    * ``infer_pointpillars(..., rotated_nms=False)`` through the Python
      API: K5 once per frame;
    * references: the card's heads against a CPU forward of the port
      (first frame of each head, within 2e-3), and against a second
      forward on the card (bit for bit); each frame's card decode against
      the CPU decode of the card's own heads (validity and classes exact,
      boxes7 within 1e-4, scores within 1e-6); the CLI's JSON and PLY
      files byte-equal to those written from the card decode, and against
      those written from the CPU decode (counts and classes exact, boxes7
      and coordinates within 1e-4, scores within 1e-6; the worst errors
      printed);
    * CUDA-event times of the forward and the decodes, and a traced frame.

    Returns each run's launches, the SSD path's candidates on the card
    (4, 512, ...) and AABB operands of its first frame, and a summary."""
    from lidar_object_detection_tpu_torch.config import ShapeConfig
    from lidar_object_detection_tpu_torch.data import Kitti360Dataset
    from lidar_object_detection_tpu_torch.models.pointpillars import (
        PillarsConfig, bev_aabb, decode_predictions)
    from lidar_object_detection_tpu_torch.models.pointpillars.decode import (
        decode_candidates)
    from lidar_object_detection_tpu_torch.models.pointpillars.voxelize import (
        pillar_ids)
    from lidar_object_detection_tpu_torch.ops import kernel_lib
    from lidar_object_detection_tpu_torch.pipelines import pointpillars as pp

    t0 = time.perf_counter()
    root = os.path.join(tmp, "pp_kitti360")
    n_cars = pillars_tree(root, np.random.default_rng(2))
    n = len(PP_FRAMES)
    base = ["pointpillars-infer", "--dataset", root, "--surround",
            "--aggregate-sweeps", "--export-ply", "--device", str(dev)]
    thresholds = {"ssd": PP_SSD_THRESHOLD, "center": 0.3}
    launches, outs, texts, walls, repeated = {}, {}, {}, {}, {}
    for head in ("ssd", "center"):
        # twice: the second run must write the first run's bytes
        for run in ("", "_again"):
            outs[head + run] = os.path.join(tmp, f"pp_cli_{head}{run}")
            argv = base + ["--ckpt", PP_CKPTS[head], "--head", head,
                           "--output", outs[head + run]]
            if head == "ssd":
                argv += ["--score-threshold", str(PP_SSD_THRESHOLD)]
            torch.cuda.synchronize()
            kernel_lib.reset_launches()
            t = time.perf_counter()
            texts[head + run] = run_cli(argv)
            torch.cuda.synchronize()
            walls[head + run] = time.perf_counter() - t
            launches[head + run] = dict(kernel_lib.LAUNCHES)
        repeated[head] = same_files(outs[head + "_again"], outs[head],
                                    f"the {head} CLI's second run")
    print(f"PointPillars CLI: a second run wrote the first run's bytes "
          f"({repeated} files)", flush=True)
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
    for run, want in (("ssd", dict(zero, rotated_nms=n)),
                      ("ssd_again", dict(zero, rotated_nms=n)),
                      ("center", zero), ("center_again", zero),
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
               "points": [len(c) for c in clouds],
               "cli_repeat_files_equal": repeated}
    # what the deterministic scope repairs: the first cloud's pillar sums
    # as plain float atomics, three times (reported, not required)
    points, pv = pp.padded_cloud(clouds[0], p_max, dev)
    grid = cfgs["ssd"].grid
    ids, ok = pillar_ids(points[0], pv[0], grid)
    atomic = [torch.zeros((grid.nx * grid.ny, 3), device=dev)
              .index_add_(0, ids, points[0, :, :3] * ok[:, None])
              for _ in range(3)]
    summary["atomic_sums_repeat"] = all(torch.equal(a, atomic[0])
                                        for a in atomic)
    path, aabb = None, None
    for head in ("ssd", "center"):
        cfg, thr = cfgs[head], thresholds[head]
        card, step = pp.load_pillars_model(PP_CKPTS[head], cfg, dev)
        ref_dir = os.path.join(tmp, f"pp_ref_{head}")
        card_dir = os.path.join(tmp, f"pp_card_{head}")
        os.makedirs(ref_dir)
        os.makedirs(card_dir)
        cands, errs, first = [], [], None
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
                    first = raw
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
            pp.write_detections(pp.detection_record(frame, det, step), pts,
                                card_dir, export_ply=True)
        # the CLI's forward and decode are another run of the same
        # computation: its files are those of this decode, byte for byte,
        # and within the decode's tolerances of the CPU decode's
        same_files(outs[head], card_dir, f"the {head} CLI against the API")
        total, box_err, score_err, ply_err = same_pillars_outputs(
            outs[head], ref_dir, PP_FRAMES, 1e-4, 1e-6)
        summary[f"{head}_cli_vs_cpu_decode_err"] = {
            "boxes7": box_err, "scores": score_err, "ply": ply_err}
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
            if not all(torch.equal(raw[k], first[k]) for k in raw):
                raise AssertionError(f"the {head} heads differ between two "
                                     f"forwards of one frame")
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
# KITTI 2D evaluation and the decode modes
# ---------------------------------------------------------------------------

# card vs CPU boxes of the same float32 network: its convolutions sum in
# another order on each device (pixels; the boxes span up to 1242)
KITTI2D_BOX_TOL = 1e-2


def n_detect_fn(torch, device):
    """A KITTI 2D ``detect_fn`` on the committed n checkpoint (float32,
    single view, the sidecar's confidence) on ``device``: one detector per
    image shape, the valid boxes truncated to int64 as the default
    detector's.  It decodes no masks (the evaluation reads boxes only)."""
    from lidar_object_detection_tpu_torch.models.yolo.postprocess import (
        postprocess_batch)
    from lidar_object_detection_tpu_torch.models.yolo.serving import (
        load_serving_checkpoint)

    cache = {}

    def detect(image):
        shape = image.shape[:2]
        if shape not in cache:
            cache[shape] = load_serving_checkpoint(
                CKPT, shape, tta="none", device=device)[0]
        det = cache[shape]
        out = postprocess_batch(det.forward(image[None]), det.params,
                                masks=False)
        valid = out["det_valid"][0].cpu().numpy()
        return out["boxes"][0].cpu().numpy()[valid].astype(np.int64)

    return detect


def kitti2d_tree(torch, dev, root):
    """A KITTI_Selection tree of three images cut from the committed frames
    at KITTI's shapes, labelled with the n checkpoint's cars on the card
    (shifted a pixel) and one car it does not see; a 3 x 3, a 3 x 4 and a
    3 x 3 calib.  Returns the images."""
    from lidar_object_detection_tpu_torch.eval.kitti2d import (
        monocular_distance)
    from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

    detect = n_detect_fn(torch, dev)
    frames = [read_png_rgb(path) for path in FRAMES]
    p2 = np.concatenate([INTRINSICS, [[44.857], [0.2163], [0.0027]]], 1)
    samples, images = [], []
    for i, (h, w) in enumerate(KITTI2D_SHAPES):
        image = np.ascontiguousarray(frames[i % 2][:h, :w])
        boxes = detect(image).astype(np.float64) + 1.0
        boxes = np.concatenate([boxes, [[20.0, 200.0, 140.0, 300.0]]])
        dist = monocular_distance(INTRINSICS, boxes) + 0.5
        labels = [("Car", *b, d) for b, d in zip(boxes, dist)]
        samples.append((f"{i:06d}", image, labels,
                        p2 if i == 1 else INTRINSICS))
        images.append(image)
    write_kitti2d_tree(root, samples)
    return images


def totals_of(text):
    """(TP, FP, FN) from the kitti2d CLI's output."""
    m = re.search(r"TP: (\d+)  FP: (\d+)  FN: (\d+)", text)
    if m is None:
        raise AssertionError(f"no totals in the CLI's output: {text!r}")
    return tuple(int(v) for v in m.groups())


def same_result_lines(card_dir, cpu_dir, n, ext="png"):
    """The ``results_*.<ext>.txt`` of a card and a CPU run: as many lines,
    and equal lines wherever both truncated detection boxes agree.
    Returns the lines compared."""
    compared = 0
    for i in range(n):
        name = f"results_{i:06d}.{ext}.txt"
        with open(os.path.join(card_dir, name)) as f:
            card_lines = f.read().splitlines()
        with open(os.path.join(cpu_dir, name)) as f:
            cpu_lines = f.read().splitlines()
        if len(card_lines) != len(cpu_lines):
            raise AssertionError(f"{name}: {len(card_lines)} lines on the "
                                 f"card, {len(cpu_lines)} on the CPU")
        for a, b in zip(card_lines, cpu_lines):
            box = lambda line: line.split("YoloBB ")[1].split(" and")[0]
            if box(a) == box(b):
                compared += 1
                if a != b:
                    raise AssertionError(f"{name}: {a!r} != {b!r}")
    return compared


def kitti2d_cli_on_both(torch, root, out, n, ext):
    """The CLI's ``kitti2d`` on the tree ``root`` of ``n`` ``.<ext>``
    images, on the card into ``out["card"]`` and with ``--device cpu``
    into ``out["cpu"]``.  K5 must launch once per image in the card run
    and no other kernel, and TP / FP / FN must be equal on both devices.
    Returns the card run's launches and a summary (totals, host seconds,
    result lines compared)."""
    from lidar_object_detection_tpu_torch.ops import kernel_lib

    torch.cuda.synchronize()
    kernel_lib.reset_launches()
    t = time.perf_counter()
    card_text = run_cli(["kitti2d", "--dataset", root, "--output",
                         out["card"]])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    launches = dict(kernel_lib.LAUNCHES)
    expected = {k: n if k == "nms" else 0 for k in launches}
    if launches != expected:
        raise AssertionError(f"kitti2d on .{ext} launched {launches}, "
                             f"expected {expected}")
    t = time.perf_counter()
    cpu_text = run_cli(["kitti2d", "--dataset", root, "--output", out["cpu"],
                        "--device", "cpu"])
    cpu_s = time.perf_counter() - t
    if totals_of(card_text) != totals_of(cpu_text):
        raise AssertionError(f"kitti2d on .{ext} TP/FP/FN: card "
                             f"{totals_of(card_text)}, CPU "
                             f"{totals_of(cpu_text)}")
    return launches, {
        "nms_launches_per_image": launches["nms"] / n,
        "cli_card_host_s": card_s, "cli_cpu_host_s": cpu_s,
        "totals_card": totals_of(card_text), "totals_cpu": totals_of(cpu_text),
        "result_lines_compared": same_result_lines(out["card"], out["cpu"],
                                                   n, ext)}


def n_checkpoint_on_both(torch, dev, root, out, n, ext):
    """``run_kitti2d_eval`` with a ``detect_fn`` on the n checkpoint on the
    card (into ``out["api"]``) and the CPU (``out["api_cpu"]``) on the tree
    ``root`` of ``n`` ``.<ext>`` images: it must match a car, give equal
    totals on both devices and equal result lines, at least one compared,
    and draw on every annotated image.  Returns (totals, lines compared)."""
    from lidar_object_detection_tpu_torch.pipelines.kitti2d import (
        run_kitti2d_eval)
    from lidar_object_detection_tpu_torch.utils.image import read_image_rgb

    api = run_kitti2d_eval(root, detect_fn=n_detect_fn(torch, dev),
                           output_dir=out["api"], device=dev)
    api_cpu = run_kitti2d_eval(root, detect_fn=n_detect_fn(torch, "cpu"),
                               output_dir=out["api_cpu"], device="cpu")
    totals = api.totals
    if totals["tp"] == 0:
        raise AssertionError(f"the n checkpoint matched no car on .{ext}: "
                             f"{totals}")
    if totals != api_cpu.totals:
        raise AssertionError(f"n checkpoint totals on .{ext}: card {totals}"
                             f", CPU {api_cpu.totals}")
    compared = same_result_lines(out["api"], out["api_cpu"], n, ext)
    if compared == 0:
        raise AssertionError(f"n checkpoint on .{ext}: no result line of "
                             "the card's agrees in its box with the CPU's")
    for i in range(n):
        name = f"{i:06d}.{ext}"
        image = read_image_rgb(os.path.join(root, "images", name))
        annotated = read_image_rgb(os.path.join(out["api"], name))
        if annotated.shape != image.shape or np.array_equal(annotated,
                                                            image):
            raise AssertionError(f"annotated image {name} is not drawn")
    return totals, compared


def kitti2d_phase(torch, dev, smi, tmp):
    """The KITTI 2D evaluation: the CLI's ``kitti2d`` on the card (YOLO11x's
    detection head at full width, 224 x 640 after the letterbox, random
    weights from seed 0, as the JAX CLI's) and with ``--device cpu``, then
    ``run_kitti2d_eval`` with a ``detect_fn`` on the n checkpoint on the
    card and on the CPU.  K5 must launch once per image and no other
    kernel; TP / FP / FN equal on both devices; the default detector's
    boxes on the card within KITTI2D_BOX_TOL of the CPU's, and the result
    lines equal wherever both truncations agree.  Returns the card CLI
    run's launches."""
    from lidar_object_detection_tpu_torch.models.yolo.detector import (
        YoloDetector)
    from lidar_object_detection_tpu_torch.models.yolo.model import (
        YoloConfig)

    t0 = time.perf_counter()
    root = os.path.join(tmp, "kitti2d")
    images = kitti2d_tree(torch, dev, root)
    out = {name: os.path.join(tmp, f"kitti2d_{name}")
           for name in ("card", "cpu", "api", "api_cpu")}
    launches, cli = kitti2d_cli_on_both(torch, root, out, len(images), "png")

    # the default detector on both devices, and its times on the card
    box_err, forward_ms, decode_ms = 0.0, [], []
    for i, image in enumerate(images):
        dets = {d: YoloDetector(image.shape[:2], YoloConfig(segment=False),
                                conf=0.5, device=d) for d in (dev, "cpu")}
        got, ref = (dets[d].detect(image[None]) for d in (dev, "cpu"))
        if not torch.equal(got["det_valid"].cpu(), ref["det_valid"]):
            raise AssertionError(f"image {i}: det_valid differs")
        v = ref["det_valid"]
        box_err = max(box_err, float((got["boxes"].cpu()[v]
                                      - ref["boxes"][v]).abs().max()))
        ms, outputs = time_events(torch, lambda: dets[dev].forward(
            image[None]))
        forward_ms.append(ms)
        decode_ms.append(time_events(torch, lambda: dets[dev].decode(
            outputs))[0])
        del dets
    if box_err > KITTI2D_BOX_TOL:
        raise AssertionError(f"kitti2d boxes: card vs CPU {box_err} px")
    totals, compared_api = n_checkpoint_on_both(torch, dev, root, out,
                                                len(images), "png")
    summary = {
        "images": len(images), "shapes": [list(s) for s in KITTI2D_SHAPES],
        "letterbox": [224, 640], **cli,
        "forward_ms": forward_ms, "decode_ms": decode_ms,
        "box_err_card_vs_cpu": box_err,
        "api_n_checkpoint_totals": totals,
        "api_result_lines_compared": compared_api, "card": smi}
    print(json.dumps({"kitti2d": summary}), flush=True)
    phase("KITTI 2D evaluation", t0)
    return launches


JPEG_FIXTURES = os.path.join(REPO, "tests", "fixtures", "jpeg")
JPEG_TIMING_REPS = 20
JPEG_PHASE_LIMIT_S = 60.0


def sha256_hex(data):
    import hashlib

    return hashlib.sha256(data).hexdigest()


def host_ms(fn, reps=JPEG_TIMING_REPS):
    """Median host milliseconds of ``fn()`` over ``reps`` calls, after
    one call to warm up."""
    fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def jpeg_phase(torch, dev, smi, tmp):
    """JPEG images through the port's own codec (``utils/jpeg.py``, host
    C++ of ``csrc/jpeg_codec.cpp`` built with g++, and its numpy twin).

    The committed fixtures (``tests/fixtures/jpeg``, written by Pillow
    from crops of the committed frame: baseline 4:2:0 at 375 x 1242,
    progressive, 4:4:4 with restart markers, grey) decode on both backends
    to the SHA-256 of Pillow's pixels recorded beside them, and the
    encoder writes the recorded hash of Pillow's ``save`` bytes of a crop.
    Then ``kitti2d_phase``'s tree (under ``tmp``) is written again with
    its images as JPEG by the port's encoder and goes through the same
    checks as the PNG tree: the CLI's ``kitti2d`` on the card and with
    ``--device cpu`` (K5 once per image and no other kernel, TP / FP / FN
    equal, the ``results_*.jpg.txt`` lines equal where both truncations
    agree, the annotated ``.jpg`` files JPEGs that decode), then the n
    checkpoint on both devices (a car matched, equal totals, at least one
    result line compared and equal, every annotated image drawn).
    Prints the codec's host milliseconds for one 375 x 1242 image beside
    the card's name and power limit.  Returns the card CLI run's
    launches."""
    from lidar_object_detection_tpu_torch.utils import jpeg
    from lidar_object_detection_tpu_torch.utils.image import read_image_rgb
    from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

    t0 = time.perf_counter()
    jpeg.build()
    build_s = time.perf_counter() - t0
    with open(os.path.join(JPEG_FIXTURES, "fixtures.json")) as f:
        record = json.load(f)
    twin_ms = {}
    for name, entry in sorted(record["fixtures"].items()):
        path = os.path.join(JPEG_FIXTURES, name)
        for backend in jpeg.BACKENDS:
            t1 = time.perf_counter()
            pixels = jpeg.read_jpeg_rgb(path, backend=backend)
            if backend == "numpy":
                twin_ms[name] = (time.perf_counter() - t1) * 1e3
            if (list(pixels.shape) != entry["shape"]
                    or sha256_hex(pixels.tobytes())
                    != entry["pixels_sha256"]):
                raise AssertionError(f"{name}: the {backend} decode is not "
                                     "Pillow's pixels")
    frame = read_png_rgb(os.path.join(REPO, record["frame"]))
    y0, y1, x0, x1 = record["encode"]["crop"]
    crop = np.ascontiguousarray(frame[y0:y1, x0:x1])
    for backend in jpeg.BACKENDS:
        if sha256_hex(jpeg.encode_jpeg_rgb(crop, backend=backend)) != \
                record["encode"]["sha256"]:
            raise AssertionError(f"the {backend} encoder does not write "
                                 "Pillow's bytes")
    with open(os.path.join(JPEG_FIXTURES, "baseline_420_375x1242.jpg"),
              "rb") as f:
        data = f.read()
    image = np.ascontiguousarray(frame[:375, :1242])
    decode_ms = host_ms(lambda: jpeg.read_jpeg_rgb(data))
    encode_ms = host_ms(lambda: jpeg.encode_jpeg_rgb(image))
    phase("JPEG: codec against the fixtures", t0)

    src, root = os.path.join(tmp, "kitti2d"), os.path.join(tmp, "kitti2d_jpg")
    for d in ("labels", "calib"):
        shutil.copytree(os.path.join(src, d), os.path.join(root, d))
    os.makedirs(os.path.join(root, "images"))
    stems = sorted(os.path.splitext(f)[0]
                   for f in os.listdir(os.path.join(src, "images")))
    shapes = []
    for stem in stems:
        pixels = read_png_rgb(os.path.join(src, "images", stem + ".png"))
        shapes.append(pixels.shape)
        jpeg.write_jpeg_rgb(os.path.join(root, "images", stem + ".jpg"),
                            pixels)
    out = {d: os.path.join(tmp, f"kitti2d_jpg_{d}")
           for d in ("card", "cpu", "api", "api_cpu")}
    launches, cli = kitti2d_cli_on_both(torch, root, out, len(stems), "jpg")
    totals, compared_api = n_checkpoint_on_both(torch, dev, root, out,
                                                len(stems), "jpg")
    for stem, shape in zip(stems, shapes):
        path = os.path.join(out["card"], stem + ".jpg")
        with open(path, "rb") as f:
            if f.read(3) != jpeg.SIGNATURE:
                raise AssertionError(f"{path} is not a JPEG")
        if read_image_rgb(path).shape != shape:
            raise AssertionError(f"{path}: not a {shape} image")
    seconds = time.perf_counter() - t0
    summary = {
        "fixtures": {name: entry["shape"]
                     for name, entry in sorted(record["fixtures"].items())},
        "codec_build_s": build_s,
        "decode_ms_375x1242": decode_ms, "encode_ms_375x1242": encode_ms,
        "timing_reps": JPEG_TIMING_REPS, "twin_decode_ms": twin_ms,
        "kitti2d_images": len(stems), **cli,
        "api_n_checkpoint_totals": totals,
        "api_result_lines_compared": compared_api, "phase_s": seconds,
        "card": smi}
    print(json.dumps({"jpeg": summary}), flush=True)
    if seconds > JPEG_PHASE_LIMIT_S:
        raise AssertionError(f"the JPEG phase took {seconds:.1f} s, over "
                             f"{JPEG_PHASE_LIMIT_S} s")
    phase("JPEG", t0)
    return launches


def check_peak(torch, dev, rng, tables):
    """The peak pass against its twin, float bits equal, on ``tables``
    (the relative decode's (B, D, mh, mw) tables with their boxes and
    validity) and on ``mask_cases``; timed over 20 launches on the
    tables at B = 4 and on the dense case, beside the twin."""
    from lidar_object_detection_tpu_torch.ops import mask_assembly as ma

    cases = {name: tuple(torch.from_numpy(a).to(dev) for a in arrays)
             for name, arrays in mask_cases(rng).items()}
    cases["decode B=4"] = tables
    ops_of = {name: ma.prepare_operands(*args, H0, W0, 0.0)
              for name, args in cases.items()}
    ops_of.update({name: ma.prepare_operands(
        *(torch.from_numpy(a).to(dev) for a in arrays), h, w, 0.0)
        for name, (h, w, arrays) in odd_width_cases(rng).items()})
    compared, positive, err = 0, {}, 0.0
    for name, ops in ops_of.items():
        got = ma.peak_cuda(ops)
        ref = ma.peak_plain(ops)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
            bad = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
            raise AssertionError(f"peak pass: {name}: {bad} peaks differ "
                                 "from the twin")
        err = max(err, float((got - ref).abs().max()))
        compared += got.numel()
        positive[name] = int((got > 0).sum())
    if positive["decode B=4"] == 0 or positive["dense B=4"] == 0:
        raise AssertionError(f"peak check is degenerate: {positive}")

    def timer(ops):
        out = torch.zeros(ops.table.shape[:2], dtype=torch.int32,
                          device=dev)
        return lambda: ma.launch("mask_peak_launch", ops, out)

    main_ops, dense_ops = ops_of["decode B=4"], ops_of["dense B=4"]
    entry = {"name": "mask_peak", "route": "cuda",
             "source": "lidar_object_detection_tpu_torch/csrc/"
                       "mask_assembly.cu",
             "replaces": "lidar_object_detection_tpu/models/yolo/"
                         "postprocess.py:442",
             "max_abs_err": err, "compared": compared, "cases": len(ops_of),
             "ms": time_gpu(timer(main_ops), reps=20),
             "ms_synthetic": time_gpu(timer(dense_ops), reps=20),
             "plain_ms": time_gpu(lambda: ma.peak_plain(main_ops), reps=10,
                                  head_start=False),
             "library_ms": None}
    entry["bound_ms"], entry["bound_by"] = mask_bound(main_ops, True)
    entry["bound_ms_synthetic"], _ = mask_bound(dense_ops, True)
    odd = f"dense B=4 {ODD_SHAPES[0][0]}x{ODD_SHAPES[0][1]}"
    entry["ms_odd_width"] = time_gpu(timer(ops_of[odd]), reps=20)
    entry["bound_ms_odd_width"], _ = mask_bound(ops_of[odd], True)
    entry["kernel_ms"] = entry["ms"]
    print(f"mask_peak: float bits equal to the twin on {len(ops_of)} cases "
          f"({compared} peaks, positive {positive}); decode B=4 "
          f"{entry['ms']:.4f} ms (bound {entry['bound_ms']:.4g} by "
          f"{entry['bound_by']}), dense B=4 {entry['ms_synthetic']:.4f} "
          f"(bound {entry['bound_ms_synthetic']:.4g}), {odd} "
          f"{entry['ms_odd_width']:.4f} (bound "
          f"{entry['bound_ms_odd_width']:.4g}); twin "
          f"{entry['plain_ms']:.4f}", flush=True)
    return entry


def decode_modes_phase(torch, dev, smi, rng):
    """The decode modes the serving path does not run, on the raw outputs
    of the n float32 detector on the committed frames (B = 4, computed
    once on the card): logit at 0.9, relative at 0.5, ``emit_coef`` with
    ``mask_prob_fields`` and ``pack_thresholded_masks``, and the x
    detection-only decode, each decoded on the card and on the CPU: mask
    words equal bit for bit.  The relative decode launches the peak pass
    and K2 once each, and K5; the peak pass is then held to its twin and
    timed (``check_peak``).  Returns (the relative decode's launches, the
    peak pass's entry)."""
    from lidar_object_detection_tpu_torch.models.yolo.detector import (
        YoloDetector)
    from lidar_object_detection_tpu_torch.models.yolo.model import (
        YoloConfig)
    from lidar_object_detection_tpu_torch.models.yolo.postprocess import (
        PostprocessParams, cropped_prob_table, mask_prob_fields,
        pack_thresholded_masks, postprocess_batch)
    from lidar_object_detection_tpu_torch.models.yolo.serving import (
        load_serving_checkpoint)
    from lidar_object_detection_tpu_torch.ops import kernel_lib
    from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

    t0 = time.perf_counter()
    real = [read_png_rgb(path) for path in FRAMES]
    images = np.ascontiguousarray(np.stack(real + [im[:, ::-1]
                                                   for im in real]))
    det, _, _ = load_serving_checkpoint(CKPT, (H0, W0), tta="none",
                                        device=dev)
    outputs = det.forward(images)
    to_cpu = lambda out: {k: [x.cpu() for x in v] if isinstance(v, list)
                          else v.cpu() for k, v in out.items()}
    cpu = to_cpu(outputs)
    modes = {"logit 0.9": dict(mask_upsample="logit", mask_threshold=0.9),
             "relative 0.5": dict(mask_threshold_mode="relative",
                                  mask_threshold=0.5),
             "emit_coef": dict(mask_threshold=0.5, emit_coef=True)}
    expected = {"logit 0.9": {"nms": 1, "mask_assemble": 1},
                "relative 0.5": {"nms": 1, "mask_assemble": 1,
                                 "mask_peak": 1},
                "emit_coef": {"nms": 1, "mask_assemble": 1}}
    stats, launches = {}, {}
    for name, kw in modes.items():
        params = PostprocessParams(spec=det.spec, **kw)
        torch.cuda.synchronize()
        kernel_lib.reset_launches()
        got = postprocess_batch(outputs, params)
        torch.cuda.synchronize()
        launches[name] = dict(kernel_lib.LAUNCHES)
        want = {k: expected[name].get(k, 0) for k in launches[name]}
        if launches[name] != want:
            raise AssertionError(f"{name}: launched {launches[name]}, "
                                 f"expected {want}")
        ref = postprocess_batch(cpu, params)
        if not torch.equal(got["det_valid"].cpu(), ref["det_valid"]):
            raise AssertionError(f"{name}: det_valid differs")
        words = got["mask_bits"].cpu()
        bad = int((words != ref["mask_bits"]).sum())
        if bad:
            raise AssertionError(f"{name}: {bad} mask words differ between "
                                 "the card and the CPU")
        stats[name] = {"words_set": int((words != 0).sum()),
                       "detections": int(ref["det_valid"].sum())}
        if name == "emit_coef":
            if not torch.equal(got["coef"].cpu(), ref["coef"]):
                raise AssertionError("emit_coef: coefficients differ")
            b = 0
            fields = mask_prob_fields(outputs["proto"][b], got["coef"][b],
                                      det.spec)
            fields_cpu = mask_prob_fields(cpu["proto"][b], ref["coef"][b],
                                          det.spec)
            field_err = float((fields.cpu() - fields_cpu).abs().max())
            if field_err > 1e-5:
                raise AssertionError(f"mask_prob_fields: card vs CPU "
                                     f"{field_err}")
            packed = pack_thresholded_masks(fields, got["boxes"][b],
                                            got["det_valid"][b], 0.5)
            packed_cpu = pack_thresholded_masks(fields.cpu(),
                                                ref["boxes"][b],
                                                ref["det_valid"][b], 0.5)
            if not torch.equal(packed.cpu(), packed_cpu):
                raise AssertionError("pack_thresholded_masks: card and CPU "
                                     "differ on the same fields")
            stats[name].update(
                fields_err=field_err,
                dense_vs_kernel_words=int((packed.cpu() != words[b]).sum()))
    if stats["relative 0.5"]["words_set"] == 0 \
            or stats["logit 0.9"]["words_set"] == 0:
        raise AssertionError(f"decode modes are degenerate: {stats}")

    # the x detection-only decode: YOLO11x's detection head at full width
    x_det = YoloDetector((H0, W0), YoloConfig(segment=False), device=dev)
    x_out = x_det.forward(images)
    if sorted(x_out) != ["box", "cls"]:
        raise AssertionError(f"detection head outputs {sorted(x_out)}")
    got = x_det.decode(x_out)
    ref = x_det.decode(to_cpu(x_out))
    if not torch.equal(got["det_valid"].cpu(), ref["det_valid"]) \
            or bool(got["mask_bits"].any()) or bool(ref["mask_bits"].any()):
        raise AssertionError("the x detection-only decode differs")
    x_box_err = float((got["boxes"].cpu() - ref["boxes"]).abs().max())
    if x_box_err > 1e-2:
        raise AssertionError(f"x detection-only boxes: card vs CPU "
                             f"{x_box_err} px")
    stats["x detection-only"] = {"detections": int(ref["det_valid"].sum()),
                                 "box_err": x_box_err}
    del x_det, x_out

    kept = postprocess_batch(outputs, PostprocessParams(spec=det.spec,
                                                         emit_coef=True))
    tables = (cropped_prob_table(outputs["proto"], kept["coef"], det.spec),
              kept["boxes"], kept["det_valid"])
    entry = check_peak(torch, dev, rng, tables)
    print(json.dumps({"decode_modes": {"modes": stats, "launches": launches,
                                       "card": smi}}), flush=True)
    phase("decode modes", t0)
    return launches["relative 0.5"], entry


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
    of the traced wall time and the kernels that took most of it, printed
    and returned (None where the profiler saw no device activity)."""
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
        return None
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
    summary = {"traced_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
               "busy_share": busy / wall_us, "device_kernels": len(kernels),
               "top_kernels_ms": [[n[:90], t / 1e3] for n, t in top]}
    print(json.dumps({"profile": summary}), flush=True)
    return summary


# ---------------------------------------------------------------------------
# the PointPillars tools and the long cloud
# ---------------------------------------------------------------------------

# the surround runner resumes a full checkpoint of the committed SSD
# variables at this step and runs PP_RUNNER_STEPS more
PP_RESUME_STEP, PP_RUNNER_STEPS = 15000, 3
# the diagnosis tool decodes with this many picks a frame
PP_DIAGNOSE_PICKS = 128
# the long cloud: sweeps of this many points each (>= 2^20 in all), and
# K1's edge case past 132 blocks of 32768 points on one frame
LONG_SWEEPS, LONG_SWEEP_POINTS, LONG_MIN_POINTS = 20, 65536, 1 << 20
LONG_EDGE_POINTS = 5 * (1 << 20)


def full_checkpoint(src, dst, step):
    """A full surround-runner checkpoint at ``dst``: ``src``'s variables,
    optax's initial AdamW moments (zeros) with the Adam and schedule
    counts at ``step``, the step, and ``src``'s sidecar."""
    from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
        read_flax_msgpack, write_flax_msgpack)

    variables = read_flax_msgpack(src)["0"]
    zeros = lambda tree: {k: zeros(v) if isinstance(v, dict)
                          else np.zeros_like(v) for k, v in tree.items()}
    count = np.array(step, np.int32)
    write_flax_msgpack(dst, {"0": variables, "1": {
        "0": {"count": count, "mu": zeros(variables["params"]),
              "nu": zeros(variables["params"])},
        "1": {}, "2": {"count": count.copy()}}, "2": count.copy()})
    shutil.copyfile(src + ".json", dst + ".json")


def long_tree(root, rng):
    """A KITTI-360 tree of LONG_SWEEPS frames (100, 101, ...): each sweep
    LONG_SWEEP_POINTS points of one street (``pillars_world``) seen from
    its frame's ego pose, every frame with its cars' boxes, and the first
    frame with a committed camera frame (the stub detector projects its
    boxes into it)."""
    import torch

    from lidar_object_detection_tpu_torch.models.pointpillars import (
        boxes7_to_corners)

    world, cars = pillars_world(rng)
    v2r = VELO_TO_RECT.astype(np.float64)
    corners0 = boxes7_to_corners(torch.from_numpy(cars)).numpy()
    frames = []
    for k in range(LONG_SWEEPS):
        pose = ego_pose(k)
        to_k = np.linalg.inv(pose @ v2r) @ v2r
        pts = world[rng.choice(len(world), LONG_SWEEP_POINTS,
                               replace=False)].copy()
        pts[:, :3] = pts[:, :3] @ to_k[:3, :3].T + to_k[:3, 3]
        to_cam = np.linalg.inv(pose) @ v2r
        cam = corners0 @ to_cam[:3, :3].T + to_cam[:3, 3]
        frames.append((100 + k, FRAMES[0] if k == 0 else None,
                       pts.astype(np.float32), cam.astype(np.float32)))
    write_kitti360_tree(root, frames)


def check_rotated_nms_m128(torch, dev, rng, path):
    """The rotated NMS at the diagnosis tool's M = PP_DIAGNOSE_PICKS
    against its twin (``compare_rotated_nms``): the tool's own candidates
    (``path``: each cached frame's 512 top boxes7, scores and validity at
    its lowest score cut), the same with every candidate valid (the M
    picks all taken), and the seeded heavy overlap; timed at B = 1 on each
    path frame, with the bound of the twin's pairs, and the twin beside."""
    from lidar_object_detection_tpu_torch.ops import rotated_nms as rn

    thr, m = PP_IOU_THRESHOLD, PP_DIAGNOSE_PICKS
    boxes, scores, valid = path
    cases = {"diagnosis path": path,
             "diagnosis path, all valid": (boxes, scores,
                                           torch.ones_like(valid)),
             "heavy overlap": tuple(torch.from_numpy(a).to(dev) for a in
                                    rotated_nms_cases(rng)["heavy overlap"])}
    stats, max_err, min_gap, failed, pairs_of, slow_of = \
        compare_rotated_nms(torch, dev, cases, thr, m)
    if failed or max_err > PP_IOU_TOL:
        raise AssertionError(f"the rotated NMS at M = {m} differs from its "
                             f"twin: {failed}, IoU rows off by up to "
                             f"{max_err}")
    if max(stats["diagnosis path, all valid"]["picks"]) <= 64:
        raise AssertionError(f"M = {m}: no frame took more than 64 picks: "
                             f"{stats}")
    per_frame, bounds = [], []
    for f in range(boxes.shape[0]):
        one = tuple(t[f:f + 1].contiguous() for t in path)
        per_frame.append(time_gpu(rotated_nms_launcher(torch, dev, *one, thr,
                                                       m)))
        _, keep, pairs = rn.rotated_nms_plain(*one, thr, m,
                                              return_pairs=True)
        bounds.append(rotated_nms_bound(int(pairs.sum()), 1, boxes.shape[1],
                                        m, min(m, int(keep.sum()) + 1)))
    mid = int(np.argsort(per_frame)[len(per_frame) // 2])
    one = tuple(t[:1].contiguous() for t in cases["diagnosis path, all "
                                                  "valid"])
    full = time_gpu(rotated_nms_launcher(torch, dev, *one, thr, m))
    out = {"ms_m128": float(np.median(per_frame)),
           "ms_m128_per_frame": per_frame,
           "bound_ms_m128": bounds[mid][0], "bound_by_m128": bounds[mid][1],
           "ms_m128_all_valid": full,
           "plain_ms_m128": time_gpu(
               lambda: rn.rotated_nms_plain(*one, thr, m), reps=3, warmup=1,
               head_start=False),
           "max_abs_err_m128": max_err, "min_gap_m128": min_gap,
           "picks_m128": {k: v["picks"] for k, v in stats.items()},
           "pairs_m128": pairs_of, "ring_routine_pairs_m128": slow_of}
    print(f"rotated NMS at M = {m}: equal to the twin ({out['picks_m128']} "
          f"picks; IoU rows within {max_err:.3g}, smallest deciding gap "
          f"{min_gap:.3g}); the diagnosis path B=1 {out['ms_m128']:.4f} ms "
          f"({per_frame}; bound {out['bound_ms_m128']:.3g} by "
          f"{out['bound_by_m128']}), all valid {full:.4f}; twin "
          f"{out['plain_ms_m128']:.3f} ms", flush=True)
    return out


def check_runner_pairs(torch, dev, batch):
    """The assigner's IoU kernel against its twin on the surround runner's
    own candidate pairs (the first timed step's batch: 4 augmented frames,
    the surround grid's anchors, each valid GT's top candidates): IoUs
    within PP_IOU_TOL, 0 for invalid GTs."""
    from lidar_object_detection_tpu_torch.models.pointpillars import (
        PillarsConfig, anchor_grid)
    from lidar_object_detection_tpu_torch.models.pointpillars.loss import (
        iou_bound, top_candidates)
    from lidar_object_detection_tpu_torch.ops import rotated_iou_pairs as rip

    gt = torch.from_numpy(batch[2]).to(dev)
    gv = torch.from_numpy(batch[4]).to(dev)
    anchors = anchor_grid(PillarsConfig.kitti360_surround(),
                          dev).reshape(-1, 7)
    idx = top_candidates(iou_bound(anchors, gt))
    got = rip.rotated_iou_pairs_cuda(anchors, idx, gt, gv)
    ref = torch.where(gv[..., None],
                      rip.rotated_iou_pairs_plain(anchors, idx, gt), 0.0)
    err = float((got - ref).abs().max())
    out = {"pairs": idx.numel(), "valid_gt": int(gv.sum()),
           "max_abs_err": err, "over 0.6": int((got >= 0.6).sum())}
    if err > PP_IOU_TOL or not torch.isfinite(got).all():
        raise AssertionError(f"the assigner's IoU kernel on the runner's "
                             f"pairs differs from its twin: {out}")
    print(f"the assigner's IoU kernel on the surround runner's pairs: equal "
          f"to the twin ({out})", flush=True)
    return out


def check_long_k1(torch, dev, operands):
    """K1 on the long cloud's own operands (one frame, P >= 2^20, from
    ``fuse_frame`` on the card) and on those points tiled to
    LONG_EDGE_POINTS (more than 132 blocks of 32768): counts and totals
    equal to the twin's; timed at the first, with its bound and the
    twin's time."""
    from lidar_object_detection_tpu_torch.ops.inside_counts import (
        inside_counts_cuda, inside_counts_plain)

    pts, bits, corners, mask = operands
    reps = -(-LONG_EDGE_POINTS // pts.shape[1])
    cases = {"long cloud": operands,
             "tiled past 132 blocks": (
                 pts.repeat(1, reps, 1)[:, :LONG_EDGE_POINTS].contiguous(),
                 bits.repeat(1, reps)[:, :LONG_EDGE_POINTS].contiguous(),
                 corners, mask)}
    out = {}
    for name, (p, b, c, m) in cases.items():
        got = inside_counts_cuda(p, b, c, m, D)
        ref = inside_counts_plain(p, b, c, m, D)
        for g, r, what in zip(got, ref, ("counts", "totals")):
            if not torch.equal(g, r):
                raise AssertionError(f"K1 {what} differ from the twin on "
                                     f"the {name} ({p.shape[1]} points): "
                                     f"{int((g != r).sum())} entries")
        out[name] = {"points": int(p.shape[1]),
                     "active": int((b != 0).sum()),
                     "total": int(got[1].sum())}
    active, pairs, (bound, by) = k1_bound(pts, bits, corners, mask)
    ms = time_gpu(k1_launcher(torch, dev, pts, bits, corners, mask))
    plain = time_gpu(lambda: inside_counts_plain(pts, bits, corners, mask,
                                                 D), reps=5, warmup=1,
                     head_start=False)
    print(f"K1 on the long cloud: equal to the twin ({out}); "
          f"{ms:.4f} ms at P = {pts.shape[1]} ({active} active points, "
          f"{pairs} pairs; bound {bound:.3g} by {by}); twin {plain:.3f} ms",
          flush=True)
    return {"ms_longcloud": ms, "bound_ms_longcloud": bound,
            "bound_by_longcloud": by, "plain_ms_longcloud": plain,
            "longcloud_cases": out, "max_abs_err_longcloud": 0}


def pillars_tools_phase(torch, dev, smi, tmp, rng):
    """The PointPillars tools and the long cloud on the card, each stage
    timed by ``utils.profiling.StageTimer``, counters zeroed before each
    run and read after it:

    * the surround runner (``pipelines.pillars_surround``) at the full
      surround grid, ``--subsample=65536``, 4 frames a step, on
      ``pillars_tree``'s street, resumed from a full checkpoint of the
      committed SSD variables at step PP_RESUME_STEP (optax's initial
      moments) for PP_RUNNER_STEPS steps, then its evaluation of the 4
      frames; run twice, the checkpoints, sidecars and caches byte-equal
      and the reports equal but for ``elapsed_s``; the second run's steps
      and evaluation timed, and the assigner's IoU kernel held to its
      twin on its first step's pairs;
    * the gate (``pipelines.pillars_gate``) on both committed checkpoints
      on the card and on the CPU: the same JSON line;
    * the diagnosis tool on the runner's checkpoint and cache, then the
      rotated NMS at M = 128 on its candidates against the twin;
    * ``pipelines.longcloud`` on a LONG_SWEEPS-sweep aggregate of at least
      2^20 points, and K1 on its operands against the twin.

    Returns the runs' launches, the rotated NMS's and K1's entries, and a
    summary."""
    from lidar_object_detection_tpu_torch.models.pointpillars import (
        PillarsConfig, PillarsTrainer, decode_predictions)
    from lidar_object_detection_tpu_torch.models.pointpillars import (
        decode as pdecode)
    from lidar_object_detection_tpu_torch.ops import kernel_lib
    from lidar_object_detection_tpu_torch.parallel.optim import (
        cosine_decay_schedule)
    from lidar_object_detection_tpu_torch.pipelines import (
        longcloud, pillars_diagnose, pillars_gate, pillars_surround)
    from lidar_object_detection_tpu_torch.pipelines import pointpillars as pp
    from lidar_object_detection_tpu_torch.utils.profiling import StageTimer

    t0 = time.perf_counter()
    # the runs, and apart from them the second runner run's parts
    timer, parts = StageTimer(), StageTimer()
    root = os.path.join(tmp, "pp_tools_kitti360")
    pillars_tree(root, np.random.default_rng(4))
    zero = {k: 0 for k in kernel_lib.LAUNCHES}
    launches, summary = {}, {}

    def counted(name, argv, entry, want):
        torch.cuda.synchronize()
        kernel_lib.reset_launches()
        with timer.stage(name) as h:
            text = run_cli(argv, entry)
            h.append(torch.ones(1, device=dev))
        launches[name] = dict(kernel_lib.LAUNCHES)
        if want is not None and launches[name] != dict(zero, **want):
            raise AssertionError(f"{name} launched {launches[name]}, "
                                 f"expected {want}")
        return text

    # the runner, twice; the second run's steps and evaluation timed
    steps = PP_RESUME_STEP + PP_RUNNER_STEPS
    n = len(PP_FRAMES)
    runs = {}
    real_step, real_eval = PillarsTrainer.train_step, \
        pillars_surround.evaluate
    first_batch = []
    for run in ("runner", "runner_again"):
        d = os.path.join(tmp, f"pp_tools_{run}")
        os.makedirs(d)
        ckpt = os.path.join(d, "ckpt.msgpack")
        full_checkpoint(PP_CKPTS["ssd"], ckpt, PP_RESUME_STEP)
        report = os.path.join(d, "report.json")
        if run == "runner_again":
            def timed_step(self, *batch):
                if not first_batch:
                    first_batch.extend(batch)
                with parts.stage("runner step") as h:
                    m = real_step(self, *batch)
                    h.append(m)
                return m

            def timed_eval(*args, **kwargs):
                with parts.stage("runner evaluation") as h:
                    out = real_eval(*args, **kwargs)
                    h.append(torch.ones(1, device=dev))
                return out
            PillarsTrainer.train_step = timed_step
            pillars_surround.evaluate = timed_eval
        try:
            text = counted(run, [str(steps), report, f"--dataset={root}",
                                 f"--ckpt={ckpt}",
                                 f"--cache={os.path.join(d, 'frames.npz')}",
                                 f"--device={dev}"],
                           pillars_surround.main,
                           {"rotated_iou_pairs": PP_RUNNER_STEPS,
                            "rotated_nms": n})
        finally:
            PillarsTrainer.train_step = real_step
            pillars_surround.evaluate = real_eval
        if f"resumed from {ckpt} at step {PP_RESUME_STEP}" not in text:
            raise AssertionError(f"the {run} did not resume at "
                                 f"{PP_RESUME_STEP}")
        with open(report) as f:
            rep = json.load(f)
        (entry,) = rep["chunks"]
        if entry["step"] != steps or not np.isfinite(entry["loss"]):
            raise AssertionError(f"the {run}'s report: {entry}")
        entry.pop("elapsed_s")
        runs[run] = {"dir": d, "report": rep, "ckpt": ckpt}
    if runs["runner"]["report"] != runs["runner_again"]["report"]:
        raise AssertionError(f"the runner's reports differ: {runs}")
    for name in ("ckpt.msgpack", "ckpt.msgpack.json", "frames.npz"):
        if read_bytes(os.path.join(runs["runner"]["dir"], name)) != \
                read_bytes(os.path.join(runs["runner_again"]["dir"], name)):
            raise AssertionError(f"the runner's second run wrote another "
                                 f"{name}")
    summary["runner"] = runs["runner"]["report"]["chunks"][0]
    summary["runner_pairs"] = check_runner_pairs(torch, dev, first_batch)
    print(f"surround runner: resumed at {PP_RESUME_STEP}, {PP_RUNNER_STEPS} "
          f"steps, twice the same checkpoint, sidecar, cache and report "
          f"({summary['runner']})", flush=True)

    # the gate on both committed checkpoints, on the card and on the CPU
    gate = {}
    for head, ckpt in PP_CKPTS.items():
        argv = [ckpt, "--dataset", root, "--head", head, "--min-recall", "0"]
        if head == "ssd":
            argv += ["--score-threshold", str(PP_SSD_THRESHOLD)]
        card = counted(f"gate_{head}", argv + ["--device", str(dev)],
                       pillars_gate.main,
                       {"rotated_nms": n} if head == "ssd" else {})
        with timer.stage(f"gate_{head} on the CPU"):
            cpu = run_cli(argv + ["--device", "cpu"], pillars_gate.main)
        line = card.splitlines()[-2]
        if line != cpu.splitlines()[-2] or not card.endswith(
                "PASS: recall " + json.loads(line)["recall"].split("/")[0]
                + " >= 0\n"):
            raise AssertionError(f"the {head} gate on the card printed "
                                 f"{card!r}, on the CPU {cpu!r}")
        gate[head] = json.loads(line)
    summary["gate"] = gate

    # the diagnosis on the runner's checkpoint, then its decode's rotated
    # NMS at M = 128 against the twin, on the same candidates
    runner_dir = runs["runner"]["dir"]
    cache = os.path.join(runner_dir, "frames.npz")
    text = counted("diagnose", [f"--ckpt={runs['runner']['ckpt']}",
                                f"--cache={cache}", f"--device={dev}"],
                   pillars_diagnose.main, {"rotated_nms": 4 * n})
    if f"checkpoint step {steps}" not in text:
        raise AssertionError(f"the diagnosis printed {text!r}")
    summary["diagnose"] = text.splitlines()[1:10]
    cfg = PillarsConfig.kitti360_surround()
    trainer = PillarsTrainer(cfg, learning_rate=cosine_decay_schedule(
        2e-3, 1000), device=dev)
    pp.restore_pillars_checkpoint(runs["runner"]["ckpt"], trainer)
    with np.load(cache) as z:
        frames = [(z[f"p{i}"], z[f"b{i}"]) for i in range(int(z["n"]))]
    e_pts, e_pv, _, _, _ = pp.pack_frames(frames, 1 << 18)
    out = trainer.apply(e_pts, e_pv)
    cands = []
    for i in range(len(frames)):
        with torch.no_grad():
            boxes7, _, top_idx, top_scores, cand_valid = \
                pdecode.decode_candidates({k: v[i] for k, v in out.items()},
                                          cfg, 0.05)
        cands.append((boxes7[top_idx], top_scores, cand_valid))
    path = tuple(torch.stack(t).contiguous() for t in zip(*cands))
    del trainer, out
    rotated = check_rotated_nms_m128(torch, dev, rng, path)

    # the long cloud
    long_root = os.path.join(tmp, "longcloud_kitti360")
    with timer.stage("long tree"):
        long_tree(long_root, np.random.default_rng(5))
    text = counted("longcloud", ["--dataset", long_root, "--frame", "100",
                                 "--sweeps", str(LONG_SWEEPS), "--iters",
                                 "5", "--min-points", str(LONG_MIN_POINTS),
                                 "--device", str(dev)],
                   longcloud.main, {"inside_counts": 7})
    line = json.loads(text.splitlines()[-1])
    if line["points"] < LONG_MIN_POINTS or line["detections_points"] <= 0:
        raise AssertionError(f"the long cloud: {line}")
    if text.splitlines()[-2] != f"[longcloud] {smi}":
        raise AssertionError(f"the long cloud named {text.splitlines()[-2]}")
    operands, _ = longcloud.fuse_operands(long_root, 100, LONG_SWEEPS,
                                          LONG_MIN_POINTS, dev)
    with torch.inference_mode():
        fused = longcloud.fuse_frame(*operands)
        plain = longcloud.fuse_frame(*operands[:-1], dataclasses.replace(
            operands[-1], count_impl="plain"))
    for key in ("counts", "total_points", "best_box", "points_inside"):
        if not torch.equal(fused[key], plain[key]):
            raise AssertionError(f"the long cloud's {key} differ from the "
                                 f"run with the plain inside-count")
    if int(fused["total_points"].sum()) != line["detections_points"]:
        raise AssertionError(f"the long cloud's total differs from {line}")
    k1 = check_long_k1(torch, dev, (
        operands[0][None, :, :3].contiguous(),
        fused["point_bits"][None].contiguous(),
        fused["corners_velo"][None].contiguous(),
        fused["box_visible"][None].contiguous()))
    summary["longcloud"] = line
    print(f"[stages] PointPillars tools and the long cloud, "
          f"utils.profiling.StageTimer:\n{timer.report()}\n[stages] the "
          f"second runner run's parts:\n{parts.report()}", flush=True)
    summary["stage_ms"] = {k: v * 1e3 for t in (timer, parts)
                           for k, v in t.times.items()}
    summary["stage_counts"] = {**timer.counts, **parts.counts}
    print(json.dumps({"pillars_tools": summary, "card": smi}), flush=True)
    phase("PointPillars tools and the long cloud", t0)
    return launches, rotated, k1, summary


# ---------------------------------------------------------------------------
# the serving-quality protocol, the regeneration, the oracle, yolo-export
# ---------------------------------------------------------------------------

# the x runs: each subcommand's argv, and what it should launch (a
# decode: K5; an absolute cut: K2; a guarded one: K3 then K2; a relative
# one: the peak pass then K2; the mirrored view alone: K5 and no mask
# kernel; each configuration's two fusions: K1 twice)
QUALITY_X_RUNS = {
    "knob-sweep": (["--mask-thr", "0.5", "0.99", "--thr-mode", "absolute",
                    "relative", "--guarded-grid", "0.99:0.5:200",
                    "--tta-grid", "0.99:0.5:200"],
                   {"nms": 6, "mask_assemble": 6, "mask_count": 2,
                    "mask_peak": 2, "inside_counts": 12}),
    "threshold-cv": (["--mask-thr", "0.5", "0.99", "--guarded-grid",
                      "0.99:0.5:200", "--tta-grid", "0.99:0.5:200"],
                     {"nms": 4, "mask_assemble": 4, "mask_count": 2,
                      "inside_counts": 8}),
    "flip-probe": ([], {"nms": 6, "mask_assemble": 4, "mask_count": 2,
                        "inside_counts": 12}),
    "imgsz-probe": (["--imgsz", "640", "1408", "--mask-thr", "0.99"],
                    {"nms": 4, "mask_assemble": 4, "mask_count": 2,
                     "inside_counts": 8}),
}
# the n runs, on the card twice and on the CPU once, on the light tree:
# every kind of decode once (absolute, relative, guarded, the mirrored
# view alone, the hflip consensus) at the fewest configurations that run
# each subcommand, since a configuration's twins take seconds on the CPU
QUALITY_N_RUNS = {
    "knob-sweep": (["--mask-thr", "0.99", "--thr-mode", "relative",
                    "--guarded-grid", "0.99:0.5:200"],
                   {"nms": 2, "mask_assemble": 2, "mask_count": 1,
                    "mask_peak": 1, "inside_counts": 4}),
    "threshold-cv": (["--mask-thr", "0.5", "0.99"],
                     {"nms": 2, "mask_assemble": 2, "inside_counts": 4}),
    "flip-probe": (["--configs", "0.99:0.5:200"],
                   {"nms": 3, "mask_assemble": 2, "mask_count": 2,
                    "inside_counts": 6}),
    "imgsz-probe": (["--imgsz", "640", "1408", "--mask-thr", "0.99",
                     "--guarded"],
                    {"nms": 2, "mask_assemble": 2, "inside_counts": 4}),
}
# the light tree's frames (the two committed camera frames, frame 100
# first) and boxes a frame: the GT boxes behind the detections come
# first in a scene, then scattered ones
QUALITY_LIGHT_FRAMES = 2
QUALITY_LIGHT_BOXES = 40
# the regeneration with the n checkpoint at its sidecar point (hflip,
# guarded): six detections (the study, the two master CSVs, the depth
# maps, the overlays, V5), six fusions, V5's solver once
REGEN_LAUNCHES = {"nms": 6, "mask_assemble": 6, "mask_count": 6,
                  "inside_counts": 6, "lap": 1}
# card against CPU: the payloads' percentages (2 decimals) and the
# summaries' means, in percentage points, where a mask word may differ
QUALITY_PCT_TOL = 0.1
# card against CPU: the share of a fusion's mask words that may differ (a
# word is one pixel's 32 detection bits; the card read 9.4e-7, one word in
# 1.06 M, on the light tree's 2 x 376 x 1408 pixels): about ten words
QUALITY_WORD_SHARE = 1e-5
QUALITY_TIMINGS = ("sweep_s", "config_s", "forward_s")


def strip_timings(payload):
    """A quality payload without its wall-clock fields."""
    if isinstance(payload, dict):
        return {k: strip_timings(v) for k, v in payload.items()
                if k not in QUALITY_TIMINGS}
    if isinstance(payload, list):
        return [strip_timings(v) for v in payload]
    return payload


def same_quality_rows(got, ref, what):
    """Result rows of two payloads of one subcommand (any order): the same
    configurations, matched cars exact, percentages within
    QUALITY_PCT_TOL."""
    configs = ("conf", "mask_threshold", "mask_threshold_floor", "floor",
               "config")
    key = lambda r: json.dumps({k: v for k, v in r.items()
                                if not isinstance(v, float) or k in configs},
                               sort_keys=True)
    got, ref = strip_timings(got), strip_timings(ref)
    got, ref = sorted(got, key=key), sorted(ref, key=key)
    if [key(r) for r in got] != [key(r) for r in ref]:
        raise AssertionError(f"{what}: configurations or matched cars "
                             f"differ: {got} against {ref}")
    err = 0.0
    for g, r in zip(got, ref):
        for k, v in r.items():
            if isinstance(v, float) and k not in configs:
                err = max(err, abs(g[k] - v))
    if err > QUALITY_PCT_TOL:
        raise AssertionError(f"{what}: percentages differ by {err} "
                             f"> {QUALITY_PCT_TOL}")
    return err


class FusionLog:
    """Records every fusion's frame ids and detections (validity and mask
    words, on the host), by wrapping ``FusionPipeline.fuse``; with
    ``quality``, also the joined rows of each configuration a quality
    study decodes, by wrapping ``quality._joined_rows``: ``configs`` holds
    (the configuration's last fusion, its rows as tuples)."""

    def __init__(self, quality=None):
        from lidar_object_detection_tpu_torch.pipelines import runner

        self.runner, self.quality = runner, quality
        self.fusions, self.configs, self.restore = [], [], []

    def __enter__(self):
        pipeline = self.runner.FusionPipeline
        real_fuse = pipeline.fuse

        def fuse(pipe, batch, detections):
            self.fusions.append(([int(f) for f in batch.frame_ids],
                                 detections["det_valid"].cpu(),
                                 detections["mask_bits"].cpu()))
            return real_fuse(pipe, batch, detections)
        self.restore.append((pipeline, "fuse", real_fuse))
        pipeline.fuse = fuse
        if self.quality is not None:
            real_joined = self.quality._joined_rows

            def joined(ctx, detections):
                rows = real_joined(ctx, detections)
                self.configs.append((self.fusions[-1], [
                    dataclasses.astuple(r) for r in rows]))
                return rows
            self.restore.append((self.quality, "_joined_rows", real_joined))
            self.quality._joined_rows = joined
        return self

    def __exit__(self, *exc):
        for owner, name, real in reversed(self.restore):
            setattr(owner, name, real)
        self.restore = []


def differing_detections(torch, card, cpu, what):
    """Card against CPU, fusion by fusion (FusionLog.fusions): the same
    frames and validity, and at most QUALITY_WORD_SHARE of the mask words
    different (a pixel within float32 rounding of its cut).  Returns the
    (frame, detection) pairs whose mask differs in some fusion and the
    largest word-mismatch share."""
    if len(card) != len(cpu):
        raise AssertionError(f"{what}: {len(card)} fusions on the card, "
                             f"{len(cpu)} on the CPU")
    differ, worst = set(), 0.0
    for i, ((cf, cv, cw), (pf, pv, pw)) in enumerate(zip(card, cpu)):
        share = float((cw != pw).float().mean())
        if cf != pf or not torch.equal(cv, pv) or share > QUALITY_WORD_SHARE:
            raise AssertionError(
                f"{what}: fusion {i}: card and CPU detections differ "
                f"(frames {cf} / {pf}, validity equal {torch.equal(cv, pv)}"
                f", word mismatch share {share} > {QUALITY_WORD_SHARE})")
        for b, frame in enumerate(cf):
            xor = cw[b] ^ pw[b]
            for word in xor[xor != 0].unique().tolist():
                differ.update((frame, d) for d in range(cv.shape[1])
                              if (word >> d) & 1)
        worst = max(worst, share)
    return differ, worst


def same_rows_where_equal(card, cpu, differ, what):
    """Per-car rows (frame and detection first) of the detections outside
    ``differ``: the same rows on both sides, every count exact.  Returns
    how many rows were held."""
    def held(rows):
        return sorted(tuple(r) for r in rows
                      if (int(r[0]), int(r[1])) not in differ)
    if held(card) != held(cpu):
        raise AssertionError(f"{what}: the rows of the detections whose "
                             f"words are equal differ: {held(card)} against "
                             f"{held(cpu)}")
    return len(held(card))


def compare_logged(torch, card, cpu, what):
    """Card against CPU, configuration by configuration (FusionLog.
    configs): where every detection is equal the joined rows must be
    equal; elsewhere the detections may differ only as
    ``differing_detections`` allows, and the rows of the detections whose
    words are equal must be equal.  Returns (equal configurations,
    configurations, the largest word-mismatch share)."""
    if len(card) != len(cpu):
        raise AssertionError(f"{what}: {len(card)} configurations on the "
                             f"card, {len(cpu)} on the CPU")
    equal, worst = 0, 0.0
    for i, ((cfused, crows), (pfused, prows)) in enumerate(zip(card, cpu)):
        differ, share = differing_detections(
            torch, [cfused], [pfused], f"{what}: configuration {i}")
        same_rows_where_equal(crows, prows, differ,
                              f"{what}: configuration {i}")
        equal += not differ
        worst = max(worst, share)
    return equal, len(card), worst


def same_summary(got, ref, slack, what):
    """Two run or study summaries: car counts exact, point totals within
    ``slack`` points (those of the detections whose words differ),
    percentages within QUALITY_PCT_TOL."""
    if set(got) != set(ref):
        raise AssertionError(f"{what}: keys {sorted(got)} / {sorted(ref)}")
    for k, v in ref.items():
        if k.startswith("total_") and k != "total_cars":
            tol = slack
        else:
            tol = QUALITY_PCT_TOL if isinstance(v, float) else 0
        if abs(got[k] - v) > tol:
            raise AssertionError(f"{what}: {k} {got[k]} against {v} "
                                 f"(tolerance {tol})")


def run_quality(quality, argv, device, log=None):
    """One quality subcommand in this process: (payload, printed text)."""
    out = argv[argv.index("--out") + 1]
    buf = io.StringIO()
    with contextlib.ExitStack() as stack:
        if log is not None:
            stack.enter_context(log)
        stack.enter_context(contextlib.redirect_stdout(buf))
        code = quality.main(argv + ["--device", str(device)])
    if code != 0:
        raise AssertionError(f"{argv} exited {code}")
    with open(out) as f:
        return json.load(f), buf.getvalue()


def check_quality_tables(torch, dev, tables, thr, floor, min_pixels):
    """K3, K2 and the peak pass against their twins on the quality
    study's (B, D, mh, mw) tables at imgsz 1408, with their boxes and
    validity: counts and words equal (K2 with the plain cut and with the
    guard), peaks' float bits equal; each timed beside its twin, with its
    bound.  Returns {kernel: entry fields}."""
    from lidar_object_detection_tpu_torch.ops import mask_assembly as ma

    ops = ma.prepare_operands(*tables, H0, W0, thr)
    counts = ma.count_above_cuda(ops)
    if not torch.equal(counts, ma.count_above_plain(ops)):
        raise AssertionError("K3 differs from its twin on the imgsz-1408 "
                             "tables")
    guard = ma.Guard(counts, floor, min_pixels)
    words_set = 0
    for g in (None, guard):
        words = ma.assemble_masks_cuda(ops, g)
        if not torch.equal(words, ma.assemble_masks_plain(ops, g)):
            raise AssertionError("K2 differs from its twin on the "
                                 "imgsz-1408 tables")
        words_set += int((words != 0).sum())
    peak_ops = ma.prepare_operands(*tables, H0, W0, 0.0)
    peaks = ma.peak_cuda(peak_ops)
    if not torch.equal(peaks.view(torch.int32),
                       ma.peak_plain(peak_ops).view(torch.int32)):
        raise AssertionError("the peak pass differs from its twin on the "
                             "imgsz-1408 tables")
    if words_set == 0 or int((peaks > 0).sum()) == 0:
        raise AssertionError("the imgsz-1408 table check is degenerate")
    out = torch.empty((ops.table.shape[0], H0, W0), dtype=torch.int32,
                      device=dev)
    cnt = torch.zeros(ops.table.shape[:2], dtype=torch.int32, device=dev)
    timers = {
        "mask_count": (lambda: ma.launch("mask_count_launch", ops, cnt),
                       lambda: ma.count_above_plain(ops), ops, True),
        "mask_assemble": (
            lambda: ma.launch("mask_assemble_launch", ops, out, guard),
            lambda: ma.assemble_masks_plain(ops, guard), ops, False),
        "mask_peak": (lambda: ma.launch("mask_peak_launch", peak_ops, cnt),
                      lambda: ma.peak_plain(peak_ops), peak_ops, True)}
    fields = {}
    for name, (kernel, plain, o, count) in timers.items():
        bound, by = mask_bound(o, count)
        fields[name] = {"ms_imgsz1408": time_gpu(kernel),
                        "bound_ms_imgsz1408": bound,
                        "bound_by_imgsz1408": by,
                        "plain_ms_imgsz1408": time_gpu(
                            plain, reps=10, head_start=False),
                        "max_abs_err_imgsz1408": 0,
                        "table_imgsz1408": list(ops.table.shape)}
    print(f"imgsz-1408 tables {list(ops.table.shape)}: K3, K2 (plain cut "
          f"and guard) and the peak pass equal to their twins; " + "; ".join(
              f"{k} {v['ms_imgsz1408']:.4f} ms (bound "
              f"{v['bound_ms_imgsz1408']:.4g} by {v['bound_by_imgsz1408']}"
              f", twin {v['plain_ms_imgsz1408']:.4f})"
              for k, v in fields.items()), flush=True)
    return fields


def check_quality_k1(torch, dev, ctx, detections):
    """K1 against its twin on a quality configuration's operands (the
    eroded run's point words, boxes and visibility of the study's 4
    scans), equal to the fusion's own counts; timed with its bound."""
    from lidar_object_detection_tpu_torch.ops.inside_counts import (
        inside_counts_cuda, inside_counts_plain)

    pipe = ctx.pipe_ero
    records = pipe.dataset.load_frames()
    batch = pipe.dataset.make_batch(records)
    fused = pipe.fuse(batch, detections)
    ops = (torch.from_numpy(batch.points[..., :3]).to(dev).contiguous(),
           fused["point_bits"].contiguous(),
           fused["corners_velo"].contiguous(),
           fused["box_visible"].contiguous())
    got = inside_counts_cuda(*ops, D)
    ref = inside_counts_plain(*ops, D)
    for g, r, what in zip(got, ref, ("counts", "totals")):
        if not torch.equal(g, r):
            raise AssertionError(f"K1 {what} differ from the twin on the "
                                 "quality run's operands")
    if not torch.equal(got[0], fused["counts"]) or int(got[1].sum()) == 0:
        raise AssertionError("K1 on the quality operands: not the "
                             "fusion's counts, or no point counted")
    active, pairs, (bound, by) = k1_bound(*ops)
    return {"ms_quality": time_gpu(k1_launcher(torch, dev, *ops)),
            "bound_ms_quality": bound, "bound_by_quality": by,
            "plain_ms_quality": time_gpu(
                lambda: inside_counts_plain(*ops, D), reps=5, warmup=1,
                head_start=False),
            "max_abs_err_quality": 0,
            "quality_operands": {"points": int(ops[0].shape[1]),
                                 "active": active, "pairs": pairs}}


REGEN_CSVS = ("master_car_statistics.csv", "master_car_statistics_raw.csv")


def regen_rows(d, name):
    """A regeneration's CSV lines, a master CSV's without its timestamp."""
    lines = read_bytes(os.path.join(d, name)).decode().splitlines()
    return [line.rsplit(",", 1)[0] for line in lines] if name in REGEN_CSVS \
        else lines


def regen_files(d):
    """What a regeneration writes but its pictures, timestamps aside: the
    summary, the CSVs and the workbook's parts."""
    import zipfile

    with zipfile.ZipFile(os.path.join(d, "master_car_statistics.csv.xlsx")) \
            as z:
        book = [(n, z.read(n)) for n in z.namelist()]
    return (read_bytes(os.path.join(d, "summary.json")), book,
            [regen_rows(d, n) for n in ("erosion_study.csv", *REGEN_CSVS)])


def regen_pictures(d):
    return {sub: {n: read_bytes(os.path.join(d, sub, n))
                  for n in sorted(os.listdir(os.path.join(d, sub)))}
            for sub in ("depth_maps", "seg_overlays")}


def same_regeneration(torch, card, cpu, card_fusions, cpu_fusions):
    """The regenerations in ``card`` and ``cpu`` against each other, from
    the detections each fused (FusionLog.fusions): from equal detections
    the same files (regen_files); else the detections may differ only as
    ``differing_detections`` allows, the rows of the detections whose
    words are equal are exact in the study's CSV and both master CSVs,
    and their summaries agree as ``same_summary`` says, with the rest of
    ``summary.json`` equal.  Returns (detections equal, the largest
    word-mismatch share)."""
    differ, share = differing_detections(torch, card_fusions, cpu_fusions,
                                         "regeneration")
    if not differ:
        if regen_files(card) != regen_files(cpu):
            raise AssertionError("the regeneration on the card and on the "
                                 "CPU wrote other files from the same "
                                 "detections")
        return True, share
    sums = [json.loads(read_bytes(os.path.join(d, "summary.json")))
            for d in (card, cpu)]
    slack = {}
    for name, key in (("erosion_study.csv", "erosion_study"),
                      (REGEN_CSVS[0], "csv_eval"),
                      (REGEN_CSVS[1], "no_erosion")):
        got, ref = ([r.split(",") for r in regen_rows(d, name)[1:]]
                    for d in (card, cpu))
        same_rows_where_equal(got, ref, differ, f"regeneration {name}")
        # a master CSV's fourth column is the car's points
        slack[key] = max(sum(int(r[3]) for r in side
                             if (int(r[0]), int(r[1])) in differ)
                         for side in (got, ref)) if name in REGEN_CSVS else 0
        same_summary(sums[0][key], sums[1][key], slack[key],
                     f"regeneration {key}")
    rest = [{k: v for k, v in d.items() if k not in slack} for d in sums]
    if rest[0] != rest[1]:
        raise AssertionError(f"regeneration summary: {rest[0]} against "
                             f"{rest[1]}")
    return False, share


def quality_phase(torch, dev, smi, tmp, images, scenes):
    """The serving-quality protocol and the YOLO-side tools on the card,
    from a KITTI-360 tree of the main path's 4 frames (frame 100 first)
    at 376 x 1408, counters zeroed before each run and read after it:

    * YOLO11x-seg (the committed x checkpoint, float32 as the protocol
      serves it) through ``pipelines.quality``: ``knob-sweep`` (two plain
      cuts, absolute and relative, a guarded and an hflip-TTA point),
      ``threshold-cv`` over that grid, ``flip-probe`` and ``imgsz-probe
      --imgsz 640 1408``, each launching what QUALITY_X_RUNS says;
    * the x forward at 640 and 1408 (CUDA events), a configuration's
      decode and both fusions (host clock, synchronised), K3, K2 and the
      peak pass on the imgsz-1408 tables and K1 on a configuration's
      operands against their twins;
    * ``forward_times --top-ops`` of the n serving forward on the card:
      a positive op total and K5 or K2 among the listed kernels;
    * on a light tree (frames 100 and 101, QUALITY_LIGHT_BOXES boxes a
      frame), YOLO11n-seg through the four subcommands (QUALITY_N_RUNS)
      twice on the card, the payloads equal but for the timings, and on
      the CPU (``compare_logged``): at most QUALITY_WORD_SHARE of the
      words different, the rows of the detections whose words are equal
      exact, and the payloads' matched cars equal and percentages within
      QUALITY_PCT_TOL;
    * on the light tree, ``pipelines.regen_artifacts`` with the n
      checkpoint twice on the card (the same CSV rows but for the
      timestamps, summary, workbook parts, overlays and depth maps) and
      on the CPU (``same_regeneration``, from the detections each run
      fused), timed;
      ``yolo_distill --eval-targets`` on its label cache, card and CPU
      the same lines; ``yolo-export`` of the committed n checkpoint,
      served back through ``run --weights``.

    Returns (launches by run, kernel entry fields, a summary)."""
    from lidar_object_detection_tpu_torch.models.yolo.postprocess import (
        PostprocessParams, cropped_prob_table, postprocess_batch)
    from lidar_object_detection_tpu_torch.ops import kernel_lib
    from lidar_object_detection_tpu_torch.pipelines import (
        quality, regen_artifacts, yolo_distill)
    from lidar_object_detection_tpu_torch.tools import forward_times
    from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
        read_flax_msgpack)

    t0 = time.perf_counter()
    root = quality_tree(os.path.join(tmp, "quality_kitti360"), images,
                        scenes)
    light = quality_tree(os.path.join(tmp, "quality_light"), images, [
        (points, pvalid, corners,
         bvalid & (np.cumsum(bvalid) <= QUALITY_LIGHT_BOXES))
        for points, pvalid, corners, bvalid in
        scenes[:QUALITY_LIGHT_FRAMES]])
    zero = {k: 0 for k in kernel_lib.LAUNCHES}
    launches, times, summary = {}, {}, {}

    def counted(name, fn, want):
        torch.cuda.synchronize()
        kernel_lib.reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name + "_s"] = time.perf_counter() - t
        launches[name] = dict(kernel_lib.LAUNCHES)
        if launches[name] != dict(zero, **want):
            raise AssertionError(f"{name} launched {launches[name]}, "
                                 f"expected {want}")
        return out

    # YOLO11x-seg through the four subcommands
    x_payloads = {}
    for cmd, (flags, want) in QUALITY_X_RUNS.items():
        argv = [cmd, "--ckpt", CKPT_X, "--dataset", root, "--out",
                os.path.join(tmp, f"x_{cmd}.json"), *flags]
        payload, _ = counted(f"x_{cmd}", lambda argv=argv: run_quality(
            quality, argv, dev), want)
        x_payloads[cmd] = payload
        rows = payload.get("results") or payload.get("insample")
        if not rows or min(r["matched_cars"] for r in rows) == 0:
            raise AssertionError(f"x {cmd}: no matched car in {payload}")
    summary["x"] = {cmd: strip_timings(p.get("results") or p["cv"])
                    for cmd, p in x_payloads.items()}
    picks = [c["fold_picks"] for c in x_payloads["threshold-cv"]["cv"]]
    sizes = sorted({r["imgsz"] for r in x_payloads["imgsz-probe"]
                    ["results"]})
    if sizes != [640, 1408] or not all(picks):
        raise AssertionError(f"x probes: sizes {sizes}, CV picks {picks}")
    print(f"quality, YOLO11x-seg on the card: {json.dumps(summary['x'])}; "
          f"wall s {json.dumps({k: round(v, 3) for k, v in times.items()})}"
          f" on {smi}", flush=True)

    # the x forward at 640 and 1408, a configuration's decode and fusions,
    # and the kernels on the studies' operands
    fields = {}
    for imgsz in (640, 1408):
        ctx = quality.prepare_study(CKPT_X, root, dev, log=lambda *a, **k:
                                    None, imgsz=imgsz)
        with torch.no_grad():
            times[f"x_forward_{imgsz}_ms"], _ = time_events(
                torch, lambda: ctx.run_forward(ctx.images), iters=5)
        config_s = []
        for _ in range(3):
            t = time.perf_counter()
            quality.rows_for(ctx, 0.25, 0.99, floor=0.5, min_pixels=200)
            config_s.append(time.perf_counter() - t)
        times[f"x_config_{imgsz}_ms"] = float(np.median(config_s)) * 1e3
        params = PostprocessParams(spec=ctx.spec, mask_threshold=0.99,
                                   mask_threshold_floor=0.5,
                                   mask_min_pixels=200, max_detections=32)
        if imgsz == 640:
            fields["inside_counts"] = check_quality_k1(
                torch, dev, ctx, postprocess_batch(ctx.raw_out, params))
        else:
            kept = postprocess_batch(ctx.raw_out, params, masks=False)
            tables = (cropped_prob_table(ctx.raw_out["proto"], kept["coef"],
                                         ctx.spec),
                      kept["boxes"], kept["det_valid"])
            fields.update(check_quality_tables(torch, dev, tables, 0.99, 0.5,
                                               200))
        del ctx
        torch.cuda.empty_cache()
    print(f"quality, YOLO11x-seg: forward {times['x_forward_640_ms']:.2f} ms "
          f"at imgsz 640 and {times['x_forward_1408_ms']:.2f} ms at 1408 "
          f"(4 frames, float32, CUDA events); a guarded configuration's "
          f"decode and both fusions {times['x_config_640_ms']:.2f} / "
          f"{times['x_config_1408_ms']:.2f} ms (host clock, synchronised); "
          f"threshold-cv in all {times['x_threshold-cv_s']:.3f} s, on {smi}",
          flush=True)

    # forward_times --top-ops: the serving forward's profile on the card
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = forward_times.main(
            ["--top-ops", "1000", "--batch", "4", "--scale", "n", "--iters",
             "2", "--trace-dir", os.path.join(tmp, "top_ops")])
    text = buf.getvalue()
    total = re.search(r"\(op total ([0-9.]+) ms\)", text)
    listed = text.split(" individual ops --\n", 1)[-1].splitlines()
    ours = [line.strip() for line in listed
            if re.search(r"\b(nms|mask)_kernel\b", line)]
    if code != 0 or not total or float(total[1]) <= 0 or not ours:
        raise AssertionError(f"forward_times --top-ops on the card: {text}")
    summary["top_ops"] = {"detect": text.splitlines()[0],
                          "op_total_ms": float(total[1]),
                          "top": [line.strip() for line in listed[:5]],
                          "port_kernels": ours}
    print(f"forward_times --top-ops on the card: "
          f"{json.dumps(summary['top_ops'])}", flush=True)

    # YOLO11n-seg, card twice and CPU once
    n_logs, n_payloads, compared = {}, {}, {}
    for run, device in (("n_card", dev), ("n_card_again", dev),
                        ("n_cpu", "cpu")):
        for cmd, (flags, want) in QUALITY_N_RUNS.items():
            argv = [cmd, "--ckpt", CKPT, "--dataset", light, "--out",
                    os.path.join(tmp, f"{run}_{cmd}.json"), *flags]
            log = FusionLog(quality)
            payload, _ = counted(
                f"{run}_{cmd}", lambda argv=argv, device=device, log=log:
                run_quality(quality, argv, device, log),
                want if device != "cpu" else {})
            n_logs[run, cmd], n_payloads[run, cmd] = log.configs, payload
    for cmd in QUALITY_N_RUNS:
        card, again = (strip_timings(n_payloads[r, cmd])
                       for r in ("n_card", "n_card_again"))
        if json.dumps(card) != json.dumps(again):
            raise AssertionError(f"n {cmd}: the second card run's payload "
                                 "differs from the first")
        if [c[1] for c in n_logs["n_card", cmd]] != \
                [c[1] for c in n_logs["n_card_again", cmd]]:
            raise AssertionError(f"n {cmd}: the second card run's rows "
                                 "differ")
        equal, total, share = compare_logged(
            torch, n_logs["n_card", cmd], n_logs["n_cpu", cmd], f"n {cmd}")
        cpu = n_payloads["n_cpu", cmd]
        err = same_quality_rows(
            n_payloads["n_card", cmd].get("results") or
            n_payloads["n_card", cmd]["insample"],
            cpu.get("results") or cpu["insample"], f"n {cmd}")
        if cmd == "threshold-cv":
            err = max(err, same_quality_rows(
                [dict(c, fold_picks=json.dumps(c["fold_picks"]))
                 for c in card["cv"]],
                [dict(c, fold_picks=json.dumps(c["fold_picks"]))
                 for c in strip_timings(cpu)["cv"]], "n threshold-cv"))
        compared[cmd] = {"configurations_equal": f"{equal}/{total}",
                         "word_mismatch_share": share, "pct_err": err}
    summary["n_card_vs_cpu"] = compared
    print(f"quality, YOLO11n-seg: two card runs the same payloads and rows; "
          f"card against CPU {json.dumps(compared)} (rows equal where the "
          f"detections are; percentages within {QUALITY_PCT_TOL})",
          flush=True)
    phase("quality protocol", t0)

    # the regeneration: card twice, CPU once
    regen, regen_logs = {}, {}
    for run, device in (("regen", dev), ("regen_again", dev),
                        ("regen_cpu", "cpu")):
        out = os.path.join(tmp, run)
        argv = ["--ckpt", CKPT, "--dataset", light, "--out", out,
                "--device", str(device)]
        with FusionLog() as log:
            counted(run, lambda argv=argv: run_cli(
                argv, regen_artifacts.main),
                REGEN_LAUNCHES if device != "cpu" else {})
        regen[run], regen_logs[run] = out, log.fusions
    a, b, c = regen["regen"], regen["regen_again"], regen["regen_cpu"]
    if regen_files(a) != regen_files(b) or \
            regen_pictures(a) != regen_pictures(b):
        raise AssertionError("the regeneration's second card run wrote "
                             "other files")
    pics = regen_pictures(a)
    if not pics["depth_maps"] or list(pics["seg_overlays"]) != [
            "0000000100.png"]:
        raise AssertionError(f"the regeneration's pictures: "
                             f"{ {k: list(v) for k, v in pics.items()} }")
    same_dets, share = same_regeneration(
        torch, a, c, regen_logs["regen"], regen_logs["regen_cpu"])
    card_sum = json.loads(read_bytes(os.path.join(a, "summary.json")))
    summary["regen"] = {"summary": card_sum, "same_detections": same_dets,
                        "word_mismatch_share": share,
                        "depth_maps": len(pics["depth_maps"])}
    print(f"regeneration: {times['regen_s']:.3f} s on the card (host clock; "
          f"{times['regen_cpu_s']:.3f} s on the CPU), the second card run "
          f"the same files, card = CPU {'byte for byte' if same_dets else 'within the tolerances'}"
          f" ({len(pics['depth_maps'])} depth maps, 1 overlay); "
          f"{json.dumps(card_sum['erosion_study'])} on {smi}", flush=True)

    # the target oracle, and yolo-export served back
    cache = os.path.join(tmp, "labels.npz")
    lines = {}
    for run, device in (("eval_targets", dev), ("eval_targets_cpu", "cpu")):
        argv = ["--dataset", light, "--eval-targets", "--cache", cache,
                "--device", str(device)]
        text = counted(run, lambda argv=argv: run_cli(
            argv, yolo_distill.main),
            {"inside_counts": 2} if device != "cpu" else {})
        lines[run] = [line for line in text.splitlines()
                      if not line.startswith("[labels]")]
    if lines["eval_targets"] != lines["eval_targets_cpu"] or \
            "'matched_cars': 0" in lines["eval_targets"][0]:
        raise AssertionError(f"--eval-targets: {lines}")
    slim = os.path.join(tmp, "yolo11n_slim.msgpack")
    run_cli(["yolo-export", CKPT, slim])
    served = read_flax_msgpack(slim)
    ref_vars = read_flax_msgpack(CKPT)["variables"]
    leaf = served["variables"]["params"]["layer0"]["conv"]["kernel"]
    want = torch.from_numpy(ref_vars["params"]["layer0"]["conv"]["kernel"])
    if leaf.dtype != torch.bfloat16 or not torch.equal(
            leaf, want.to(torch.bfloat16)):
        raise AssertionError("yolo-export did not store bf16 casts")
    text = counted("yolo_export_run", lambda: run_cli(
        ["run", "--dataset", light, "--version", "csv_eval", "--detector",
         "yolo", "--weights", slim, "--output", os.path.join(tmp, "slim"),
         "--device", str(dev)]),
        {"nms": 1, "mask_assemble": 1, "mask_count": 1, "inside_counts": 1})
    matched = int(re.search(r"matched: (\d+)", text)[1])
    if matched == 0:
        raise AssertionError(f"the exported checkpoint served {text!r}")
    summary["eval_targets"] = lines["eval_targets"][0]
    summary["yolo_export_matched"] = matched
    print(f"--eval-targets card = CPU: {lines['eval_targets'][0]}; "
          f"yolo-export: {os.path.getsize(slim)} bytes (bf16), served "
          f"through run --weights on the card: {matched} matched cars",
          flush=True)
    summary["times"] = times
    print(json.dumps({"quality": summary, "launches": launches,
                      "card": smi}), flush=True)
    phase("quality, regeneration, oracle and export", t0)
    return launches, fields, summary


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
    floor_ms = time_gpu(empty_launcher(dev))
    print(f"the empty kernel, timed as the kernels are: {floor_ms:.4f} ms",
          flush=True)
    phase("build", t0)

    detector, images, scenes = load_serving(torch, dev, rng)
    kernels = [check_inside_counts(torch, dev, rng, scenes)]
    kernels += check_mask_kernels(torch, dev, rng, detector, images)
    kernels.append(check_nms(torch, dev, rng, detector, images))
    phase("kernels against twins", t0)

    launches, serving_det = main_path(torch, dev, smi, detector, images,
                                      scenes)
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
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, _, pairs, pp_batch = pointpillars_train_phase(
            torch, dev, smi, tmp)
    assigner = check_rotated_iou_pairs(torch, dev, rng, pairs)
    del pairs
    phase("PointPillars training kernel against its twin", t0)
    with tempfile.TemporaryDirectory() as tmp:
        yolo_launches, _, yolo_batch = yolo_train_phase(torch, dev, smi, tmp)
        bf16_launches, _ = bf16_train_phase(torch, dev, smi, yolo_batch,
                                            pp_batch)
        del yolo_batch
        scale_launches, _ = scale_out_phase(torch, dev, smi, tmp, scenes,
                                            serving_det, pp_batch)
    del serving_det, pp_batch
    with tempfile.TemporaryDirectory() as tmp:
        k2d_launches = kitti2d_phase(torch, dev, smi, tmp)
        jpeg_launches = jpeg_phase(torch, dev, smi, tmp)
    peak_launches, peak = decode_modes_phase(torch, dev, smi, rng)
    with tempfile.TemporaryDirectory() as tmp:
        tools_launches, rotated_m128, long_k1, _ = pillars_tools_phase(
            torch, dev, smi, tmp, rng)
    rotated.update(rotated_m128)
    next(k for k in kernels if k["name"] == "inside_counts").update(long_k1)
    with tempfile.TemporaryDirectory() as tmp:
        quality_launches, quality_fields, _ = quality_phase(
            torch, dev, smi, tmp, images, scenes)
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
    # the peak pass's main path is the relative decode
    peak.update(launches=peak_launches["mask_peak"],
                csv_eval_launches=csv_launches["mask_peak"],
                headline_launches=launches["mask_peak"],
                headline_launches_4_chunks=times["launches_many"][
                    "mask_peak"])
    kernels.append(peak)
    # the assigner's IoU's main path is the SSD head's training run
    assigner.update(launches=train_launches["ssd"]["rotated_iou_pairs"],
                    csv_eval_launches=csv_launches["rotated_iou_pairs"],
                    headline_launches=launches["rotated_iou_pairs"],
                    headline_launches_4_chunks=times["launches_many"][
                        "rotated_iou_pairs"])
    kernels.append(assigner)
    for k in kernels:
        k["matching_launches"] = {run: n[k["name"]]
                                  for run, n in match_launches.items()}
        k["pointpillars_launches"] = {run: n[k["name"]]
                                      for run, n in pp_launches.items()}
        k["kitti2d_launches"] = k2d_launches[k["name"]]
        k["kitti2d_jpeg_launches"] = jpeg_launches[k["name"]]
        k["relative_decode_launches"] = peak_launches[k["name"]]
        k["pointpillars_train_launches"] = {
            run: n[k["name"]] for run, n in train_launches.items()}
        k["yolo_train_launches"] = {run: n[k["name"]]
                                    for run, n in yolo_launches.items()}
        k["bf16_train_launches"] = {run: n[k["name"]]
                                    for run, n in bf16_launches.items()}
        k["pillars_tools_launches"] = {run: n[k["name"]]
                                       for run, n in tools_launches.items()}
        k.update(quality_fields.get(k["name"], {}))
        k["quality_launches"] = {run: n[k["name"]]
                                 for run, n in quality_launches.items()
                                 if not run.startswith("regen")}
        k["regen_launches"] = {run: n[k["name"]]
                               for run, n in quality_launches.items()
                               if run.startswith("regen")}
        k["scale_out_launches"] = {
            "point_sharded_w1": scale_launches["point_sharded_w1"][
                k["name"]],
            "frame_sharded_w1": scale_launches["frame_sharded_w1"][
                k["name"]],
            "ranks_w2": [{part: n[k["name"]] for part, n in rank.items()}
                         for rank in scale_launches["ranks_w2"]],
            "runner_w2": [n[k["name"]]
                          for n in scale_launches["runner_w2"]]}
    for k in kernels:
        k["launch_floor_ms"] = floor_ms
    phase("total", t0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
