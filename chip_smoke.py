#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one CUDA card:

1. prints the PyTorch version and the card's name and power limit, and
   fails when CUDA is not available;
2. builds the CUDA kernels of ``lidar_object_detection_tpu_torch`` from the
   checkout's sources (``nvcc`` -> one ctypes-loaded library);
3. holds each kernel against its plain PyTorch twin on the card at the
   serving path's shapes, and times both with CUDA events;
4. drives the main path through the port's entry points: the committed
   YOLO11n-seg checkpoint at its sidecar serving point (hflip TTA, guarded
   masks, BatchNorm folded, bf16) over 4 frames of 376 x 1408 (two real
   camera frames and their mirrors), then ``fuse_batch`` over synthetic
   131072-point scans with 384 box slots, then ``frame_statistics``.  The
   kernels' launch counters are zeroed just before and read just after,
   and every kernel must have run.  The same network outputs are then
   decoded on the CPU by the twins, and the fusion is rerun with the plain
   inside-count, as references;
5. prints one JSON line of the kernels (times, bounds, launches, errors),
   the card's name and power limit, and last the ``{"ok": true, ...}``
   line.

Any failed phase raises, and the script exits non-zero without the last
line.  It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import subprocess
import sys
import time
import zlib

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "checkpoints", "yolo11n_seg_distill.msgpack")
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
H0, W0 = 376, 1408


def read_png_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit RGB, non-interlaced PNG, with zlib and
    numpy only."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color != 2 or interlace != 0:
        raise ValueError(f"{path}: only 8-bit RGB, non-interlaced PNG")
    bpp, stride = 3, 3 * width
    raw = zlib.decompress(b"".join(idat))
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(height):
        start = y * (stride + 1)
        line = np.frombuffer(raw, np.uint8, stride, start + 1).astype(np.int64)
        kind = raw[start]
        if kind == 0:
            cur = line
        elif kind == 1:      # Sub: a running sum along each channel
            cur = line.reshape(width, bpp).cumsum(axis=0).reshape(-1) % 256
        elif kind == 2:      # Up
            cur = (line + prev) % 256
        else:                # Average, Paeth: sequential along the row
            cur = _unfilter_row(kind, line.tolist(), prev.tolist(), bpp)
        out[y] = cur
        prev = np.asarray(cur, np.int64)
    return out.reshape(height, width, 3)


def _unfilter_row(kind, line, prev, bpp):
    cur = [0] * len(line)
    for i, x in enumerate(line):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            cur[i] = (x + ((a + b) >> 1)) & 0xFF
        elif kind == 4:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[i] = (x + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter {kind}")
    return np.asarray(cur, np.int64)


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
               num_valid=300, intrinsics=INTRINSICS):
    """One frame's synthetic scan and GT boxes.

    Each valid detection gets a 3D box at 8-20 m whose projection covers
    its 2D box, filled with points; the other valid slots hold boxes
    scattered in front of the camera, some filled with points; the rest of
    the scan is background.  Returns velodyne points (P, 4), point mask,
    cam0 corners (G, 8, 3) and box mask.
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
    bg = np.stack([rng.uniform(-40, 40, n_bg), rng.uniform(-3, 2, n_bg),
                   rng.uniform(1, 70, n_bg)], 1)
    pts_cam = np.concatenate([inside_cam, bg]).astype(np.float32)
    points = np.zeros((num_points, 4), np.float32)
    points[:len(pts_cam), :3] = to_velo(pts_cam)
    points[:len(pts_cam), 3] = rng.uniform(0, 1, len(pts_cam))
    point_valid = np.zeros(num_points, bool)
    point_valid[:len(pts_cam)] = True
    return points, point_valid, corners, box_valid


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

def check_inside_counts(torch, dev, rng):
    from lidar_object_detection_tpu_torch.geom.boxes import (
        masked_box_frame, transform_corners)
    from lidar_object_detection_tpu_torch.ops import (
        inside_counts as ic, kernel_lib)

    dets = np.stack([np.array([x, 150, x + 120, 260], np.float32)
                     for x in np.linspace(50, 1250, D)])
    points, pvalid, corners_cam, bvalid = make_scene(
        rng, dets, np.ones(D, bool))
    corners = transform_corners(torch.from_numpy(corners_cam),
                                torch.from_numpy(CAM_TO_VELO)).to(dev)
    pts = torch.from_numpy(points[:, :3]).to(dev).contiguous()
    words = rng.integers(0, 2 ** 32, P, dtype=np.uint64)
    words = np.where(rng.random(P) < 0.5, words, 0) \
        * pvalid.astype(np.uint64)
    bits = torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(dev)
    box_mask = torch.from_numpy(bvalid).to(dev)

    counts, totals = ic.inside_counts_cuda(pts, bits, corners, box_mask, D)
    ref_counts, ref_totals = ic.inside_counts_plain(pts, bits, corners,
                                                    box_mask, D)
    torch.cuda.synchronize()
    diff = int((counts != ref_counts).sum() + (totals != ref_totals).sum())
    max_err = int(max((counts - ref_counts).abs().max(),
                      (totals - ref_totals).abs().max()))
    if diff:
        raise AssertionError(f"K1 inside counts differ from the twin in "
                             f"{diff} entries")
    if int(counts.sum()) == 0:
        raise AssertionError("K1 check is degenerate: no point in a box")

    axes, offsets = masked_box_frame(corners, box_mask)
    frame = torch.cat([axes, offsets[..., None]], -1).reshape(G, 12)
    frame = frame.contiguous()
    lib = kernel_lib.library()
    c_out = torch.zeros_like(counts)
    t_out = torch.zeros_like(totals)
    sms = kernel_lib.sm_count(dev)

    def launch():
        kernel_lib.check(lib.inside_counts_launch(
            pts.data_ptr(), bits.data_ptr(), frame.data_ptr(), P, G, D,
            c_out.data_ptr(), t_out.data_ptr(), sms,
            kernel_lib.stream_handle(dev)), "inside_counts_launch")

    ms = time_gpu(launch)
    plain_ms = time_gpu(lambda: ic.inside_counts_plain(
        pts, bits, corners, box_mask, D), reps=10, head_start=False)
    active = int((bits != 0).sum())
    n_bytes = P * 3 * 4 + P * 4 + G * 8 * 3 * 4 + G + D * G * 4 + D * 4
    bound, by = bound_ms(n_bytes, active * G * 15)
    print(f"K1 inside_counts: {int(counts.sum())} hits, {active} active "
          f"points, equal to the twin; {ms:.4f} ms (twin {plain_ms:.4f})",
          flush=True)
    return {"name": "inside_counts", "route": "cuda",
            "source": "lidar_object_detection_tpu_torch/csrc/"
                      "inside_counts.cu",
            "replaces": "lidar_object_detection_tpu/ops/pallas_count.py:74",
            "max_abs_err": max_err, "mismatches": diff, "ms": ms,
            "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def check_mask_kernels(torch, dev, rng):
    from lidar_object_detection_tpu_torch.ops import (
        kernel_lib, mask_assembly as ma)

    mh, mw = 42, 160
    # smooth random fields: a product of sines through a sigmoid, so that
    # the 0.99 cut leaves some detections near-empty and the guard fires
    yy = np.linspace(0, 1, mh)[None, :, None]
    xx = np.linspace(0, 1, mw)[None, None, :]
    fy = rng.uniform(1, 6, (D, 1, 1))
    fx = rng.uniform(1, 12, (D, 1, 1))
    amp = rng.uniform(2, 9, (D, 1, 1))
    table_np = 1 / (1 + np.exp(-amp * np.sin(fy * 3 * yy + fx)
                               * np.cos(fx * 2 * xx)))
    table = torch.from_numpy(table_np.astype(np.float32)).to(dev)
    x1 = rng.uniform(0, W0 - 100, D)
    y1 = rng.uniform(0, H0 - 60, D)
    boxes = torch.from_numpy(np.stack(
        [x1, y1, x1 + rng.uniform(40, 600, D), y1 + rng.uniform(30, 300, D)],
        1).astype(np.float32)).to(dev)
    det_valid = torch.from_numpy(rng.random(D) > 0.15).to(dev)

    ops = ma.prepare_operands(table, boxes, det_valid, H0, W0, 0.99)
    counts = ma.count_above_cuda(ops)
    ref_counts = ma.count_above_plain(ops)
    thr = ma.guarded_thresholds(counts, 0.99, 0.5, 200)
    ops_g = ma.prepare_operands(table, boxes, det_valid, H0, W0, thr)
    words = ma.assemble_masks_cuda(ops_g)
    ref_words = ma.assemble_masks_plain(ops_g)
    plain_hi = ma.assemble_masks_plain(ops)
    torch.cuda.synchronize()
    if not torch.equal(counts, ref_counts):
        raise AssertionError("K3 counts differ from the twin")
    k3_err = int((counts - ref_counts).abs().max())
    mismatches = int((words != ref_words).sum())
    # the largest difference of any one mask bit (0 or 1)
    k2_err = int((words ^ ref_words).ne(0).any())
    if mismatches:
        raise AssertionError(f"K2 words differ from the twin at "
                             f"{mismatches} pixels")
    if not bool((ref_words != 0).any()) or torch.equal(ref_words, plain_hi):
        raise AssertionError("mask check is degenerate: no bits, or the "
                             "guard never fired")

    lib = kernel_lib.library()
    out_w = torch.empty((H0, W0), dtype=torch.int32, device=dev)
    out_c = torch.zeros((D,), dtype=torch.int32, device=dev)

    def launcher(name, o, out):
        def run():
            kernel_lib.check(getattr(lib, name)(
                o.table.data_ptr(), D, mh, mw, o.y0.data_ptr(),
                o.wy0.data_ptr(), o.wy1.data_ptr(), o.x0.data_ptr(),
                o.wx0.data_ptr(), o.wx1.data_ptr(), o.boxes.data_ptr(),
                o.thr.data_ptr(), H0, W0, out.data_ptr(),
                kernel_lib.stream_handle(dev)), name)
        return run

    k2_ms = time_gpu(launcher("mask_assemble_launch", ops_g, out_w))
    k3_ms = time_gpu(launcher("mask_count_launch", ops, out_c))
    k2_plain = time_gpu(lambda: ma.assemble_masks_plain(ops_g), reps=10,
                        head_start=False)
    k3_plain = time_gpu(lambda: ma.count_above_plain(ops), reps=10,
                        head_start=False)
    b = ops.boxes.cpu().numpy()
    area = (np.clip(np.ceil(b[:, 2]), 0, W0) - np.clip(np.ceil(b[:, 0]), 0,
                                                       W0)) \
        * (np.clip(np.ceil(b[:, 3]), 0, H0) - np.clip(np.ceil(b[:, 1]), 0,
                                                      H0))
    pairs = float(np.clip(area, 0, None).sum())
    in_bytes = D * mh * mw * 4 + D * 4 * 4 + D + D * 4
    k2_bound, k2_by = bound_ms(in_bytes + H0 * W0 * 4, pairs * 8)
    k3_bound, k3_by = bound_ms(in_bytes + D * 4, pairs * 8)
    n_guard = int((thr < 0.99).sum())
    print(f"K3 mask_count: equal to the twin; {k3_ms:.4f} ms (twin "
          f"{k3_plain:.4f}); K2 mask_assemble: {int((words != 0).sum())} "
          f"pixels set, {n_guard} detections on the floor cut, equal to "
          f"the twin; {k2_ms:.4f} ms (twin {k2_plain:.4f})", flush=True)
    src = "lidar_object_detection_tpu_torch/csrc/mask_assembly.cu"
    return [
        {"name": "mask_assemble", "route": "cuda", "source": src,
         "replaces": "lidar_object_detection_tpu/ops/pallas_masks.py:246",
         "max_abs_err": k2_err, "mismatches": mismatches, "ms": k2_ms,
         "kernel_ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
        {"name": "mask_count", "route": "cuda", "source": src,
         "replaces": "lidar_object_detection_tpu/ops/pallas_masks.py:282",
         "max_abs_err": k3_err, "mismatches": int((counts != ref_counts)
                                                   .sum()),
         "ms": k3_ms, "kernel_ms": k3_ms,
         "plain_ms": k3_plain, "bound_ms": k3_bound, "bound_by": k3_by,
         "library_ms": None},
    ]


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def main_path(torch, dev, rng, smi):
    from lidar_object_detection_tpu_torch.config import (
        FusionConfig, FusionParams)
    from lidar_object_detection_tpu_torch.eval.statistics import (
        frame_statistics, summarize)
    from lidar_object_detection_tpu_torch.fusion.associate import fuse_batch
    from lidar_object_detection_tpu_torch.models.yolo.serving import (
        load_serving_checkpoint)
    from lidar_object_detection_tpu_torch.ops import kernel_lib

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
    phase("load checkpoint and frames", t0)

    # scenes from a first detection, so that boxes meet the cars
    first = detector.detect(images)
    scenes = [make_scene(rng, first["boxes"][b].float().cpu().numpy(),
                         first["det_valid"][b].cpu().numpy())
              for b in range(len(images))]
    points, pvalid, corners, bvalid = (
        torch.from_numpy(np.stack([s[i] for s in scenes])).to(dev)
        for i in range(4))
    calib = tuple(torch.from_numpy(m).to(dev)
                  for m in (VELO_TO_RECT, CAM_TO_VELO, INTRINSICS))
    cfg = FusionConfig(erosion_enabled=True)
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
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"the main path launched no {missing}")

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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    kernel_lib.build(verbose=True)
    print(f"kernel build: {kernel_lib.build_info['seconds']:.2f} s",
          flush=True)
    phase("build", t0)

    kernels = [check_inside_counts(torch, dev, rng)]
    kernels += check_mask_kernels(torch, dev, rng)
    phase("kernels against twins", t0)

    launches = main_path(torch, dev, rng, smi)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    phase("total", t0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
