"""Profile of the inside-count kernel (K1) on the card: ablations and
clock records.

    python -m lidar_object_detection_tpu_torch.tools.k1_profile \\
        [--baseline SINGLE_FRAME.cu] [--out FILE.json]

Runs from the root of a checkout on a machine with one CUDA card.  It
prints the card's name and power limit and one line per measurement, and
writes them all as JSON to ``--out``.

It builds ``csrc/inside_counts.cu`` once per variant (one ``nvcc`` each,
all started together), each variant a library of its own:

* ``full``: the kernel the port ships;
* ``step1``, ``step2``: one or two candidate boxes per vote instead of
  four, i.e. less independent work in flight per warp;
* ``threads256``: blocks of 256 threads (rounds of 256 points);
* ``no_sort``, ``no_cull``, ``no_slabs``, ``load_only``: without the
  round's sort, the culling, the slab tests, or any counting (their counts
  are wrong; only their times mean something);
* ``profile``: the full kernel with clock records (``K1_PROFILE``): the
  achieved occupancy from each block's start and end time and SM, the
  share of the warps' clocks spent at the barrier that ends each round,
  and clocks per step of four boxes.

Inputs: four synthetic scans of 131072 points with 300 valid boxes of 384
(``chip_smoke.make_scene``, 32 detections in a row), with words random
over half the valid points ("random", as the smoke's) or only on the
points inside some valid box ("clustered", as a detector's masks give
them); each at B = 4 (the main path's launch) and B = 1.

``--baseline`` takes the single-frame K1 the port had before the frame
axis moved into the grid (``git show 412ba2e:lidar_object_detection_tpu_
torch/csrc/inside_counts.cu``) and probes it, and the shipped kernel,
with inputs that isolate one suspected cost each: the same active points
moved to the front of the scan (full warps), one bit per word (one shared
atomic per hit instead of popc(word)), no active point, and every box
invalid.

Every timed kernel that computes counts (``full``, the baseline) is first
held equal to the plain twin.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

from lidar_object_detection_tpu_torch.ops import kernel_lib

VARIANTS = {
    "full": (),
    "step1": ("-DK1_STEP=1",),
    "step2": ("-DK1_STEP=2",),
    "threads256": ("-DK1_THREADS=256",),
    "no_sort": ("-DK1_NO_SORT",),
    "no_cull": ("-DK1_NO_CULL",),
    "no_slabs": ("-DK1_NO_SLABS",),
    "load_only": ("-DK1_LOAD_ONLY",),
    "profile": ("-DK1_PROFILE",),
}
_P, _I = ctypes.c_void_p, ctypes.c_int
# the single-frame launch: points, bits, frame, P, G, D, counts, totals,
# SMs, stream
BASELINE_SIGNATURE = (_P, _P, _P, _I, _I, _I, _P, _P, _I, _P)
BASELINE_THREADS = 256          # its launch: min(ceil(P / 256), 2 SMs)


def build_all(sources):
    """{name: (source path, extra nvcc flags)} -> {name: (library path,
    ptxas report)}, one nvcc per name, all started together; a build is
    kept under csrc/build/profile/ keyed by its source and flags."""
    root = kernel_lib.BUILD_ROOT / "profile"
    root.mkdir(parents=True, exist_ok=True)
    nvcc = kernel_lib._nvcc()
    procs, out = {}, {}
    for name, (src, flags) in sources.items():
        key = hashlib.sha256(" ".join(kernel_lib.NVCC_FLAGS + flags)
                             .encode() + open(src, "rb").read())
        lib = root / key.hexdigest()[:16] / "libk1.so"
        out[name] = lib
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        procs[name] = subprocess.Popen(
            [nvcc, *kernel_lib.NVCC_FLAGS, *flags, "-Xptxas", "-v",
             "-shared", str(src), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    reports = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{text}")
        reports[name] = [line.strip() for line in text.splitlines()
                         if "registers" in line]
    return {name: (lib, reports.get(name, ["(built earlier)"]))
            for name, lib in out.items()}


def load(path, signature):
    lib = ctypes.CDLL(str(path))
    lib.inside_counts_launch.argtypes = list(signature)
    lib.inside_counts_launch.restype = ctypes.c_int
    return lib


def make_inputs(torch, dev, rng, batch):
    """(points, pvalid, corners velo, box mask) of ``batch`` scans."""
    import chip_smoke
    from lidar_object_detection_tpu_torch.geom.boxes import (
        transform_corners)

    dets = np.stack([np.array([x, 150, x + 120, 260], np.float32)
                     for x in np.linspace(50, 1250, chip_smoke.D)])
    cam_to_velo = torch.from_numpy(chip_smoke.CAM_TO_VELO)
    frames = []
    for _ in range(batch):
        pts, pvalid, corners, bvalid = chip_smoke.make_scene(
            rng, dets, np.ones(chip_smoke.D, bool))
        velo = transform_corners(torch.from_numpy(corners), cam_to_velo)
        frames.append((np.ascontiguousarray(pts[:, :3]), pvalid,
                       velo.numpy(), bvalid))
    pts, pvalid, corners, bvalid = (np.stack(x) for x in zip(*frames))
    return (torch.from_numpy(pts).to(dev).contiguous(), pvalid,
            torch.from_numpy(corners).to(dev).contiguous(),
            torch.from_numpy(bvalid).to(dev))


def clustered_words(torch, rng, pts, pvalid, corners, mask):
    """Random non-zero words on the valid points inside some valid box."""
    from lidar_object_detection_tpu_torch.geom.boxes import (
        inside_from_frame, masked_box_frame)

    words = np.zeros(pvalid.shape, np.uint64)
    for b in range(pvalid.shape[0]):
        axes, offsets = masked_box_frame(corners[b].cpu(), mask[b].cpu())
        inside = torch.zeros(pvalid.shape[1], dtype=torch.bool)
        p = pts[b].cpu()
        for s in range(0, len(p), 16384):
            inside[s:s + 16384] = inside_from_frame(
                p[s:s + 16384], axes, offsets).any(dim=1)
        hit = inside.numpy() & pvalid[b]
        words[b] = np.where(hit, rng.integers(1, 2 ** 32, hit.shape,
                                              dtype=np.uint64), 0)
    return words.astype(np.uint32).view(np.int32)


def frame_of(torch, corners, mask):
    from lidar_object_detection_tpu_torch.geom.boxes import masked_box_frame

    b, g = mask.shape
    axes, offsets = masked_box_frame(corners, mask)
    return torch.cat([axes, offsets[..., None]], -1).reshape(
        b, g, 12).contiguous()


def launcher(torch, lib, args, sms, stream):
    """A no-argument launch of a batched variant on ``args`` = (points,
    words, corners, mask); returns (run, counts, totals)."""
    pts, words, corners, mask = args
    b, p = words.shape
    g = mask.shape[1]
    frame = frame_of(torch, corners, mask)
    counts = torch.zeros((b, 32, g), dtype=torch.int32, device=pts.device)
    totals = torch.zeros((b, 32), dtype=torch.int32, device=pts.device)

    # counts start at zero for the first run, which is checked; timed runs
    # add on top
    def run():
        kernel_lib.check(lib.inside_counts_launch(
            pts.data_ptr(), words.data_ptr(), frame.data_ptr(),
            corners.data_ptr(), mask.data_ptr(), b, p, g, 32,
            counts.data_ptr(), totals.data_ptr(), sms, stream),
            "inside_counts_launch")
    return run, counts, totals


def baseline_launcher(torch, lib, args, sms, stream):
    """The single-frame baseline on one frame of ``args``."""
    pts, words, corners, mask = args
    p = words.shape[1]
    g = mask.shape[1]
    frame = frame_of(torch, corners, mask)
    counts = torch.zeros((1, 32, g), dtype=torch.int32, device=pts.device)
    totals = torch.zeros((1, 32), dtype=torch.int32, device=pts.device)

    # counts start at zero for the first run, which is checked; timed runs
    # add on top
    def run():
        kernel_lib.check(lib.inside_counts_launch(
            pts.data_ptr(), words.data_ptr(), frame.data_ptr(), p, g, 32,
            counts.data_ptr(), totals.data_ptr(), sms, stream),
            "baseline inside_counts_launch")
    return run, counts, totals


def check_equal(torch, name, args, counts, totals):
    from lidar_object_detection_tpu_torch.ops.inside_counts import (
        inside_counts_plain)

    ref_c, ref_t = inside_counts_plain(*args, 32)
    bad = int((counts != ref_c).sum() + (totals != ref_t).sum())
    if bad:
        raise AssertionError(f"{name} differs from the twin in {bad} "
                             f"entries")


def clock_profile(torch, time_gpu, lib, args, sms, stream, dev):
    """Run the K1_PROFILE build once and read its records, then time it
    (its records need a buffer, so it is timed here)."""
    per_frame, per_sm, threads = ctypes.c_int(), ctypes.c_int(), \
        ctypes.c_int()
    lib.inside_counts_grid.argtypes = [_I] * 5 + [_P] * 3
    b, p = args[1].shape
    kernel_lib.check(lib.inside_counts_grid(
        b, p, args[3].shape[1], 32, sms, ctypes.byref(per_frame),
        ctypes.byref(per_sm), ctypes.byref(threads)), "inside_counts_grid")
    warps = threads.value // 32
    blocks = per_frame.value * b
    buf = torch.zeros((blocks, 1 + warps, 4), dtype=torch.int64, device=dev)
    lib.inside_counts_profile_buffer.argtypes = [_P]
    kernel_lib.check(lib.inside_counts_profile_buffer(buf.data_ptr()),
                     "inside_counts_profile_buffer")
    run, _, _ = launcher(torch, lib, args, sms, stream)
    run()
    torch.cuda.synchronize()
    rec = buf.cpu().numpy()
    ms = time_gpu(run)
    head = rec[:, 0, :]
    ran = head[:, 0] > 0
    start, end = head[ran, 0].astype(np.float64), head[ran, 1]
    span = float(end.max() - start.min())
    life = end - start
    w = rec[ran, 1:, :].reshape(-1, 4).astype(np.float64)
    busy, wait, groups, steps = w.sum(axis=0)
    return {
        "ms": ms, "blocks": int(ran.sum()), "blocks_per_sm_allowed": per_sm.value,
        "threads": threads.value, "span_us": span / 1e3,
        # resident warps per SM over the kernel's span, of 64
        "achieved_warps_per_sm": float(life.sum() * warps / (span * sms)),
        "block_us_mean": float(life.mean() / 1e3),
        "block_us_max": float(life.max() / 1e3),
        "sms_used": int(len(np.unique(head[ran, 2]))),
        "barrier_wait_share": float(wait / (busy + wait)),
        "clocks_per_step": float(busy / max(steps, 1)),
        "steps_per_group": float(steps / max(groups, 1)),
        "groups": int(groups),
    }


def main(argv=None) -> int:
    import torch

    import chip_smoke

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="single-frame K1 source to probe")
    ap.add_argument("--out", help="write the measurements here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("CUDA is not available: the profile runs on a card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    sms = kernel_lib.sm_count(dev)
    stream = kernel_lib.stream_handle(dev)
    rng = np.random.default_rng(0)

    src = kernel_lib.CSRC / "inside_counts.cu"
    sources = {name: (src, flags) for name, flags in VARIANTS.items()}
    if args.baseline:
        sources["baseline"] = (os.path.abspath(args.baseline), ())
    built = build_all(sources)
    libs = {name: load(path, BASELINE_SIGNATURE if name == "baseline"
                       else kernel_lib.SIGNATURES["inside_counts_launch"])
            for name, (path, _) in built.items()}
    for name, (_, report) in built.items():
        print(f"[{name}] {' | '.join(report)}", flush=True)

    pts, pvalid, corners, mask = make_inputs(torch, dev, rng, 4)
    words = {
        "random": chip_smoke.random_words(rng, pvalid.reshape(-1), 0.5)
        .reshape(pvalid.shape),
        "clustered": clustered_words(torch, rng, pts, pvalid, corners, mask),
    }
    inputs = {}
    for kind, w in words.items():
        wt = torch.from_numpy(w).to(dev)
        inputs[f"{kind} B=4"] = (pts, wt, corners, mask)
        inputs[f"{kind} B=1"] = (pts[:1].contiguous(), wt[:1].contiguous(),
                                 corners[:1].contiguous(), mask[:1])
    result = {"device": smi, "variants": {}, "baseline": {},
              "ptxas": {n: r for n, (_, r) in built.items()}}
    for name, inp in inputs.items():
        active = int((inp[1] != 0).sum())
        pairs = int(((inp[1] != 0).sum(dim=1) * inp[3].sum(dim=1)).sum())
        row = {"active": active, "pairs": pairs}
        for variant in VARIANTS:
            if variant == "profile":
                continue
            run, c, t = launcher(torch, libs[variant], inp, sms, stream)
            if variant == "full":
                run()
                check_equal(torch, f"full on {name}", inp, c, t)
            row[variant] = chip_smoke.time_gpu(run)
        row["profile"] = clock_profile(torch, chip_smoke.time_gpu,
                                       libs["profile"], inp, sms, stream,
                                       dev)
        result["variants"][name] = row
        print(f"{name}: " + json.dumps(row), flush=True)

    if args.baseline:
        pts1, w1, c1, m1 = inputs["random B=1"]
        order = torch.argsort((w1[0] == 0).to(torch.int8), stable=True)
        nonzero = w1 != 0
        one_bit = torch.where(
            nonzero, torch.bitwise_left_shift(
                torch.ones_like(w1),
                torch.from_numpy(rng.integers(0, 32, w1.shape)).to(dev)
                .to(torch.int32)), torch.zeros_like(w1))
        probes = {
            "random": (pts1, w1, c1, m1),
            "active first": (pts1[:, order].contiguous(),
                             w1[:, order].contiguous(), c1, m1),
            "one bit per word": (pts1, one_bit, c1, m1),
            "no active point": (pts1, torch.zeros_like(w1), c1, m1),
            "every box invalid": (pts1, w1, c1, torch.zeros_like(m1)),
        }
        for name, inp in probes.items():
            run, c, t = baseline_launcher(torch, libs["baseline"], inp,
                                          sms, stream)
            run()
            check_equal(torch, f"baseline on {name}", inp, c, t)
            # the baseline's shared atomics on hits: popc(word) per hit
            row = {"active": int((inp[1] != 0).sum()),
                   "hit_atomics": int(c.sum())}
            row["baseline"] = chip_smoke.time_gpu(run)
            run, c, t = launcher(torch, libs["full"], inp, sms, stream)
            run()
            check_equal(torch, f"full on {name}", inp, c, t)
            row["full"] = chip_smoke.time_gpu(run)
            result["baseline"][name] = row
            print(f"baseline {name}: " + json.dumps(row), flush=True)
        blocks = min(-(-pts1.shape[1] // BASELINE_THREADS), 2 * sms)
        result["baseline_grid"] = {
            "blocks": blocks, "threads": BASELINE_THREADS,
            "warps_per_sm": blocks * BASELINE_THREADS / 32 / sms}
        print(f"baseline grid: {result['baseline_grid']}", flush=True)

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
