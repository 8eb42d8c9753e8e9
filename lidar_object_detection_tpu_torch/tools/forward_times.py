"""Times of the YOLO serving forwards on the card, for comparing two
checkouts of the port on one card.

    PYTHONPATH=CHECKOUT python SCRIPT --repo ROOT [--iters 10] [--rounds 5]

``SCRIPT`` is this file's path.  It imports ``lidar_object_detection_tpu_
torch`` from the Python path, so that a checkout of another commit put
first on ``PYTHONPATH`` is timed by this same script, and reads the
committed checkpoints under ``--repo``.  It prints the card's name and
power limit, then one JSON line: the directory of the package it timed
(``port``) and CUDA-event milliseconds per call of
``YoloDetector.forward`` (uint8 frames on the card in, raw outputs out):

* ``n_ms``: the n checkpoint at its serving point (hflip TTA, BatchNorm
  folded, bf16) on 4 frames of 376 x 1408, 8 images through the network,
  as ``chip_smoke.py``'s main path serves them;
* ``x_ms``: the x checkpoint, folded bf16, single view, on 8 frames, as
  the headline serves them;
* ``kitti2d_ms``: YOLO11x's detection head from seed 0 in float32 on one
  224 x 640 image (375 x 1242 letterboxed), as the KITTI 2D evaluation
  runs it;

each a list of ``--rounds`` timings of ``--iters`` calls after a
warm-up.  The frames are seeded noise: a forward's time does not depend
on the pixels.

    python SCRIPT --top-ops N [--batch 38] [--scale x] [--no-fold]
        [--iters 10] [--trace-dir DIR] [--device cpu]

With ``--top-ops N`` it profiles the serving detector instead, as
``examples/profile_detector.py`` does: YOLO11-seg of ``--scale`` from
random weights (folded into bf16 unless ``--no-fold``, max 32
detections) on ``--batch`` seeded frames of 376 x 1408.  It prints the
``detect`` time per batch, then traces ``--iters`` calls with
``utils.profiling.trace`` (``torch.profiler``; the Chrome trace in
``--trace-dir``) and prints the device's self-time by op family and the
top N kernels.  With ``--device cpu`` it profiles the CPU (host clock;
the CPU operators' self-time in place of the kernels'); the times mode
runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
from collections import defaultdict

import numpy as np
import torch


def _times(fn, iters: int, rounds: int):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out


def _family(name: str) -> str:
    """The op family of a kernel or operator name (the JAX script's rule
    on the name without its template and argument lists)."""
    name = name.removeprefix("void ").split("(")[0].split("<")[0]
    return name.split("::")[-1].lstrip("_").split(".")[0].split("_")[0]


def print_top_ops(prof, top: int, device) -> None:
    """The device's self-time of a ``torch.profiler`` capture by op family
    and its ``top`` largest kernels (on the CPU: operators), in ms."""
    from lidar_object_detection_tpu_torch.utils import profiling

    cuda = torch.device(device).type == "cuda"
    tally = {}
    for e in prof.key_averages():
        if cuda:
            if not str(e.device_type).endswith("CUDA"):
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
        else:
            us = e.self_cpu_time_total
        if us > 0:
            tally[e.key] = tally.get(e.key, 0.0) + us / 1e3
    total = sum(tally.values())
    print(f"\n== device: {profiling.device_name(device)}  (op total "
          f"{total:.3f} ms)")
    groups = defaultdict(float)
    for name, ms in tally.items():
        groups[_family(name)] += ms
    print("-- by op family --")
    for k, v in sorted(groups.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {k[:28]:<28} {v:9.3f} ms  {100 * v / total:5.1f}%")
    print(f"-- top {top} individual ops --")
    for name, ms in sorted(tally.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {name[:76]:<76} {ms:8.3f} ms")


def top_ops(args) -> None:
    """The ``--top-ops`` mode: time and trace the serving detector."""
    from lidar_object_detection_tpu_torch.models.yolo.detector import (
        YoloDetector)
    from lidar_object_detection_tpu_torch.models.yolo.model import (
        YoloConfig)
    from lidar_object_detection_tpu_torch.models.yolo.weights import (
        flax_template)
    from lidar_object_detection_tpu_torch.utils import profiling

    dev = torch.device(args.device)
    cfg = YoloConfig(scale=args.scale)
    det = YoloDetector((376, 1408), cfg, variables=flax_template(cfg),
                       max_detections=32, fast_masks=True,
                       fold_weights=args.fold, dtype=torch.bfloat16,
                       device=dev)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(
        0, 255, (args.batch, 376, 1408, 3), dtype=np.uint8)).to(dev)
    with torch.no_grad():
        dt = profiling.time_calls(lambda: det.detect(images), args.iters,
                                  dev)
        print(f"detect: {dt * 1e3:.2f} ms/batch "
              f"({dt * 1e3 / args.batch:.3f} ms/frame, batch {args.batch}) "
              f"on {profiling.device_name(dev)}", flush=True)
        with profiling.trace(args.trace_dir) as prof:
            for _ in range(args.iters):
                out = det.detect(images)
            profiling.device_barrier(out)
    print_top_ops(prof, args.top_ops, dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=None,
                    help="root of a checkout holding checkpoints/ (the "
                         "times mode)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--top-ops", type=int, default=0, metavar="N",
                    help="profile the serving detector and print its N "
                         "largest kernels by device self-time")
    ap.add_argument("--batch", type=int, default=38)
    ap.add_argument("--scale", default="x")
    ap.add_argument("--fold", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="fold BN + store weights bf16 (serving prep)")
    ap.add_argument("--trace-dir", default=os.path.join(
        tempfile.gettempdir(), "torch_detector_trace"))
    args = ap.parse_args(argv)
    if args.top_ops:
        if torch.device(args.device).type == "cuda" \
                and not torch.cuda.is_available():
            print("CUDA is not available: pass --device cpu to profile the "
                  "CPU")
            return 1
        top_ops(args)
        return 0
    if not args.repo:
        ap.error("--repo is required (but with --top-ops)")
    if torch.device(args.device).type != "cuda":
        ap.error("the times are taken on a card: --device cpu is for "
                 "--top-ops")
    if not torch.cuda.is_available():
        print("CUDA is not available: the times are taken on a card")
        return 1

    import lidar_object_detection_tpu_torch as port
    from lidar_object_detection_tpu_torch.models.yolo.detector import (
        YoloDetector)
    from lidar_object_detection_tpu_torch.models.yolo.model import (
        YoloConfig)
    from lidar_object_detection_tpu_torch.models.yolo.serving import (
        load_serving_checkpoint)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    frames = lambda b, h, w: torch.from_numpy(
        rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(dev)
    ckpt = lambda name: os.path.join(args.repo, "checkpoints", name)
    times = {"port": os.path.dirname(os.path.abspath(port.__file__))}
    with torch.no_grad():
        det = load_serving_checkpoint(
            ckpt("yolo11n_seg_distill.msgpack"), (376, 1408), device=dev,
            dtype=torch.bfloat16, fold_weights=True)[0]
        images = frames(4, 376, 1408)
        times["n_ms"] = _times(lambda: det.forward(images), args.iters,
                               args.rounds)
        det = load_serving_checkpoint(
            ckpt("yolo11x_seg_distill.msgpack"), (376, 1408), tta="none",
            device=dev, dtype=torch.bfloat16, fold_weights=True)[0]
        images = frames(8, 376, 1408)
        times["x_ms"] = _times(lambda: det.forward(images), args.iters,
                               args.rounds)
        det = YoloDetector((375, 1242), YoloConfig(scale="x", segment=False),
                           seed=0, device=dev)
        images = frames(1, 375, 1242)
        times["kitti2d_ms"] = _times(lambda: det.forward(images),
                                     args.iters, args.rounds)
    print(json.dumps(times), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
