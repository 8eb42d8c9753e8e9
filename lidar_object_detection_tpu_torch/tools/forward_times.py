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
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", required=True,
                    help="root of a checkout holding checkpoints/")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
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
