"""The multi-rank dry run: one real step of every sharded path, on tiny
shapes.

Counterpart of ``__graft_entry__.dryrun_multichip`` (``:39-253``).
:func:`dryrun_multichip` spawns ``n`` ranks in fresh processes under a
hard timeout (:func:`.distributed.spawn`: on the cards by default, over
NCCL, or over gloo where the ranks outnumber the cards; over gloo on the
CPU when asked for), builds the (data, model) mesh with ``model`` = 2
where ``n`` is even, and runs, at JAX's shapes:

1. one YOLO11n training step (8 classes, no mask head, 64 x 64, one
   image per ``data`` row), data parallel with the kernels sliced over
   ``model``;
2. point-sharded fusion of a V2-stats frame, then of a csv_eval frame
   with erosion (2048 points over ``model``);
3. one PointPillars data-parallel step (a 32 x 32 grid, 256 points a
   frame);
4. with ``model`` > 1, one pipeline step over a mesh of ``n`` stages.

Rank 0 marks each step as JAX's dry run marks it; a failed rank raises.

    python -m lidar_object_detection_tpu_torch.parallel.dryrun N \\
        [--device cuda|cpu] [--timeout S]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
import numpy as np
import torch

from lidar_object_detection_tpu_torch.parallel import distributed

_MODULE = "lidar_object_detection_tpu_torch.parallel.dryrun"


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: float = 480.0) -> None:
    """Run the dry run on ``n_devices`` local ranks, printing
    rank 0's marks; raises when a rank fails or the ranks exceed
    ``timeout`` seconds."""
    runs = distributed.spawn(f"{_MODULE}:_dryrun_rank", n_devices,
                             (n_devices, str(device)), timeout=timeout,
                             device=device)
    sys.stdout.write(runs[0].stdout)
    print(f"dryrun_multichip({n_devices}) OK ({n_devices} ranks, "
          f"{torch.device(device).type})", flush=True)


def _dryrun_rank(n_devices: int, device: str) -> None:
    import torch.distributed as dist

    from lidar_object_detection_tpu_torch.config import (
        FusionConfig, FusionParams, PipelineVersion, ShapeConfig)
    from lidar_object_detection_tpu_torch.models.pointpillars import (
        PillarGridConfig, PillarsConfig, PillarsTrainer)
    from lidar_object_detection_tpu_torch.models.yolo.model import (
        YoloConfig)
    from lidar_object_detection_tpu_torch.parallel import (
        YoloTrainer, make_mesh, pipeline_loss_fn, point_sharded_fuse_frame)

    t_start = time.perf_counter()

    def mark(step: str) -> None:
        if distributed.is_primary():
            print(f"[dryrun +{time.perf_counter() - t_start:6.1f}s] {step}",
                  flush=True)

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    assert dist.get_world_size() == n_devices
    model_parallel = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(dev.type, model_parallel=model_parallel)
    dp = n_devices // model_parallel
    mark("mesh ready")

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    # --- 1. the sharded training step (dp x tp) ---
    trainer = YoloTrainer(YoloConfig(scale="n", num_classes=8,
                                     segment=False),
                          image_size=(64, 64), max_targets=1, device=dev,
                          mesh=mesh)
    rng = np.random.default_rng(0)
    batch = dp   # one image per data-parallel row
    images = rng.random((batch, 64, 64, 3), np.float32)
    targets = {
        "boxes": np.tile(np.asarray([[[8.0, 8, 40, 40]]], np.float32),
                         (batch, 1, 1)),
        "classes": np.full((batch, 1), 2, np.int32),
        "valid": np.ones((batch, 1), bool),
    }
    metrics = trainer.train_step(images, targets)
    assert np.isfinite(float(metrics["loss"]))
    mark("yolo dp x tp train step done")

    # --- 2. point-sharded fusion (the scan axis over model) ---
    small = ShapeConfig(max_points=2048, max_detections=32, max_boxes=8,
                        image_height=96, image_width=512)
    cfg = dataclasses.replace(
        FusionConfig.for_version(PipelineVersion.V2_STATS), shapes=small)
    params = FusionParams.from_config(cfg)
    p = 1024 * model_parallel
    points = rng.normal(size=(p, 4)).astype(np.float32) * 10
    corners = np.zeros((8, 8, 3), np.float32)
    corners[0] = [[0, 0, 8], [2, 0, 8], [2, 4, 8], [0, 4, 8],
                  [0, 0, 9.5], [2, 0, 9.5], [2, 4, 9.5], [0, 4, 9.5]]
    box_valid = np.zeros(8, bool)
    box_valid[0] = True
    eye = t(np.eye(4, dtype=np.float32))
    intr = t(np.asarray([[200.0, 0, 256], [0, 200, 48], [0, 0, 1]],
                        np.float32))
    out = point_sharded_fuse_frame(
        mesh, t(points), t(np.ones(p, bool)),
        t(np.zeros((96, 512), np.int32)), t(np.zeros(32, bool)),
        t(corners), t(box_valid), eye, eye, intr, params)
    assert tuple(out["counts"].shape) == (32, 8)
    mark("point-sharded fusion done")

    # --- 2a. the same, erosion on (csv_eval): the packed words are eroded
    # once before the point shards gather them ---
    cfg_e = dataclasses.replace(
        FusionConfig.for_version(PipelineVersion.CSV_EVAL), shapes=small)
    assert cfg_e.erosion_enabled
    mask_bits = np.zeros((96, 512), np.int32)
    mask_bits[20:60, 100:400] = 1          # detection 0 covers a block
    det_valid = np.zeros(32, bool)
    det_valid[0] = True
    out_e = point_sharded_fuse_frame(
        mesh, t(points), t(np.ones(p, bool)), t(mask_bits), t(det_valid),
        t(corners), t(box_valid), eye, eye, intr,
        FusionParams.from_config(cfg_e))
    assert tuple(out_e["counts"].shape) == (32, 8)
    mark("point-sharded fusion (erosion) done")

    # --- 2b. the PointPillars data-parallel step ---
    tiny = PillarsConfig(
        grid=PillarGridConfig(x_range=(0.0, 10.24), y_range=(-5.12, 5.12),
                              pillar_size=0.32),
        embed_dim=8, backbone_channels=(8, 16, 32),
        backbone_layers=(1, 1, 1), up_channels=8)
    pp_trainer = PillarsTrainer(tiny, device=dev, mesh=mesh)
    pts = rng.uniform(0, 10, (dp, 256, 4)).astype(np.float32)
    pts[..., 1] = rng.uniform(-5, 5, (dp, 256))
    pts[..., 2] = rng.uniform(-2.5, 0.5, (dp, 256))
    gt7 = np.zeros((dp, 4, 7), np.float32)
    gt7[:, 0] = [5.0, 0.0, -1.0, 1.6, 3.9, 1.5, 0.2]
    gv = np.zeros((dp, 4), bool)
    gv[:, 0] = True
    m = pp_trainer.train_step(pts, np.ones((dp, 256), bool), gt7,
                              np.zeros((dp, 4), np.int32), gv)
    assert np.isfinite(float(m["loss"]))
    mark("pointpillars dp train step done")

    # --- 3. the pipeline-parallel step (GPipe over model) ---
    if model_parallel > 1:
        pp_mesh = make_mesh(dev.type, model_parallel=n_devices)
        s, d = n_devices, 8
        stage_params = {
            "w": t(rng.normal(0, 0.5, (s, d, d)).astype(np.float32)),
            "b": t(np.zeros((s, d), np.float32))}
        for v in stage_params.values():
            v.requires_grad_(True)
        xs = t(rng.normal(size=(3, 2, d)).astype(np.float32))
        ys = t(np.zeros((3, 2, d), np.float32))
        loss_fn = pipeline_loss_fn(
            pp_mesh, lambda prm, h: torch.relu(h @ prm["w"] + prm["b"]),
            lambda o, tgt: torch.mean((o - tgt) ** 2))
        val = loss_fn(stage_params, xs, ys)
        grads = torch.autograd.grad(val, list(stage_params.values()))
        assert np.isfinite(float(val))
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        mark("pipeline-parallel step done")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lidar_object_detection_tpu_torch.parallel.dryrun",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8,
                    help="ranks (default 8)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--timeout", type=float, default=480.0)
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, device=args.device, timeout=args.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
