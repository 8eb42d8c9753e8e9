"""YOLO11-seg training and the distillation runner on the card, against
the port's own CPU path (the CPU path is held to the JAX package by
``test_torch_yolo_train.py``).  Marked ``cuda``: skipped where no card is
present.  Imports no JAX package, so that it collects on the card's
machine.

* one n step from the committed variables at (2, 192, 640) on the card
  against the CPU's: loss parts within ``chip_smoke.YOLO_STEP_LOSS_RTOL``
  relative, each gradient tensor within ``chip_smoke.YOLO_STEP_GRAD_TOL``
  of its largest entry, but the three that are 0 but for rounding, held
  on both devices within ``YOLO_ZERO_GRAD_SHARE`` of the step's largest
  gradient (``chip_smoke.check_yolo_grads``);
* loss parts on the card and the CPU with target distances by DFL bin
  edges and the center assigner's cells: within 1e-5 relative;
* the runner's ``main`` twice on the card: byte-equal checkpoints;
* ``--eval-only`` on the card and the CPU: the same TP, FP and FN.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda

needs_card = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA card")


def _targets(rng, b=2):
    boxes = np.zeros((b, 32, 4), np.float32)
    valid = np.zeros((b, 32), bool)
    for i in range(b):
        for j in range(6):
            w, h = rng.uniform(20, 200), rng.uniform(16, 120)
            x0, y0 = rng.uniform(0, 640 - w), rng.uniform(20, 172 - h)
            boxes[i, j] = (x0, y0, x0 + w, y0 + h)
            valid[i, j] = True
    return {"boxes": boxes, "classes": np.full((b, 32), 2, np.int32),
            "valid": valid,
            "masks": (rng.random((b, 32, 48, 160)) > 0.5).astype(np.float32)}


@needs_card
def test_card_step_matches_cpu_step():
    from lidar_object_detection_tpu_torch.pipelines import yolo_distill as yd
    from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
        read_flax_msgpack)
    from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

    variables = read_flax_msgpack(chip_smoke.CKPT)["variables"]
    images = yd.letterboxed(np.stack([read_png_rgb(p)
                                      for p in chip_smoke.FRAMES]), "cpu")
    targets = _targets(np.random.default_rng(0))
    card_parts, card_grads = chip_smoke.yolo_step_grads(
        torch, variables, images, targets, torch.device("cuda"))
    cpu_parts, cpu_grads = chip_smoke.yolo_step_grads(
        torch, variables, images, targets, "cpu")
    for key, value in cpu_parts.items():
        assert abs(card_parts[key] - value) <= \
            chip_smoke.YOLO_STEP_LOSS_RTOL * abs(value), key
    err, zero = chip_smoke.check_yolo_grads(card_grads, cpu_grads)
    print(f"card gradients within {err:.3g} of the CPU's; the leaves that "
          f"are 0 but for rounding at {zero} of the largest")


@needs_card
def test_card_losses_match_cpu_at_bin_edges():
    """Target distances a few ulps either side of DFL bin edges and of the
    center assigner's cells: the card's loss parts equal the CPU's
    within 1e-5 relative (sums of up to 1.3 M terms in another order; a
    bin or cell off by one moves a part by about 1e-3).  The quotients
    that are floored into bins and cells divide by device tensors, as
    IEEE divisions on both devices."""
    from lidar_object_detection_tpu_torch.parallel import train as ttrain

    rng = np.random.default_rng(3)
    levels = ((24, 80), (12, 40), (6, 20))
    centers, strides = ttrain._anchor_centers(levels)
    targets = _targets(rng)
    # box edges k strides (+- a few ulps) from an anchor's centre
    idx = rng.integers(0, len(centers), (2, 6))
    k = rng.integers(1, 6, (2, 6, 4)).astype(np.float32)
    c, st = centers.numpy()[idx], strides.numpy()[idx][..., None]
    edges = np.concatenate([c - k[..., :2] * st, c + k[..., 2:] * st], -1)
    ulps = rng.integers(-3, 4, edges.shape)
    edges = edges.astype(np.float32)
    toward = np.where(ulps < 0, -np.inf, np.inf).astype(np.float32)
    for step in range(3):
        edges = np.where(np.abs(ulps) > step, np.nextafter(edges, toward),
                         edges)
    targets["boxes"][:, :6] = np.clip(edges, 0, 640)
    outputs = {"box": [], "cls": [], "coef": []}
    for h, w in levels:
        outputs["box"].append(rng.normal(0, 2, (2, h, w, 64)))
        outputs["cls"].append(rng.normal(-3, 2, (2, h, w, 80)))
        outputs["coef"].append(rng.normal(0, 1, (2, h, w, 32)))
    outputs = {k: [torch.from_numpy(v.astype(np.float32)) for v in vs]
               for k, vs in outputs.items()}
    outputs["proto"] = torch.from_numpy(
        rng.normal(0, 1, (2, 48, 160, 32)).astype(np.float32))
    tg = {"boxes": torch.from_numpy(targets["boxes"]),
          "classes": torch.from_numpy(targets["classes"]).long(),
          "valid": torch.from_numpy(targets["valid"]),
          "masks": torch.from_numpy(targets["masks"])}
    dev = torch.device("cuda")
    on = lambda tree: {k: ([t.to(dev) for t in v] if isinstance(v, list)
                           else v.to(dev)) for k, v in tree.items()}
    for assigner in ("tal", "center"):
        _, cpu = ttrain.detection_loss(outputs, tg, 80, levels,
                                       assigner=assigner)
        _, card = ttrain.detection_loss(on(outputs), on(tg), 80, levels,
                                        assigner=assigner)
        for key, value in cpu.items():
            assert abs(float(card[key]) - float(value)) <= \
                1e-5 * abs(float(value)), (assigner, key)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = str(tmp_path_factory.mktemp("yolo_card") / "kitti360")
    chip_smoke.yolo_train_tree(torch, torch.device("cuda"), root)
    return root


def test_runner_twice_writes_the_same_bytes(tree, tmp_path):
    cache = str(tmp_path / "labels.npz")
    paths = []
    for run in ("a", "b"):
        ckpt = str(tmp_path / f"{run}.msgpack")
        chip_smoke.run_distill(["--dataset", tree, "--cache", cache,
                                "--ckpt", ckpt, "--steps", "4",
                                "--ema-decay", "0.9"])
        paths.append(ckpt)
    for suffix in ("", ".opt", ".json"):
        assert chip_smoke.read_bytes(paths[0] + suffix) == \
            chip_smoke.read_bytes(paths[1] + suffix), suffix


def test_card_evaluation_matches_cpu(tree, tmp_path):
    from lidar_object_detection_tpu_torch.models.yolo.model import (
        YoloConfig)
    from lidar_object_detection_tpu_torch.parallel.train import YoloTrainer
    from lidar_object_detection_tpu_torch.pipelines import yolo_distill as yd
    from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
        read_flax_msgpack)

    ckpt = str(tmp_path / "committed.msgpack")
    opt = YoloTrainer(YoloConfig(scale="n"), device="cpu").opt_state_dict()
    yd.save_ckpt(ckpt, read_flax_msgpack(chip_smoke.CKPT)["variables"], opt,
                 12000)
    cache = str(tmp_path / "labels.npz")
    counts = {}
    for device in ("cuda", "cpu"):
        counts[device] = chip_smoke.eval_counts(chip_smoke.run_distill(
            ["--dataset", tree, "--cache", cache, "--ckpt", ckpt,
             "--eval-only", "--device", device]))[0]
    assert counts["cuda"] == counts["cpu"] and counts["cpu"][0] > 0
    assert os.path.exists(cache)
