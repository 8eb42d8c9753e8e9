"""The streaming path on a card: ``FusionPipeline.stream`` with the native
prefetcher and host compaction, its kernels launched once per chunk, and
the rows a CPU stream writes.  Every test here is marked ``cuda`` and skips
where ``torch.cuda.is_available()`` is False.

This file imports nothing of JAX, Flax or the JAX package, so that it
collects on the card's machine:

    python -m pytest tests/test_torch_cuda_stream.py -m cuda

Tolerance: none.  The card's rows equal the CPU's (stub detector), and the
headline's compacted rows equal its uncompacted rows and ``run()``'s.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def test_stub_stream_on_card_writes_the_cpu_rows(dev, tmp_path):
    """The stub detector's stream over 360-degree sweeps, compacted and
    not: the card (K1 once per chunk) and the CPU (the twin) give the same
    rows for every frame."""
    from lidar_object_detection_tpu_torch.config import (
        FusionConfig, PipelineVersion, ShapeConfig)
    from lidar_object_detection_tpu_torch.data import Kitti360Dataset
    from lidar_object_detection_tpu_torch.ops import kernel_lib
    from lidar_object_detection_tpu_torch.pipelines.runner import (
        FusionPipeline)

    k = np.array([[140.0, 0.0, 160.0], [0.0, 140.0, 48.0], [0, 0, 1.0]])
    rng = np.random.default_rng(2)
    frames = []
    for fid in range(5):
        x1 = rng.uniform(0, 250, 3)
        y1 = rng.uniform(10, 50, 3)
        dets = np.stack([x1, y1, x1 + 60, y1 + 35], 1)
        points, pvalid, corners, bvalid = chip_smoke.make_scene(
            rng, dets, np.ones(3, bool), num_points=16384, num_boxes=48,
            num_valid=40, intrinsics=k, surround=True)
        frames.append((fid, np.zeros((96, 320, 3), np.uint8),
                       points[pvalid], corners[bvalid]))
    root = str(tmp_path / "kitti360")
    chip_smoke.write_kitti360_tree(root, frames, k, 320, 96)
    cfg = dataclasses.replace(
        FusionConfig.for_version(PipelineVersion.CSV_EVAL),
        shapes=ShapeConfig(max_points=16384, max_boxes=48, image_height=96,
                           image_width=320))
    rows = {}
    for name in ("cuda", "cpu"):
        pipe = FusionPipeline(Kitti360Dataset(root, shapes=cfg.shapes), cfg,
                              device=name)
        for compact in (True, False):
            kernel_lib.reset_launches()
            got = {fid: [vars(r) for r in out] for fid, out in
                   pipe.stream(chunk=2, compact=compact)}
            rows[name, compact] = got
            launched = kernel_lib.LAUNCHES["inside_counts"]
            assert launched == (3 if name == "cuda" else 0)
    first = rows["cuda", True]
    assert sorted(first) == list(range(5))
    assert all(got == first for got in rows.values())
    assert sum(r["matched_bbox_id"] >= 0 for v in first.values()
               for r in v) > 5


def test_headline_stream_on_card(dev, tmp_path):
    """``chip_smoke.py``'s headline stream: the x checkpoint, single view,
    folded bf16, 8 frames in one chunk: every kernel once, the compacted
    rows equal to the uncompacted stream's and ``run()``'s, the store's
    CSV to the rows', and a scan over the capacity raises; then 32 frames
    in 4 chunks: every kernel once per chunk."""
    detector, _ = chip_smoke.load_headline(torch, dev)
    launches, times, _ = chip_smoke.headline_stream(
        torch, dev, np.random.default_rng(1), detector,
        os.path.join(str(tmp_path), "kitti360"))
    # the serving path's kernels; V5's solver and the PointPillars
    # rotated NMS never run here
    assert launches == {"inside_counts": 1, "mask_assemble": 1,
                        "mask_count": 1, "nms": 1, "lap": 0,
                        "rotated_nms": 0}
    assert 0.2 < times["kept_share"] < 0.5
    assert times["frames_many"] == 32
    assert times["launches_many"] == {k: 4 * n for k, n in launches.items()}
