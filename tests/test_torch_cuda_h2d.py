"""The uploader of ``utils/h2d.py`` on a card: the ring's copies against
``.to()``, its stream order, and ``FusionPipeline``'s scans sent ahead
from ``detect`` to ``fuse``.  Every test here is marked ``cuda`` and
skips where ``torch.cuda.is_available()`` is False.

This file imports nothing of JAX, Flax or the JAX package, so that it
collects on the card's machine:

    python -m pytest tests/test_torch_cuda_h2d.py -m cuda

Tolerance: none.  Copies are bit-equal to ``.to()``, and the pipeline's
outputs with the scans sent ahead equal those of a ``fuse`` that copies
them itself.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda

H, W = 96, 320
K = np.array([[140.0, 0.0, 160.0], [0.0, 140.0, 48.0], [0.0, 0.0, 1.0]])
SHAPES = dict(max_points=4096, max_detections=32, max_boxes=48,
              image_height=H, image_width=W)
CHUNKS = [[100, 101], [102, 103]]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ring's slots are page-locked "
                    "and its copies run on a CUDA stream")
    return torch.device("cuda")


def _source(dtype, n, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.random(n) < 0.5
    if dtype == np.uint8:
        return rng.integers(0, 256, n, dtype=np.uint8)
    return rng.standard_normal(n).astype(dtype)


def _bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes())


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.bool_])
def test_staged_copies_equal_to(dev, dtype):
    from lidar_object_detection_tpu_torch.utils import h2d

    slot = h2d.SLOT_BYTES
    itemsize = np.dtype(dtype).itemsize
    sizes = [0, 1, slot // itemsize - 1, 3 * slot // itemsize + 5,
             h2d.SLOTS * slot // itemsize + 7]
    sources = [_source(dtype, n, n) for n in sizes]
    sources[3] = sources[3].reshape(-1, 1)
    outs = h2d.upload(sources, dev)
    for src, out in zip(sources, outs):
        assert out.device.type == "cuda"
        assert _bit_equal(out, torch.from_numpy(src).to(dev))


def test_pinned_on_card_and_strided_sources(dev):
    from lidar_object_detection_tpu_torch.utils import h2d

    pinned = torch.from_numpy(_source(np.float32, 3_000_001, 1)).pin_memory()
    on_card = torch.arange(1000, device=dev)
    strided = torch.from_numpy(_source(np.float32, 4000, 2)).reshape(
        40, 100)[:, ::3]
    a, b, c = h2d.upload([pinned, on_card, strided], dev)
    assert _bit_equal(a, pinned.to(dev))
    assert b.data_ptr() == on_card.data_ptr()
    assert _bit_equal(c, strided.to(dev))


def test_the_ring_is_made_once_and_kept(dev):
    from lidar_object_detection_tpu_torch.utils import h2d

    up = h2d.uploader(dev)
    assert up is h2d.uploader("cuda") is h2d.uploader(
        torch.device("cuda", torch.cuda.current_device()))
    ptrs = [s.data_ptr() for s in up._slots]
    assert all(s.is_pinned() for s in up._slots)
    assert len(ptrs) == h2d.SLOTS and up.slot_bytes == h2d.SLOT_BYTES
    src = _source(np.uint8, 5 * h2d.SLOT_BYTES, 3)
    for _ in range(2):
        out, = up.submit([src]).result()
        assert _bit_equal(out, torch.from_numpy(src).to(dev))
    assert [s.data_ptr() for s in h2d.uploader(dev)._slots] == ptrs


def test_copies_wait_for_the_callers_stream(dev):
    """The output's memory may come from a tensor freed on the caller's
    stream while a kernel still writes it: the side stream waits."""
    from lidar_object_detection_tpu_torch.utils import h2d

    n = 3 * h2d.SLOT_BYTES + 11
    src = _source(np.uint8, n, 4)
    for _ in range(3):
        old = torch.empty(n, dtype=torch.uint8, device=dev)
        torch.cuda._sleep(20_000_000)
        old.fill_(7)
        del old
        out, = h2d.upload([src], dev)
        assert _bit_equal(out, torch.from_numpy(src).to(dev))


def test_a_dropped_upload_does_not_write_into_reused_memory(dev):
    from lidar_object_detection_tpu_torch.utils import h2d

    n = 4 * h2d.SLOT_BYTES
    up = h2d.uploader(dev)
    for seed in range(3):
        handle = up.submit([_source(np.uint8, n, seed)])
        handle._job.done.wait(60)
        del handle
        fresh = torch.full((n,), 5, dtype=torch.uint8, device=dev)
        torch.cuda.synchronize()
        assert bool((fresh == 5).all())


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("h2d_tree"))
    rng = np.random.default_rng(5)
    frames = []
    for fid in sum(CHUNKS, []):
        x1 = rng.uniform(0, W - 70, 3)
        y1 = rng.uniform(10, H - 45, 3)
        dets = np.stack([x1, y1, x1 + 60, y1 + 35], -1)
        points, pvalid, corners, bvalid = chip_smoke.make_scene(
            rng, dets, np.ones(3, bool), num_points=SHAPES["max_points"],
            num_boxes=48, num_valid=40, intrinsics=K)
        image = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        frames.append((fid, image, points[pvalid], corners[bvalid]))
    chip_smoke.write_kitti360_tree(root, frames, K, W, H)
    return root


def _pipeline(root, device):
    from lidar_object_detection_tpu_torch.config import (
        FusionConfig, PipelineVersion, ShapeConfig)
    from lidar_object_detection_tpu_torch.data import Kitti360Dataset
    from lidar_object_detection_tpu_torch.models.yolo.detector import (
        YoloDetector)
    from lidar_object_detection_tpu_torch.models.yolo.model import (
        YoloConfig)
    from lidar_object_detection_tpu_torch.pipelines.runner import (
        FusionPipeline)

    cfg = dataclasses.replace(
        FusionConfig.for_version(PipelineVersion.CSV_EVAL),
        shapes=ShapeConfig(**SHAPES), erosion_enabled=True)
    detector = YoloDetector((H, W), YoloConfig(scale="n"), imgsz=320,
                            conf=0.0, tta="hflip", device=device, seed=3)
    return FusionPipeline(Kitti360Dataset(root, shapes=cfg.shapes), cfg,
                          detector, device=device)


def _scan_bytes(batch):
    return (batch.points.nbytes + batch.point_valid.nbytes
            + batch.corners_cam0.nbytes + batch.box_valid.nbytes)


def _host(tree_):
    return {k: v.cpu() for k, v in tree_.items()}


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert _bit_equal(a[k], b[k]), k


def test_scans_sent_ahead_change_no_output(dev, tree):
    """Each chunk: ``fuse`` of the batch ``detect`` saw (the scans sent
    ahead), of a copy of it (copied in ``fuse``), and again of the batch
    (the handle was taken: copied again) give the same outputs."""
    from lidar_object_detection_tpu_torch.utils import profiling

    pipe = _pipeline(tree, dev)
    tracer = profiling.enable_tracer()
    try:
        for ids in CHUNKS:
            records = pipe.dataset.load_frames(ids)
            batch = pipe.dataset.make_batch(records)
            det = pipe.detect(records, batch)
            hit = _host(pipe.fuse(batch, det))
            other = dataclasses.replace(batch)
            miss = _host(pipe.fuse(other, det))
            again = _host(pipe.fuse(batch, det))
            _same(hit, miss)
            _same(hit, again)
            det2 = pipe.detect(records, other)      # sent ahead for other
            _same(_host(det), _host(det2))
            _same(hit, _host(pipe.fuse(batch, det2)))  # not for batch
    finally:
        profiling.disable_tracer()
    records = tracer.take()
    chunks = sorted({r.chunk for r in records})
    assert len(chunks) == 2 * len(CHUNKS)
    for chunk in chunks:
        mine = [r for r in records if r.chunk == chunk]
        by = lambda name: [r for r in mine if r.name == name]
        prefetch, = by("detect.prefetch")
        assert prefetch.parent == "detect"
        assert prefetch.nbytes == _scan_bytes(batch)
        frames, = by("detect.upload")
        stages = by("h2d.stage")
        assert all(r.parent is None and r.device_ms is not None
                   for r in stages)
        assert [r.nbytes for r in by("fuse.upload")][0] in (
            0, prefetch.nbytes)
        assert sum(r.nbytes for r in stages) == frames.nbytes + sum(
            r.nbytes for r in by("fuse.upload")) + prefetch.nbytes
    first = [r.nbytes for r in records if r.name == "fuse.upload"
             and r.chunk == chunks[0]]
    assert first == [0, prefetch.nbytes, prefetch.nbytes]
    second = [r.nbytes for r in records if r.name == "fuse.upload"
              and r.chunk == chunks[1]]
    assert second == [prefetch.nbytes]


def test_the_pipeline_on_the_card_matches_the_cpu_rows(dev, tree):
    """``run`` on the card (detect, then the fuse that takes the scans
    sent ahead) and on the CPU write the same rows for the stub
    detector."""
    from lidar_object_detection_tpu_torch.config import (
        FusionConfig, PipelineVersion, ShapeConfig)
    from lidar_object_detection_tpu_torch.data import Kitti360Dataset
    from lidar_object_detection_tpu_torch.pipelines.runner import (
        FusionPipeline)

    cfg = dataclasses.replace(
        FusionConfig.for_version(PipelineVersion.CSV_EVAL),
        shapes=ShapeConfig(**SHAPES), erosion_enabled=True)
    rows = {}
    for name in ("cuda", "cpu"):
        pipe = FusionPipeline(Kitti360Dataset(tree, shapes=cfg.shapes), cfg,
                              device=name)
        rows[name] = [vars(r) for r in
                      pipe.run(sum(CHUNKS, [])).csv_rows]
    assert rows["cuda"] == rows["cpu"] and len(rows["cpu"]) > 0
