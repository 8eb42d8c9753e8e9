"""The port's spans (``utils/profiling.py``: ``span``, ``new_chunk``,
``Tracer``) through a CPU ``FusionPipeline`` driven as
``FusionPipeline.stream``'s consumer drives it (``detect`` then ``fuse``,
a chunk at a time), with a small randomly initialised n-width
``YoloDetector`` under hflip TTA, on a synthetic KITTI-360 tree.

On the CPU the ``kernel.<name>`` spans do not run (the plain twins do)
and no span has CUDA events; the events' wiring is checked with a
stand-in for ``torch.cuda.Event``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from lidar_object_detection_tpu_torch.config import (
    FusionConfig, PipelineVersion, ShapeConfig)
from lidar_object_detection_tpu_torch.data import Kitti360Dataset
from lidar_object_detection_tpu_torch.models.yolo.detector import (
    YoloDetector)
from lidar_object_detection_tpu_torch.models.yolo.model import YoloConfig
from lidar_object_detection_tpu_torch.pipelines import runner
from lidar_object_detection_tpu_torch.utils import profiling

H, W = 96, 320
K = np.array([[140.0, 0.0, 160.0], [0.0, 140.0, 48.0], [0.0, 0.0, 1.0]])
SHAPES = dict(max_points=4096, max_detections=32, max_boxes=48,
              image_height=H, image_width=W)
CHUNKS = [[100, 101], [102, 103]]
# every span of a chunk on the CPU, with its parent
PARENT = {
    "detect": None, "detect.upload": "detect",
    "detect.preprocess": "detect", "detect.network": "detect",
    "detect.decode": "detect", "fuse": None, "fuse.upload": "fuse",
    "fuse.project": "fuse", "fuse.erode": "fuse", "fuse.gather": "fuse",
    "fuse.count": "fuse",
}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tracing_tree"))
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


def _pipeline(root):
    cfg = dataclasses.replace(
        FusionConfig.for_version(PipelineVersion.CSV_EVAL),
        shapes=ShapeConfig(**SHAPES), erosion_enabled=True)
    detector = YoloDetector((H, W), YoloConfig(scale="n"), imgsz=320,
                            conf=0.0, tta="hflip", device="cpu", seed=3)
    return runner.FusionPipeline(Kitti360Dataset(root, shapes=cfg.shapes),
                                 cfg, detector, device="cpu")


def _chunks(pipe, chunks=CHUNKS):
    """Each chunk's detections and fused outputs, and its batch."""
    out = []
    for ids in chunks:
        records = pipe.dataset.load_frames(ids)
        batch = pipe.dataset.make_batch(records)
        detections = pipe.detect(records, batch)
        out.append((batch, detections, pipe.fuse(batch, detections)))
    return out


@pytest.fixture(scope="module")
def traced(tree):
    """Two chunks with the tracer on (its records) and the same two with
    it off."""
    pipe = _pipeline(tree)
    tracer = profiling.enable_tracer()
    try:
        on = _chunks(pipe)
    finally:
        assert profiling.disable_tracer() is tracer
    return tracer.take(), on, _chunks(pipe)


@pytest.fixture()
def no_tracer():
    yield
    profiling.disable_tracer()


@pytest.mark.parametrize("name", sorted(PARENT))
def test_span_once_a_chunk_inside_its_parent(traced, name):
    records = traced[0]
    mine = [r for r in records if r.name == name]
    chunks = sorted({r.chunk for r in records})
    assert len(chunks) == len(CHUNKS) and chunks[0] >= 1
    assert sorted(r.chunk for r in mine) == chunks
    for r in mine:
        assert r.parent == PARENT[name]
        assert r.device_ms is None and r.start_ns <= r.end_ns
        if r.parent is not None:
            parent, = [p for p in records
                       if p.name == r.parent and p.chunk == r.chunk]
            assert parent.start_ns <= r.start_ns
            assert r.end_ns <= parent.end_ns


def test_spans_are_the_table_and_count_the_uploads(traced):
    records, on, _ = traced
    names = sorted(r.name for r in records)
    assert names == sorted(list(PARENT) * len(CHUNKS))
    for (batch, _, _), chunk in zip(on, sorted({r.chunk for r in records})):
        nbytes = {r.name: r.nbytes for r in records if r.chunk == chunk}
        images = len(batch.frame_ids) * H * W * 3
        assert nbytes["detect.upload"] == images
        assert nbytes["fuse.upload"] == (
            batch.points.nbytes + batch.point_valid.nbytes
            + batch.corners_cam0.nbytes + batch.box_valid.nbytes)
        assert sum(nbytes.values()) == nbytes["detect.upload"] + \
            nbytes["fuse.upload"]


def test_outputs_bit_equal_with_the_tracer_on_and_off(traced):
    _, on, off = traced
    for (_, det_on, fused_on), (_, det_off, fused_off) in zip(on, off):
        for a, b in ((det_on, det_off), (fused_on, fused_off)):
            assert a.keys() == b.keys()
            for k in a:
                assert torch.equal(a[k], b[k]), k
    assert any(bool(d["det_valid"].any()) for _, d, _ in on)


def _raise(*args, **kwargs):
    raise AssertionError("called with the tracer off")


def test_off_makes_no_event_no_range_and_no_record(tree, monkeypatch,
                                                   no_tracer):
    pipe = _pipeline(tree)
    tracer = profiling.enable_tracer()
    profiling.disable_tracer()
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    _chunks(pipe, CHUNKS[:1])
    first = profiling.span("detect.upload", torch.device("cuda"), nbytes=8)
    assert first is profiling.span("fuse") is profiling._NOOP
    with first:
        profiling.new_chunk()
    assert tracer.records == [] and tracer.chunk == 0


class _FakeEvent:
    """``torch.cuda.Event``'s part that the spans use."""

    def __init__(self, enable_timing):
        assert enable_timing
        self.at = None

    def record(self, stream):
        self.at = len(_FakeEvent.log)
        _FakeEvent.log.append(stream)

    def synchronize(self):
        assert self.at is not None

    def elapsed_time(self, end):
        return float(end.at - self.at)


@pytest.mark.parametrize("device,events", [("cuda", True), ("cpu", False),
                                           (None, False)])
def test_events_only_on_a_cuda_device(monkeypatch, no_tracer, device,
                                      events):
    _FakeEvent.log = []
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: f"stream of {device}")
    tracer = profiling.enable_tracer()
    profiling.new_chunk()
    with profiling.span("outer", device, nbytes=4):
        with profiling.span("inner", device):
            pass
    inner, outer = sorted(tracer.take(), key=lambda r: r.name)
    assert (outer.parent, inner.parent) == (None, "outer")
    assert (outer.chunk, inner.chunk, outer.nbytes) == (1, 1, 4)
    if events:
        # outer's events bracket inner's: 0, (1, 2), 3
        assert (outer.device_ms, inner.device_ms) == (3.0, 1.0)
        assert _FakeEvent.log == ["stream of cuda"] * 4
    else:
        assert outer.device_ms is inner.device_ms is None
        assert _FakeEvent.log == []
    assert tracer.take() == []


def test_take_keeps_open_spans(no_tracer):
    tracer = profiling.enable_tracer()
    with profiling.span("outer"):
        with profiling.span("inner"):
            pass
        assert [r.name for r in tracer.take()] == ["inner"]
    assert [r.name for r in tracer.take()] == ["outer"]


def test_a_profiler_capture_lists_the_ranges(tree, tmp_path, no_tracer):
    pipe = _pipeline(tree)
    profiling.enable_tracer()
    with profiling.trace(str(tmp_path / "trace")) as prof:
        _chunks(pipe, CHUNKS[:1])
    names = {e.name for e in prof.events()}
    assert {profiling.PREFIX + name for name in PARENT} <= names
