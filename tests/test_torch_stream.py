"""The port's streaming path (``FusionPipeline.stream``: the native
prefetcher, host compaction, the producer thread) and its ``MetricStore``
against the JAX package's, with each package's stub detector, on a
synthetic KITTI-360 tree of 360-degree sweeps written into a temporary
directory, on the CPU.

Tolerance: none.  Rows are equal frame by frame (frames come in the
prefetcher's completion order, so they are compared by frame id), with
and without compaction, at every chunk size; the store's JSONL and CSV
are equal byte for byte.
"""

import dataclasses
import os
import shutil
import threading
import time

import numpy as np
import pytest

import chip_smoke
from lidar_object_detection_tpu.config import FusionConfig as JFusionConfig
from lidar_object_detection_tpu.config import PipelineVersion as JVersion
from lidar_object_detection_tpu.config import ShapeConfig as JShapeConfig
from lidar_object_detection_tpu.data.kitti360 import (
    Kitti360Dataset as JDataset)
from lidar_object_detection_tpu.eval.statistics import (
    CarStatistics as JCarStatistics)
from lidar_object_detection_tpu.eval.store import MetricStore as JStore
from lidar_object_detection_tpu.pipelines import runner as jrunner
from lidar_object_detection_tpu_torch.config import (
    FusionConfig, PipelineVersion, ShapeConfig)
from lidar_object_detection_tpu_torch.data import Kitti360Dataset
from lidar_object_detection_tpu_torch.eval.statistics import (
    CarStatistics, append_to_master_csv)
from lidar_object_detection_tpu_torch.eval.store import MetricStore
from lidar_object_detection_tpu_torch.pipelines import runner

H, W = 96, 320
K = np.array([[140.0, 0.0, 160.0], [0.0, 140.0, 48.0], [0.0, 0.0, 1.0]])
SHAPES = dict(max_points=16384, max_detections=32, max_boxes=48,
              image_height=H, image_width=W)
STAMP = "2026-01-01T00:00:00"
WITH_BOXES = [100, 101, 102, 103, 104, 105]


def _scene(rng, surround=True):
    x1 = rng.uniform(0, W - 70, 3)
    y1 = rng.uniform(10, H - 45, 3)
    dets = np.stack([x1, y1, x1 + 60, y1 + 35], -1)
    return chip_smoke.make_scene(rng, dets, np.ones(3, bool),
                                 num_points=SHAPES["max_points"],
                                 num_boxes=48, num_valid=40, intrinsics=K,
                                 surround=surround)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Frames 100-105 with 360-degree sweeps; 106 without a box JSON; 107
    with an empty box list."""
    root = str(tmp_path_factory.mktemp("stream_tree"))
    rng = np.random.default_rng(3)
    frames = []
    for fid in WITH_BOXES + [106, 107]:
        points, pvalid, corners, bvalid = _scene(rng)
        image = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        frames.append((fid, image, points[pvalid],
                       None if fid == 106 else corners[bvalid]))
    chip_smoke.write_kitti360_tree(root, frames, K, W, H)
    with open(JDataset(root).bbox_path(107), "w") as f:
        f.write("[]")
    return root


def _pipelines(root):
    cfg = dataclasses.replace(
        FusionConfig.for_version(PipelineVersion.CSV_EVAL),
        shapes=ShapeConfig(**SHAPES))
    jcfg = dataclasses.replace(
        JFusionConfig.for_version(JVersion.CSV_EVAL),
        shapes=JShapeConfig(**SHAPES))
    return (runner.FusionPipeline(
        Kitti360Dataset(root, shapes=cfg.shapes), cfg, device="cpu"),
        jrunner.FusionPipeline(JDataset(root, shapes=jcfg.shapes), jcfg))


def _by_frame(stream):
    out = {}
    for fid, rows in stream:
        assert fid not in out
        out[int(fid)] = [vars(r) for r in rows]
    return out


@pytest.fixture(scope="module")
def reference(tree):
    """The port's ``run()`` over the whole tree in one batch, per frame."""
    pipe, _ = _pipelines(tree)
    result = pipe.run()
    return {f.frame_id: [vars(r) for r in f.statistics]
            for f in result.frames}


@pytest.mark.parametrize("compact", [True, False])
def test_stream_matches_jax(tree, reference, compact):
    pipe, jpipe = _pipelines(tree)
    got = _by_frame(pipe.stream(chunk=2, compact=compact))
    ref = _by_frame(jpipe.stream(chunk=2, compact=compact))
    assert sorted(got) == WITH_BOXES
    assert got == ref
    assert got == reference
    assert sum(r["matched_bbox_id"] >= 0 for rows in got.values()
               for r in rows) > 5


@pytest.mark.parametrize("chunk", [1, 2, 8])
def test_stream_rows_do_not_depend_on_chunk_or_compaction(tree, reference,
                                                          chunk):
    """Compacted rows equal uncompacted rows and ``run()``'s, at chunk
    sizes 1, 2 and all frames; one loader thread or three."""
    pipe, _ = _pipelines(tree)
    spec = pipe.compaction_spec()
    assert spec.max_out == SHAPES["max_points"] // 2
    for compact in (True, False):
        for threads in (1, 3):
            got = _by_frame(pipe.stream(chunk=chunk, compact=compact,
                                        num_threads=threads))
            assert got == reference, (compact, threads)


def test_compaction_culls_most_of_each_sweep(tree):
    from lidar_object_detection_tpu_torch.data.native import (
        load_scan_compacted)

    pipe, jpipe = _pipelines(tree)
    spec, jspec = pipe.compaction_spec(), jpipe.compaction_spec()
    np.testing.assert_array_equal(spec.proj, jspec.proj)
    assert (spec.width, spec.height, spec.depth_min, spec.depth_max,
            spec.max_out, spec.margin) == (
        jspec.width, jspec.height, jspec.depth_min, jspec.depth_max,
        jspec.max_out, jspec.margin)
    for fid in WITH_BOXES:
        path = pipe.dataset.scan_path(fid)
        n = load_scan_compacted(path, spec)[2]
        total = os.path.getsize(path) // 16
        assert 0.2 < n / total < 0.5, (fid, n, total)


def test_stub_stream_decodes_no_image(tree, monkeypatch):
    """With the stub detector the producer decodes no PNG
    (``images=None``)."""
    pipe, _ = _pipelines(tree)

    def refuse(batch):
        raise AssertionError("the stub stream decoded images")

    monkeypatch.setattr(pipe.dataset, "load_images", refuse)
    assert sorted(_by_frame(pipe.stream(chunk=4))) == WITH_BOXES


class _BlindDetector:
    """A detector that takes the decoded frames, as the YOLO detector does,
    keeps them, and finds nothing in them."""

    def __init__(self, max_detections):
        self.d, self.seen = max_detections, []

    def detect(self, images):
        self.seen.append(images)
        b, h, w, _ = images.shape
        return {"boxes": np.zeros((b, self.d, 4), np.float32),
                "scores": np.zeros((b, self.d), np.float32),
                "det_valid": np.zeros((b, self.d), bool),
                "mask_bits": np.zeros((b, h, w), np.int32)}


def test_stream_passes_decoded_images_to_the_detector(tree):
    """A detector other than the stub gets the producer's decoded frames,
    one array per chunk; a frame with no detection has no row."""
    pipe, _ = _pipelines(tree)
    pipe.detector = _BlindDetector(SHAPES["max_detections"])
    got = _by_frame(pipe.stream(chunk=4, num_threads=1))
    assert got == {fid: [] for fid in WITH_BOXES}
    assert [im.shape for im in pipe.detector.seen] == [(4, H, W, 3),
                                                       (2, H, W, 3)]
    ds = pipe.dataset
    frames = ds.load_images(ds.make_batch(ds.load_frames(WITH_BOXES)))
    seen = np.concatenate(pipe.detector.seen)
    assert sorted(frames.reshape(6, -1).sum(1)) == \
        sorted(seen.reshape(6, -1).sum(1))
    for image in seen:
        assert any(np.array_equal(image, f) for f in frames)


def _broken_tree(tree, tmp_path, what):
    root = str(tmp_path / "broken")
    shutil.copytree(tree, root)
    ds = Kitti360Dataset(root)
    if what == "scan":
        with open(ds.scan_path(103), "wb") as f:
            f.write(b"\0" * 70)
    elif what == "png":
        with open(ds.image_path(103), "r+b") as f:
            f.seek(60)
            f.write(b"\xff" * 200)
    else:               # a scan with more in-view points than the capacity
        points, pvalid, _, _ = _scene(np.random.default_rng(9),
                                      surround=False)
        points[pvalid].tofile(ds.scan_path(103))
    return root


@pytest.mark.parametrize("what", ["scan", "png", "overflow"])
def test_stream_raises_what_the_producer_hit(tree, tmp_path, what):
    """An IO or decode error reaches the consumer as the exception it is,
    never as a short stream; a scan over the compaction capacity raises
    rather than being truncated, and streams whole uncompacted."""
    root = _broken_tree(tree, tmp_path, what)
    pipe, jpipe = _pipelines(root)
    if what == "png":
        pipe.detector = _BlindDetector(SHAPES["max_detections"])
        from lidar_object_detection_tpu_torch.utils.png import read_png_rgb
        with pytest.raises(Exception) as direct:
            read_png_rgb(pipe.dataset.image_path(103))
        error, match = type(direct.value), None
    else:
        error, match = ValueError, ("16-byte points" if what == "scan"
                                    else "after compaction")
    seen = []
    with pytest.raises(error, match=match):
        for fid, _ in pipe.stream(chunk=2, num_threads=1):
            seen.append(fid)
    assert 103 not in seen and len(seen) < len(WITH_BOXES)
    if what != "png":
        with pytest.raises((OSError, ValueError)):
            list(jpipe.stream(chunk=2, num_threads=1))
    if what == "overflow":
        got = _by_frame(pipe.stream(chunk=2, compact=False))
        assert got == _by_frame(jpipe.stream(chunk=2, compact=False))
        assert sorted(got) == WITH_BOXES


def test_abandoned_stream_stops_its_producer(tree):
    """Dropping the generator after its first frame, while the producer
    waits on a full queue, ends the producer thread."""
    pipe, _ = _pipelines(tree)
    before = threading.active_count()
    gen = pipe.stream(chunk=1, num_threads=1)
    next(gen)
    time.sleep(0.5)                   # the producer fills the queue
    assert threading.active_count() == before + 1
    gen.close()
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before


# ---------------------------------------------------------------------------
# the metric store
# ---------------------------------------------------------------------------

def _rows(cls, rng, frame, n):
    rows = []
    for car in range(n):
        total = int(rng.integers(1, 500))
        inside = int(rng.integers(0, total + 1))
        pct = round(inside / total * 100.0, 2)
        rows.append(cls(frame=frame, car_id=car,
                        matched_bbox_id=int(rng.integers(-1, 9)),
                        total_points=total, points_inside_bbox=inside,
                        points_outside_bbox=total - inside,
                        inside_percentage=pct,
                        outside_percentage=round(100.0 - pct, 2)))
    return rows


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_metric_store_matches_jax(tmp_path):
    """Updates, a rerun of a frame with fewer rows, an empty frame and a
    reopen from disk: the same JSONL and CSV bytes as the JAX store."""
    stores = {}
    for name, store_cls, row_cls in (("t", MetricStore, CarStatistics),
                                     ("j", JStore, JCarStatistics)):
        rng = np.random.default_rng(5)
        path = str(tmp_path / name / "store.jsonl")
        store = store_cls(path)
        for frame, n in ((7, 3), (2, 4), (7, 1), (9, 0), (11, 2)):
            store.update_frame(frame, _rows(row_cls, rng, frame, n), STAMP)
        reopened = store_cls(path)
        assert reopened.rows() == store.rows()
        reopened.export_csv(str(tmp_path / name / "master.csv"))
        stores[name] = reopened
    assert stores["t"].frames == stores["j"].frames == [2, 7, 11]
    assert [r["car_id"] for r in stores["t"].rows()] == [0, 1, 2, 3, 0, 0, 1]
    for f in ("store.jsonl", "master.csv"):
        assert _read(tmp_path / "t" / f) == _read(tmp_path / "j" / f)
    assert not [p for p in os.listdir(tmp_path / "t") if p.startswith("tmp")]


def test_stream_into_store_is_idempotent(tree, tmp_path):
    """The stream's rows go into the store; a second stream into it leaves
    the same bytes; its CSV equals the master CSV written from the rows,
    and the JAX store fed the JAX stream's rows."""
    pipe, jpipe = _pipelines(tree)
    path = str(tmp_path / "store.jsonl")
    got = _by_frame(pipe.stream(chunk=4, store=MetricStore(path),
                                timestamp=STAMP))
    first = _read(path)
    _by_frame(pipe.stream(chunk=2, store=MetricStore(path), compact=False,
                          timestamp=STAMP))
    assert _read(path) == first
    MetricStore(path).export_csv(str(tmp_path / "store.csv"))
    rows = [CarStatistics(**r) for fid in sorted(got) for r in got[fid]]
    append_to_master_csv(rows, str(tmp_path / "rows.csv"), STAMP)
    assert _read(tmp_path / "store.csv") == _read(tmp_path / "rows.csv")
    jstore = JStore(str(tmp_path / "j.jsonl"))
    for fid, jrows in jpipe.stream(chunk=4):
        jstore.update_frame(fid, jrows, STAMP)
    jstore.export_csv(str(tmp_path / "j.csv"))
    assert _read(tmp_path / "j.csv") == _read(tmp_path / "store.csv")
