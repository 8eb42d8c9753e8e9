"""The port's export paths against the JAX package's, on the CPU: the
per-point mask gather, the depth-map scatter and the runner's depth maps,
the depth-map figure's panels, the V2 analysis cloud, the PLY writers,
the colour tables and overlays, the segmentation-overlay directory (of
PNG and of JPEG images), and the CLI (``run`` of every version with
``--export-ply`` and ``--analysis-cloud``, and ``depth-maps``), on the
synthetic KITTI-360 tree of ``test_torch_matching.py`` (64 x 192 images,
D = 8, G = 48, P = 4096) written into a temporary directory.

Tolerances: none for words, depth maps, analysis-cloud points and
colours, PLY bytes and file names (bit-equal); 1e-5 m for the scene PLY's
box-corner rows (JAX transforms the corners by a matrix product, the port
by its own); 1/255 for the depth-figure panels, against what JAX's
``depth_map_figure`` computes before matplotlib draws (the port writes
8-bit PNGs).
"""

import dataclasses
import os
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_object_detection_tpu import config as jconfig
from lidar_object_detection_tpu.config import FusionConfig as JFusionConfig
from lidar_object_detection_tpu.config import PipelineVersion as JVersion
from lidar_object_detection_tpu.data.kitti360 import (
    Kitti360Dataset as JDataset)
from lidar_object_detection_tpu.eval import statistics as jstats
from lidar_object_detection_tpu.ops import masks as jmasks
from lidar_object_detection_tpu.ops.scatter import (
    scatter_depth_maps as jscatter)
from lidar_object_detection_tpu.pipelines import cli as jcli
from lidar_object_detection_tpu.pipelines import overlay as joverlay
from lidar_object_detection_tpu.pipelines import runner as jrunner
from lidar_object_detection_tpu.viz import export as jexport
from lidar_object_detection_tpu.viz import overlay as jviz
from lidar_object_detection_tpu_torch import config as tconfig
from lidar_object_detection_tpu_torch.config import (
    FusionConfig, PipelineVersion)
from lidar_object_detection_tpu_torch.data import Kitti360Dataset
from lidar_object_detection_tpu_torch.ops import masks
from lidar_object_detection_tpu_torch.ops.scatter import scatter_depth_maps
from lidar_object_detection_tpu_torch.pipelines import cli, overlay, runner
from lidar_object_detection_tpu_torch.utils.image import read_image_rgb
from lidar_object_detection_tpu_torch.utils.png import (read_png_rgb,
                                                        write_png_rgb)
from lidar_object_detection_tpu_torch.viz import export
from lidar_object_detection_tpu_torch.viz import overlay as viz_overlay
from test_torch_matching import H, JSMALL, SMALL, W, write_tree

T = torch.from_numpy
J = jnp.asarray
STAMP = "2026-01-01T00:00:00"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("export_tree"), seed=3)


def _pipelines(tree, version):
    jcfg = dataclasses.replace(JFusionConfig.for_version(JVersion(version)),
                               shapes=JSMALL)
    cfg = dataclasses.replace(
        FusionConfig.for_version(PipelineVersion(version)), shapes=SMALL)
    return (jrunner.FusionPipeline(JDataset(tree, shapes=JSMALL), jcfg),
            runner.FusionPipeline(Kitti360Dataset(tree, shapes=SMALL), cfg,
                                  device="cpu"))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# the mask gather and the depth-map scatter
# ---------------------------------------------------------------------------

def _scatter_inputs(rng, p=3000, d=5, h=20, w=30):
    u = rng.uniform(-3, w + 3, p).astype(np.float32)
    v = rng.uniform(-3, h + 3, p).astype(np.float32)
    u[:200] = np.floor(u[:200])                   # collisions on one pixel
    v[:200] = 7.0
    depth = rng.uniform(1, 40, p).astype(np.float32)
    valid = rng.random(p) > 0.2
    words = rng.integers(0, 2 ** 32, (h, w), dtype=np.uint64).astype(
        np.uint32)
    return u, v, depth, valid, words


def test_gather_mask_bits_matches_jax():
    rng = np.random.default_rng(0)
    u, v, _, valid, words = _scatter_inputs(rng)
    got = masks.gather_mask_bits(T(words.view(np.int32)), T(u), T(v),
                                 T(valid), 32).numpy()
    ref = np.asarray(jmasks.gather_mask_bits(J(words), J(u), J(v), J(valid),
                                             32))
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (32, len(u)) and 0 < got.mean() < 1
    # a batch gives each frame's
    both = masks.gather_mask_bits(
        T(np.stack([words, words[::-1]]).view(np.int32)),
        T(np.stack([u, u])), T(np.stack([v, v])), T(np.stack([valid, valid])),
        32).numpy()
    np.testing.assert_array_equal(both[0], ref)


def test_scatter_depth_maps_matches_jax():
    rng = np.random.default_rng(1)
    u, v, depth, valid, _ = _scatter_inputs(rng)
    car = rng.random((5, len(u))) > 0.4
    got = scatter_depth_maps(T(u), T(v), T(depth), T(car), T(valid), 20, 30)
    ref = np.asarray(jscatter(J(u), J(v), J(depth), J(car), J(valid), 20,
                              30))
    assert got.dtype == torch.float32 and got.shape == (5, 20, 30)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref > 0).mean() > 0.3 and (ref == 0).any()
    batched = scatter_depth_maps(T(np.stack([u, u[::-1].copy()])),
                                 T(np.stack([v, v[::-1].copy()])),
                                 T(np.stack([depth, depth[::-1].copy()])),
                                 T(np.stack([car, car[:, ::-1].copy()])),
                                 T(np.stack([valid, valid[::-1].copy()])),
                                 20, 30)
    np.testing.assert_array_equal(batched[0].numpy(), ref)
    np.testing.assert_array_equal(batched[1].numpy(), ref)


def test_depth_maps_match_jax(tree):
    jpipe, tpipe = _pipelines(tree, "depth_maps")
    ref = list(jpipe.depth_maps())
    got = list(tpipe.depth_maps(chunk=2))         # two chunks of frames
    assert len(got) == len(ref) >= 6
    for (f, c, dm, seg), (jf, jc, jdm, jseg) in zip(got, ref):
        assert (f, c) == (jf, jc)
        assert dm.dtype == np.float32
        np.testing.assert_array_equal(dm, jdm)
        np.testing.assert_array_equal(seg, jseg)
    # the given detections give the same maps, without images
    records = tpipe.dataset.load_frames()
    dets = tpipe.detect(records, tpipe.dataset.make_batch(records))
    again = list(tpipe.depth_maps(with_seg_images=False, detections=dets))
    assert [(f, c) for f, c, _, _ in again] == [(f, c) for f, c, _, _ in got]
    assert all(seg is None for *_, seg in again)
    for (_, _, a, _), (_, _, b, _) in zip(again, got):
        np.testing.assert_array_equal(a, b)


def test_depth_map_figure_panels(tmp_path):
    """The figure holds JAX's two panels within 1/255: matplotlib's jet of
    depth / max (the port's own table), and the segmented image with those
    colours where the depth is positive."""
    matplotlib = pytest.importorskip("matplotlib")
    cm = matplotlib.colormaps["jet"]
    np.testing.assert_allclose(viz_overlay.jet_table(256),
                               cm(np.arange(256))[:, :3], rtol=0, atol=1e-12)
    rng = np.random.default_rng(2)
    dm = np.where(rng.random((40, 70)) < 0.3,
                  rng.uniform(2, 30, (40, 70)), 0).astype(np.float32)
    dm[5, 5] = dm.max() * 1.5                 # the maximum maps to 1.0
    seg = rng.integers(0, 256, (40, 70, 3), dtype=np.uint8)
    # JAX's depth_map_figure, before it draws
    depth_image = cm(dm / dm.max())[..., :3]
    blended = seg.astype(np.float64) / 255.0
    blended[dm > 0] = depth_image[dm > 0]
    path = str(tmp_path / "0000000100,depth_map_car_03_.png")
    viz_overlay.depth_map_figure(dm, seg, 3, 100, path)
    fig = read_png_rgb(path).astype(np.float64) / 255.0
    assert fig.shape == (80, 70, 3)
    np.testing.assert_allclose(fig[:40], depth_image, rtol=0, atol=1 / 255)
    np.testing.assert_allclose(fig[40:], blended, rtol=0, atol=1 / 255)


# ---------------------------------------------------------------------------
# the analysis cloud and the PLY writers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["inside_outside", "car_color"])
def test_analysis_cloud_matches_jax(tree, mode):
    jpipe, tpipe = _pipelines(tree, "v2_stats")
    clouds = tpipe.analysis_clouds(mode=mode)
    assert [c[0] for c in clouds] == [100, 101, 102]
    green = 0
    for frame_id, pts, colors, corners in clouds:
        jpts, jcolors, jcorners = jpipe.analysis_cloud(frame_id, mode=mode)
        np.testing.assert_array_equal(pts, jpts)
        np.testing.assert_array_equal(colors, jcolors)
        assert len(corners) == len(jcorners) >= 1
        for a, b in zip(corners, jcorners):
            np.testing.assert_array_equal(a, b)
        green += int((colors == (0.0, 1.0, 0.0)).all(axis=1).sum())
    one = tpipe.analysis_cloud(101, mode=mode)
    np.testing.assert_array_equal(one[1], clouds[1][2])
    if mode == "inside_outside":
        assert green > 50
    with pytest.raises(ValueError, match="not loadable"):
        tpipe.analysis_cloud(99)


def test_write_ply_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    pts = rng.normal(0, 20, (300, 3)).astype(np.float32)
    colors = rng.random((300, 3))
    colors[:5] = (1.5, -0.2, 1.0)               # clipped
    edges = [(0, 1), (5, 299)]
    for args in ((pts,), (pts, colors), (pts, colors, edges), (pts[:0],)):
        export.write_ply(str(tmp_path / "t.ply"), *args)
        jexport.write_ply(str(tmp_path / "j.ply"), *args)
        assert _read(tmp_path / "t.ply") == _read(tmp_path / "j.ply")


def _split_ply(text):
    """(header lines, vertex rows, edge rows) of an ASCII PLY file."""
    lines = text.decode().splitlines()
    end = lines.index("end_header")
    n = int(lines[2].split()[-1])
    return lines[:end + 1], lines[end + 1:end + 1 + n], lines[end + 1 + n:]


def _same_scene(tpath, jpath, n_points):
    """Header, point rows and edges equal; box-corner rows within 1e-5 m
    and of the same colour."""
    th, tv, te = _split_ply(_read(tpath))
    jh, jv, je = _split_ply(_read(jpath))
    assert th == jh and te == je
    assert tv[:n_points] == jv[:n_points]
    a = np.array([r.split() for r in tv[n_points:]], float)
    b = np.array([r.split() for r in jv[n_points:]], float)
    assert a.shape == b.shape
    np.testing.assert_allclose(a[:, :3], b[:, :3], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(a[:, 3:], b[:, 3:])
    return len(te)


@pytest.mark.parametrize("version", ["v1_pointwise", "v5_projected"])
def test_export_fusion_scene_matches_jax(tree, tmp_path, version):
    jpipe, tpipe = _pipelines(tree, version)
    ref, got = jpipe.run(), tpipe.run()
    records = tpipe.dataset.load_frames()
    n_edges = 0
    for fr, jfr, rec in zip(got.frames, ref.frames, records):
        tpath, jpath = tmp_path / "t.ply", tmp_path / "j.ply"
        export.export_fusion_scene(str(tpath), rec.points[:, :3], None,
                                   fr.matched_pairs)
        jexport.export_fusion_scene(str(jpath), rec.points[:, :3], None,
                                    jfr.matched_pairs)
        n_edges += _same_scene(tpath, jpath, len(rec.points))
    assert n_edges >= 12 * 6
    assert export.box_edges("proto") == jexport.box_edges("proto")


# ---------------------------------------------------------------------------
# colours, overlays and the overlay directory
# ---------------------------------------------------------------------------

def test_colours_and_overlays_match_jax():
    rng = np.random.default_rng(5)
    assert viz_overlay.simple_colors(40) == jviz.simple_colors(40)
    assert viz_overlay.golden_colors(40) == jviz.golden_colors(40)
    words = rng.integers(0, 2 ** 32, 500, dtype=np.uint64).astype(np.uint32)
    words[:100] = 0
    inside = words & rng.integers(0, 2 ** 32, 500, dtype=np.uint64).astype(
        np.uint32)
    np.testing.assert_array_equal(
        viz_overlay.point_colors_from_bits(words.view(np.int32), 32),
        jviz.point_colors_from_bits(words, 32))
    for mode in ("inside_outside", "car_color"):
        np.testing.assert_array_equal(
            viz_overlay.analysis_cloud_colors(words.view(np.int32),
                                              inside.view(np.int32), 32,
                                              mode=mode),
            jviz.analysis_cloud_colors(words, inside, 32, mode=mode))
    image = rng.integers(0, 256, (30, 50, 3), dtype=np.uint8)
    mask_set = rng.random((4, 30, 50)) > 0.5
    np.testing.assert_array_equal(viz_overlay.overlay_masks(image, mask_set),
                                  jviz.overlay_masks(image, mask_set))
    boxes = np.array([[3, 4, 20, 25], [-5, 10, 70, 12], [40, 0, 49, 29]],
                     np.float32)
    np.testing.assert_array_equal(viz_overlay.draw_boxes(image, boxes),
                                  jviz.draw_boxes(image, boxes))


class _FixedDetector:
    """Detections of fixed seeded values for every image, as numpy arrays
    in the JAX package's schema (uint32 words) or the port's (int32)."""

    def __init__(self, words_dtype):
        rng = np.random.default_rng(6)
        d = 6
        x1 = rng.uniform(0, W - 60, d)
        y1 = rng.uniform(0, H - 30, d)
        self.out = {
            "boxes": np.stack([x1, y1, x1 + 50, y1 + 25], -1)[None].astype(
                np.float32),
            "det_valid": (rng.random(d) > 0.3)[None],
            "mask_bits": rng.integers(0, 2 ** d, (1, H, W)).astype(
                np.uint32).view(words_dtype)}

    def detect(self, images):
        assert images.shape[0] == 1
        return self.out


@pytest.mark.parametrize("pattern", ("*.png", "*.jpg"))
def test_segment_overlay_dir_matches_jax(tmp_path, pattern):
    """Overlays of PNG sources equal the JAX package's pixels (PIL writes
    other PNG bytes); of JPEG sources, the JAX package's JPEG bytes."""
    from PIL import Image

    rng = np.random.default_rng(7)
    ext = pattern[1:]
    src = tmp_path / "images"
    src.mkdir()
    names = ("a" + ext, "b" + ext)
    for name in names[::-1]:
        pixels = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        if ext == ".png":
            write_png_rgb(str(src / name), pixels)
        else:
            Image.fromarray(pixels).save(src / name)
    (src / ("c" + (".jpg" if ext == ".png" else ".png"))).write_bytes(b"")
    n = overlay.segment_overlay_dir(str(src), str(tmp_path / "t"),
                                    _FixedDetector(np.int32), pattern)
    jn = joverlay.segment_overlay_dir(str(src), str(tmp_path / "j"),
                                      _FixedDetector(np.uint32), pattern)
    assert n == jn == 2
    assert sorted(os.listdir(tmp_path / "t")) == list(names)
    for name in names:
        got = read_image_rgb(tmp_path / "t" / name)
        np.testing.assert_array_equal(
            got, np.asarray(Image.open(tmp_path / "j" / name).convert("RGB")))
        assert not np.array_equal(got, read_image_rgb(src / name))
        if ext == ".jpg":
            assert _read(tmp_path / "t" / name) == \
                _read(tmp_path / "j" / name)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture
def pinned(monkeypatch):
    """Both packages' per-version configs at the small shapes, the JAX
    master-CSV writer's clock at STAMP, and JAX's depth-map figure written
    as an empty file (its matplotlib figure at 2700 x 1800 pixels takes
    about a second; its panels are held in ``test_depth_map_figure_panels``
    above)."""
    for mod, shapes in ((jconfig, JSMALL), (tconfig, SMALL)):
        orig = mod.FusionConfig.for_version
        monkeypatch.setattr(mod.FusionConfig, "for_version", staticmethod(
            lambda v, orig=orig, shapes=shapes: dataclasses.replace(
                orig(v), shapes=shapes)))
    now = types.SimpleNamespace(isoformat=lambda: STAMP)
    monkeypatch.setattr(jstats, "datetime", types.SimpleNamespace(
        datetime=types.SimpleNamespace(now=lambda: now)))
    monkeypatch.setattr(jviz, "depth_map_figure",
                        lambda dm, seg, car, frame, path: open(path, "wb")
                        .close())


FRAME_LINE = re.compile(r"^frame (\d+): (\d+) detections, (\d+) visible "
                        r"boxes, (\d+) matched$", re.M)


def _frame_lines(text):
    return FRAME_LINE.findall(text)


@pytest.mark.parametrize("version", ["v1_pointwise", "v2_stats",
                                     "v3_erosion", "v4_iou", "v5_projected",
                                     "csv_eval"])
def test_cli_run_matches_jax_cli(tree, tmp_path, pinned, capsys, version):
    """The CLI's ``run`` writes JAX's file names and prints its matched
    counts (V5's grey boxes left out), for every version; with
    ``--export-ply --analysis-cloud inside_outside`` on V4 and V5 the
    scenes hold to JAX's as in ``test_export_fusion_scene_matches_jax``
    and the analysis clouds are byte-equal."""
    extra = (["--export-ply", "--analysis-cloud", "inside_outside"]
             if version in ("v4_iou", "v5_projected") else [])
    outs = {}
    for name, main, device in (("j", jcli.main, []),
                               ("t", cli.main, ["--device", "cpu"])):
        out = str(tmp_path / name)
        capsys.readouterr()
        assert main(["run", "--dataset", tree, "--version", version,
                     "--output", out, *device, *extra]) == 0
        outs[name] = (out, _frame_lines(capsys.readouterr().out))
    (jout, jlines), (tout, tlines) = outs["j"], outs["t"]
    assert tlines == jlines and len(tlines) == 3
    assert sum(int(m) for *_, m in tlines) >= 6
    names = sorted(os.listdir(tout))
    assert names == sorted(os.listdir(jout))
    has_csv = "master_car_statistics.csv" in names
    assert has_csv == (version in ("csv_eval", "v2_stats", "v3_erosion"))
    if has_csv:
        strip = lambda p: [r.rsplit(",", 1)[0]
                           for r in _read(p).decode().splitlines()]
        assert strip(os.path.join(tout, "master_car_statistics.csv")) == \
            strip(os.path.join(jout, "master_car_statistics.csv"))
    if extra:
        assert len([n for n in names if n.endswith(".ply")]) == 6
        records = Kitti360Dataset(tree, shapes=SMALL).load_frames()
        for rec in records:
            scene = f"frame_{rec.frame_id:010d}.ply"
            _same_scene(os.path.join(tout, scene),
                        os.path.join(jout, scene), len(rec.points))
            cloud = f"analysis_{rec.frame_id:010d}.ply"
            assert _read(os.path.join(tout, cloud)) == \
                _read(os.path.join(jout, cloud))


def test_cli_depth_maps_match_jax_cli(tree, tmp_path, pinned, capsys):
    counts = {}
    for name, main, device in (("j", jcli.main, []),
                               ("t", cli.main, ["--device", "cpu"])):
        capsys.readouterr()
        assert main(["depth-maps", "--dataset", tree, "--output",
                     str(tmp_path / name), *device]) == 0
        counts[name] = re.findall(r"wrote (\d+) depth maps",
                                  capsys.readouterr().out)
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert counts["t"] == counts["j"] == [str(len(names))]
    assert len(names) >= 6
    assert all(re.fullmatch(r"\d{10},depth_map_car_\d\d_\.png", n)
               for n in names)
    fig = read_png_rgb(str(tmp_path / "t" / names[0]))
    assert fig.shape == (2 * H, W, 3)
