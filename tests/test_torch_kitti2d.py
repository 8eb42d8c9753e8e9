"""The port's KITTI 2D evaluation against the JAX package's, on the CPU.

* The loader on a synthetic KITTI_Selection tree: names, labels (the
  reference's int(float(x)) truncation), distances, intrinsics (3 x 3 and
  3 x 4 calib files, and none) and image pixels (the JAX package reads
  them with PIL) equal.
* Both distance functions against JAX with x64, equal to 1e-14 relative,
  infinities in the same places: ``dv == 0`` probes and the ``0 * inf``
  guard of a box centred on cx at the horizon.
* ``evaluate_image`` with its first-match quirk (one GT counted by two
  detections; a detection over two GTs takes the first), and
  ``result_lines`` equal as strings.
* ``run_kitti2d_eval`` with one stub ``detect_fn`` through both packages,
  on a tree of PNG images and on the same tree as JPEG:
  ``results_*.<ext>.txt`` byte-equal, totals equal, annotated images
  equal outside the union of the two packages' label rectangles (the JAX
  package draws its text with PIL's font, the port with its own bitmap
  font, so only the text and the rectangles' sizes differ).  A JPEG's
  difference reaches every pixel of the 16 x 16 MCUs the rectangles
  touch and, through the chroma's triangle upsampling, one pixel past
  them, so there the rectangles are widened that far; and each annotated
  ``.jpg`` is byte-equal to Pillow's ``save`` of the port's annotated
  pixels.
* The CLI's ``kitti2d --device cpu`` on a two-image tree, and a tree that
  mixes ``.png`` and ``.jpg`` images, listed and read as the JAX package
  lists and reads them.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lidar_object_detection_tpu.data.kitti2d import (
    Kitti2DDataset as JDataset)
from lidar_object_detection_tpu.eval import kitti2d as jeval
from lidar_object_detection_tpu.pipelines.kitti2d import (
    run_kitti2d_eval as jrun)
from lidar_object_detection_tpu_torch.data.kitti2d import Kitti2DDataset
from lidar_object_detection_tpu_torch.eval import kitti2d as teval
from lidar_object_detection_tpu_torch.pipelines import cli
from lidar_object_detection_tpu_torch.pipelines.kitti2d import (
    run_kitti2d_eval)
from lidar_object_detection_tpu_torch.utils.image import read_image_rgb
from lidar_object_detection_tpu_torch.utils.png import read_png_rgb
from lidar_object_detection_tpu_torch.viz import overlay

K3 = np.array([[721.5377, 0.0, 609.5593], [0.0, 721.5377, 172.854],
               [0.0, 0.0, 1.0]])
# a KITTI P2 projection matrix (3 x 4); only its 3 x 3 part is read
K34 = np.concatenate([K3, [[44.857], [0.2163], [0.0027]]], 1)
SHAPES = ((120, 400), (118, 392), (120, 404))


def _labels(rng, h, w, n):
    x1 = rng.uniform(0, w - 90, n)
    y1 = rng.uniform(10, h - 50, n)
    rows = [("Car", a, b, a + rng.uniform(30, 85), b + rng.uniform(20, 40),
             rng.uniform(5, 60)) for a, b in zip(x1, y1)]
    rows.append(("Car", 1.9, 2.5, 20.7, 15.99, 33.333))   # truncation
    return rows


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Three images of KITTI-like shapes (scaled down), cut from the
    committed frame; labels; a 3 x 3, a 3 x 4 and no calib file: one tree
    of PNG images and one of the same images as JPEG."""
    rng = np.random.default_rng(3)
    frame = read_png_rgb(chip_smoke.FRAMES[0])
    samples = []
    for i, ((h, w), calib) in enumerate(zip(SHAPES, (K3, K34, None))):
        image = np.ascontiguousarray(frame[150:150 + h, 300 + 40 * i:
                                           300 + 40 * i + w])
        samples.append((f"{i:06d}", image, _labels(rng, h, w, 3 + i),
                        calib))
    roots = {}
    for ext in ("png", "jpg"):
        roots[ext] = str(tmp_path_factory.mktemp(f"kitti2d_{ext}"))
        chip_smoke.write_kitti2d_tree(roots[ext], samples, "." + ext)
    return roots


@pytest.fixture(scope="module")
def tree(trees):
    return trees["png"]


def _stub_detect(tree):
    """Detections from each image's labels (found by the image's shape):
    each label jittered by a pixel or two, the first one twice (one GT
    counted by two detections), and two boxes over no label."""
    ds = Kitti2DDataset(tree)
    gt = {}
    for name in ds.sample_names():
        sample = ds.load(name)
        gt[ds.read_image(sample).shape[:2]] = sample.gt_boxes

    def detect(image):
        h, w = image.shape[:2]
        boxes = gt[(h, w)].astype(np.float64)
        rng = np.random.default_rng(h * w)
        jittered = boxes + rng.uniform(-2, 2, boxes.shape)
        extra = np.array([[w - 40, 2, w - 5, 30], [0, h - 30, 25, h - 1]])
        return np.concatenate([jittered, jittered[:1] + 1, extra]).astype(
            np.int64)
    return detect


def test_loader_matches_jax(tree):
    from PIL import Image

    jds, tds = JDataset(tree), Kitti2DDataset(tree)
    names = tds.sample_names()
    assert names == jds.sample_names() == ["000000", "000001", "000002"]
    for name in names:
        a, b = tds.load(name), jds.load(name)
        assert a.name == b.name and a.image_path == b.image_path
        np.testing.assert_array_equal(a.gt_boxes, b.gt_boxes)
        assert a.gt_boxes.dtype == b.gt_boxes.dtype == np.int64
        np.testing.assert_array_equal(a.gt_distances, b.gt_distances)
        if b.intrinsics is None:
            assert a.intrinsics is None
        else:
            np.testing.assert_array_equal(a.intrinsics, b.intrinsics)
        ref = np.asarray(Image.open(b.image_path).convert("RGB"))
        np.testing.assert_array_equal(tds.read_image(a), ref)
    assert tds.load("000000").gt_boxes[-1].tolist() == [1, 2, 20, 15]


def _probe_boxes(rng):
    """Random boxes, and boxes with a probe at v == cy (dv == 0) and a
    horizon box centred on cx (0 * inf in the bottom-centre variant)."""
    cx, cy = K3[0, 2], K3[1, 2]
    x1 = rng.uniform(0, 1100, 40)
    y1 = rng.uniform(0, 300, 40)
    boxes = np.stack([x1, y1, x1 + rng.uniform(5, 200, 40),
                      y1 + rng.uniform(5, 120, 40)], 1)
    special = np.array([[cx - 30, cy, cx + 30, cy + 40],     # y_min == cy
                        [cx - 20, cy - 40, cx + 20, cy],     # y_max == cy
                        [cx - 10, cy - 10, cx + 10, cy + 10],  # ym == cy
                        [cx - 15, cy, cx + 15, cy],          # flat horizon
                        [100, 10, 300, 80]])
    return np.concatenate([boxes, special])


@pytest.mark.parametrize("fn", ["monocular_distance",
                                "monocular_distance_bottom_center"])
def test_distances_match_jax(fn):
    boxes = _probe_boxes(np.random.default_rng(0))
    ref = np.asarray(getattr(jeval, fn)(jnp.asarray(K3), jnp.asarray(boxes)))
    got = getattr(teval, fn)(K3, boxes)
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-14, atol=0)
    assert np.isinf(ref).any() and fin.sum() > 30
    assert not np.isnan(got).any()


def test_bottom_center_guards_zero_times_inf():
    cx, cy = K3[0, 2], K3[1, 2]
    boxes = np.array([[cx - 15, cy - 20, cx + 15, cy]])
    ref = np.asarray(jeval.monocular_distance_bottom_center(
        jnp.asarray(K3), jnp.asarray(boxes)))
    got = teval.monocular_distance_bottom_center(K3, boxes)
    assert np.isinf(got).all() and np.isinf(ref).all()


def test_evaluate_image_first_match_quirk_matches_jax():
    gt = np.array([[100, 50, 200, 120], [105, 52, 205, 122],
                   [400, 60, 480, 130], [700, 80, 760, 120]])
    dist = np.array([12.5, 13.25, 30.0, 55.125])
    det = np.array([[102, 51, 203, 121],      # over GT 0 and 1: takes 0
                    [98, 49, 199, 119],       # GT 0 again: a second TP
                    [402, 61, 478, 131],      # GT 2
                    [900, 100, 950, 140]])    # FP
    ref = jeval.evaluate_image(det, gt, dist, K3)
    got = teval.evaluate_image(det, gt, dist, K3)
    assert (got.tp, got.fp, got.fn) == (ref.tp, ref.fp, ref.fn) == (3, 1, 1)
    assert got.result_lines() == ref.result_lines()
    assert [m.car_id for m in got.matches] == [1, 2, 3]
    np.testing.assert_array_equal(got.matches[0].gt_box, gt[0])
    np.testing.assert_array_equal(got.matches[1].gt_box, gt[0])
    assert got.precision == ref.precision and got.recall == ref.recall
    for a, b in zip(got.matches, ref.matches):
        assert (a.iou, a.yolo_distance, a.gt_distance) == \
            (b.iou, b.yolo_distance, b.gt_distance)
    empty = teval.evaluate_image(np.zeros((0, 4)), gt, dist, K3)
    assert (empty.tp, empty.fp, empty.fn, empty.recall) == (0, 0, 4, 0.0)


def _jax_label_rects(matches, precision, recall, shape):
    """(y0, y1, x0, x1) of the JAX package's label rectangles, from PIL's
    default font as its ``draw_label`` measures the text."""
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.load_default()
    draw = ImageDraw.Draw(Image.new("RGB", (8, 8)))
    h, w = shape[:2]
    rects = []
    for text, (x, y), *_ in overlay.kitti2d_labels(matches, precision,
                                                   recall, shape):
        left, top, right, bottom = draw.textbbox((0, 0), text, font=font)
        tw, th = right - left, bottom - top
        rects.append((max(y - th - 2, 0), min(y + 2, h), max(x, 0),
                      min(x + tw + 5, w)))
    return rects


def _mcu_widened(rect, shape, mcu=16):
    """A rectangle grown out to the MCU edges it touches, and one pixel
    past them (the chroma upsampling's reach)."""
    y0, y1, x0, x1 = rect
    h, w = shape[:2]
    return (max(y0 // mcu * mcu - 1, 0), min(-(-y1 // mcu) * mcu + 1, h),
            max(x0 // mcu * mcu - 1, 0), min(-(-x1 // mcu) * mcu + 1, w))


@pytest.mark.parametrize("ext", ("png", "jpg"))
def test_run_matches_jax_with_one_detector(trees, tmp_path, ext):
    from PIL import Image

    tree = trees[ext]
    jout, tout = str(tmp_path / "j"), str(tmp_path / "t")
    ref = jrun(tree, detect_fn=_stub_detect(tree), output_dir=jout)
    got = run_kitti2d_eval(tree, detect_fn=_stub_detect(tree),
                           output_dir=tout, device="cpu")
    assert got.totals == ref.totals
    assert got.totals["tp"] >= 2 and got.totals["fp"] >= 2
    names = sorted(os.listdir(jout))
    assert names == sorted(os.listdir(tout))
    assert [n for n in names if n.endswith(".txt")] == [
        f"results_{i:06d}.{ext}.txt" for i in range(3)]
    for name in names:
        if name.endswith(".txt"):
            with open(os.path.join(jout, name), "rb") as f:
                jtext = f.read()
            with open(os.path.join(tout, name), "rb") as f:
                assert f.read() == jtext
            continue
        assert name.endswith("." + ext)
        a = read_image_rgb(os.path.join(tout, name))
        b = read_image_rgb(os.path.join(jout, name))
        ev = got.evaluations[os.path.splitext(name)[0]]
        source = read_image_rgb(os.path.join(tree, "images", name))
        rects = [overlay.label_rect(text, pos, a.shape) for text, pos, *_
                 in overlay.kitti2d_labels(ev.matches, ev.precision,
                                           ev.recall, a.shape)]
        rects += _jax_label_rects(ev.matches, ev.precision, ev.recall,
                                  a.shape)
        if ext == "jpg":
            rects = [_mcu_widened(r, a.shape) for r in rects]
            annotated = overlay.annotate_kitti2d_image(
                source, ev.matches, ev.precision, ev.recall)
            pil_path = tmp_path / ("pil_" + name)
            Image.fromarray(annotated).save(pil_path)
            with open(os.path.join(tout, name), "rb") as f:
                assert f.read() == pil_path.read_bytes()
        outside = np.ones(a.shape[:2], bool)
        for y0, y1, x0, x1 in rects:
            outside[y0:y1, x0:x1] = False
        np.testing.assert_array_equal(a[outside], b[outside])
        assert (a != source).any()
        assert outside.mean() > 0.3


def test_draw_label_blends_as_jax():
    """The background blend, in float32, as the JAX package's: equal to
    its formula on the rectangle outside the text's pixels."""
    rng = np.random.default_rng(1)
    image = rng.integers(0, 256, (40, 200, 3), dtype=np.uint8)
    out = overlay.draw_label(image, "IoU: 0.93", (10, 25),
                             text_color=(219, 22, 107),
                             bg_color=(255, 255, 255))
    y0, y1, x0, x1 = overlay.label_rect("IoU: 0.93", (10, 25), image.shape)
    assert (y0, x0) == (25 - 8 - 2, 10) and y1 == 27
    patch = image[y0:y1, x0:x1].astype(np.float32)
    blend = (0.6 * np.float32(255) + (1 - 0.6) * patch).astype(np.uint8)
    text = np.all(out[y0:y1, x0:x1] == (219, 22, 107), axis=-1)
    assert text.sum() > 20
    np.testing.assert_array_equal(out[y0:y1, x0:x1][~text], blend[~text])
    keep = np.ones(image.shape[:2], bool)
    keep[y0:y1, x0:x1] = False
    np.testing.assert_array_equal(out[keep], image[keep])
    assert len(overlay.FONT) == 95


def test_cli_kitti2d_on_cpu(tmp_path, capsys):
    rng = np.random.default_rng(4)
    frame = read_png_rgb(chip_smoke.FRAMES[0])
    samples = [(f"{i:06d}", np.ascontiguousarray(frame[140:140 + h,
                                                       200:200 + w]),
                _labels(rng, h, w, 2), K3)
               for i, (h, w) in enumerate(SHAPES[:2])]
    root = str(tmp_path / "tree")
    chip_smoke.write_kitti2d_tree(root, samples)
    out = str(tmp_path / "out")
    assert cli.main(["kitti2d", "--dataset", root, "--output", out,
                     "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith("TP: ") and " FP: " in lines[-2] \
        and " FN: " in lines[-2]
    assert lines[-1].startswith("Precision: ") and "Recall: " in lines[-1]
    assert sorted(os.listdir(out)) == ["000000.png", "000001.png",
                                       "results_000000.png.txt",
                                       "results_000001.png.txt"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["kitti2d", "--dataset", root, "--output", out])


def test_jpg_is_listed_and_read(tmp_path):
    """A tree mixing ``.png`` and ``.jpg`` images: listed as the JAX
    package lists them, the JPEG read to PIL's pixels, and both packages'
    runs writing the same result files under the same names."""
    from PIL import Image

    root = str(tmp_path / "tree")
    frame = read_png_rgb(chip_smoke.FRAMES[0])
    chip_smoke.write_kitti2d_tree(root, [
        ("000000", np.ascontiguousarray(frame[100:140, 200:260]), None,
         None)])
    jpg = os.path.join(root, "images", "000001.jpg")
    Image.fromarray(np.ascontiguousarray(frame[60:117, 500:571])).save(
        jpg, quality=90)
    ds = Kitti2DDataset(root)
    assert ds.sample_names() == JDataset(root).sample_names() == [
        "000000", "000001"]
    np.testing.assert_array_equal(
        ds.read_image(ds.load("000001")),
        np.asarray(Image.open(jpg).convert("RGB")))
    outs = {}
    for key, run, kw in (("t", run_kitti2d_eval, {"device": "cpu"}),
                         ("j", jrun, {})):
        outs[key] = str(tmp_path / key)
        run(root, detect_fn=lambda im: np.array([[1, 1, 20, 12]]),
            output_dir=outs[key], write_images=False, **kw)
    names = sorted(os.listdir(outs["t"]))
    assert names == sorted(os.listdir(outs["j"])) == [
        "results_000000.png.txt", "results_000001.jpg.txt"]
    for name in names:
        with open(os.path.join(outs["t"], name), "rb") as f, \
                open(os.path.join(outs["j"], name), "rb") as g:
            assert f.read() == g.read()
