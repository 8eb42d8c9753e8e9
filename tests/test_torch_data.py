"""The port's KITTI-360 loading against the JAX package's, on a synthetic
KITTI-360 tree written into a temporary directory: calibration matrices,
skip rules, ``FrameBatch`` arrays, decoded images (PNG, and JPEG under a
``.png`` name, which PIL opens by content) and the stub detector.
Also ``utils/png.py`` against PIL, on the committed camera frames and on
small PNGs of every row filter, colour type, bit depth and Adam7.

Tolerance: none.  Every array, matrix and pixel is equal.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from lidar_object_detection_tpu.config import ShapeConfig as JShapeConfig
from lidar_object_detection_tpu.data import calib as jcalib
from lidar_object_detection_tpu.data.kitti360 import (
    Kitti360Dataset as JDataset)
from lidar_object_detection_tpu.models.stub import StubDetector as JStub
from lidar_object_detection_tpu_torch.config import ShapeConfig
from lidar_object_detection_tpu_torch.data import calib
from lidar_object_detection_tpu_torch.data import Kitti360Dataset
from lidar_object_detection_tpu_torch.models.stub import StubDetector
from lidar_object_detection_tpu_torch.utils.png import (
    png_filter_rows, read_png_rgb, write_png_rgb)

H, W = 96, 320
K = np.array([[140.0, 0.0, 160.0], [0.0, 140.0, 48.0], [0.0, 0.0, 1.0]])
SHAPES = dict(max_points=4096, max_detections=32, max_boxes=48,
              image_height=H, image_width=W)
KEPT = [3, 5, 8]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Frames 3, 5, 8 load; 9 has no box JSON, 11 no image, 12 an empty box
    list and 13 an unreadable scan."""
    root = tmp_path_factory.mktemp("kitti360")
    rng = np.random.default_rng(0)
    frames = []
    for fid in (3, 5, 8, 9, 11, 12, 13):
        x1 = rng.uniform(0, W - 60, 4)
        y1 = rng.uniform(20, H - 40, 4)
        dets = np.stack([x1, y1, x1 + 50, y1 + 30], 1)
        points, pvalid, corners, bvalid = chip_smoke.make_scene(
            rng, dets, np.ones(4, bool), num_points=4096, num_boxes=48,
            num_valid=30, intrinsics=K)
        image = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        frames.append((fid, None if fid == 11 else image, points[pvalid],
                       None if fid == 9 else corners[bvalid]))
    chip_smoke.write_kitti360_tree(str(root), frames, K, W, H)
    ds = JDataset(str(root))
    with open(ds.bbox_path(12), "w") as f:
        f.write("[]")
    with open(ds.scan_path(13), "wb") as f:
        f.write(b"\0" * 10)
    return str(root)


def test_calibration_matches_jax(tree):
    cam = calib.load_perspective_camera(tree, 0)
    jcam = jcalib.load_perspective_camera(tree, 0)
    np.testing.assert_array_equal(cam.intrinsics, jcam.intrinsics)
    np.testing.assert_array_equal(cam.rect, jcam.rect)
    assert (cam.width, cam.height) == (jcam.width, jcam.height) == (W, H)
    chain = calib.build_transform_chain(tree, cam)
    jchain = jcalib.build_transform_chain(tree, jcam)
    for field in ("velo_to_cam", "cam_to_velo", "velo_to_rect",
                  "corners_cam0_to_cam", "corners_to_velo"):
        np.testing.assert_array_equal(getattr(chain, field),
                                      getattr(jchain, field))
    np.testing.assert_allclose(chain.velo_to_rect, chip_smoke.VELO_TO_RECT,
                               atol=1e-12)
    path = f"{tree}/calibration/calib_cam_to_velo.txt"
    np.testing.assert_array_equal(calib.load_calibration_rigid(path),
                                  jcalib.load_calibration_rigid(path))
    path = f"{tree}/calibration/calib_cam_to_pose.txt"
    got = calib.load_calibration_camera_to_pose(path)
    ref = jcalib.load_calibration_camera_to_pose(path)
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key])
    pts = np.random.default_rng(1).uniform(-5, 20, (3, 50))
    pts[2, 0] = 0.0                      # the devkit's zero-depth rule
    for a, b in zip(cam.cam2image(pts), jcam.cam2image(pts)):
        np.testing.assert_array_equal(a, b)


def test_frame_batch_matches_jax(tree):
    ds = Kitti360Dataset(tree, shapes=ShapeConfig(**SHAPES))
    jds = JDataset(tree, shapes=JShapeConfig(**SHAPES))
    assert ds.frame_ids() == jds.frame_ids() == [3, 5, 8, 9, 11, 12, 13]
    records = ds.load_frames()
    jrecords = jds.load_frames()
    assert [r.frame_id for r in records] == [r.frame_id for r in jrecords]
    batch = ds.make_batch(records)
    jbatch = jds.make_batch(jrecords)
    for field in ("frame_ids", "points", "point_valid", "corners_cam0",
                  "box_valid"):
        a, b = getattr(batch, field), getattr(jbatch, field)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert batch.image_paths == jbatch.image_paths
    np.testing.assert_array_equal(ds.load_images(batch),
                                  jds.load_images(jbatch))
    assert ds.tight_shapes() == ShapeConfig(**vars(jds.tight_shapes()))


def test_skip_rules(tree):
    ds = Kitti360Dataset(tree, shapes=ShapeConfig(**SHAPES))
    assert [r.frame_id for r in ds.load_frames()] == KEPT
    for fid in (9, 11, 12, 13):
        assert ds.load_frame(fid) is None
    no_image = ds.load_frame(11, require_image=False)
    assert no_image.image_path is None and no_image.num_boxes > 0
    no_boxes = ds.load_frame(9, require_boxes=False)
    assert no_boxes.num_boxes == 0 and no_boxes.corners_cam0.shape == (0, 8,
                                                                        3)
    assert ds.load_frame(13, require_boxes=False) is None
    batch = ds.make_batch([no_image])
    assert ds.load_images(batch).sum() == 0


@pytest.mark.parametrize("fid", [3, 5, 8, 9, 11, 12, 13, 42])
def test_box_reads_match_jax(tree, fid):
    """``load_bboxes_exists`` and ``load_boxes``, the streaming path's box
    reads: frame 9 has no box JSON, 12 an empty list, 42 nothing at all;
    13's boxes read though its scan does not."""
    ds = Kitti360Dataset(tree, shapes=ShapeConfig(**SHAPES))
    jds = JDataset(tree, shapes=JShapeConfig(**SHAPES))
    assert ds.load_bboxes_exists(fid) == jds.load_bboxes_exists(fid)
    assert ds.load_bboxes_exists(fid) == (fid not in (9, 42))
    got, want = ds.load_boxes(fid), jds.load_boxes(fid)
    if fid in (9, 12, 42):
        assert got is None and want is None
        return
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] == 30
    if fid != 13:                     # 13's scan is unreadable
        np.testing.assert_array_equal(
            got, ds.load_frame(fid, require_image=False).corners_cam0)


def test_image_cache_serves_the_same_pixels(tree, tmp_path):
    ds = Kitti360Dataset(tree, shapes=ShapeConfig(**SHAPES))
    cached = Kitti360Dataset(tree, shapes=ShapeConfig(**SHAPES),
                             image_cache_dir=str(tmp_path / "cache"))
    batch = ds.make_batch(ds.load_frames())
    want = ds.load_images(batch)
    np.testing.assert_array_equal(cached.load_images(batch), want)
    assert len(list((tmp_path / "cache").iterdir())) == len(KEPT)
    np.testing.assert_array_equal(cached.load_images(batch), want)


def test_jpeg_frames_load_as_jax(tree, tmp_path):
    """A frame whose ``.png`` holds a JPEG (PIL opens by content) decodes
    to the JAX loader's pixels, directly and through the image cache."""
    import shutil

    root = str(tmp_path / "tree")
    shutil.copytree(tree, root)
    ds = Kitti360Dataset(root, shapes=ShapeConfig(**SHAPES))
    jds = JDataset(root, shapes=JShapeConfig(**SHAPES))
    for fid, options in ((3, {}), (5, {"progressive": True}),
                         (8, {"subsampling": "4:4:4", "quality": 90})):
        path = ds.image_path(fid)
        Image.open(path).convert("RGB").save(path, format="JPEG", **options)
    batch = ds.make_batch(ds.load_frames())
    want = jds.load_images(jds.make_batch(jds.load_frames()))
    png = Kitti360Dataset(tree, shapes=ShapeConfig(**SHAPES))
    assert not np.array_equal(                                # lossy
        want, png.load_images(png.make_batch(png.load_frames())))
    np.testing.assert_array_equal(ds.load_images(batch), want)
    cached = Kitti360Dataset(root, shapes=ShapeConfig(**SHAPES),
                             image_cache_dir=str(tmp_path / "cache"))
    for _ in range(2):
        np.testing.assert_array_equal(cached.load_images(batch), want)


def test_stub_detector_matches_jax(tree, tmp_path):
    ds = Kitti360Dataset(tree, shapes=ShapeConfig(**SHAPES))
    jds = JDataset(tree, shapes=JShapeConfig(**SHAPES))
    got = StubDetector(ds.camera, depth_range=(0.0, 50.0)).detect_records(
        ds.load_frames())
    ref = JStub(jds.camera, depth_range=(0.0, 50.0)).detect_records(
        jds.load_frames())
    assert got["mask_bits"].dtype == np.int32
    for key in ("boxes", "scores", "det_valid"):
        np.testing.assert_array_equal(got[key], ref[key])
    np.testing.assert_array_equal(got["mask_bits"],
                                  ref["mask_bits"].view(np.int32))
    assert got["det_valid"].sum(axis=1).min() >= 2

    path = str(tmp_path / "rec.npz")
    JStub.save_recording(path, ref, np.asarray(KEPT))
    back = StubDetector.load_recording(path, frame_ids=KEPT[::-1])
    for key in got:
        np.testing.assert_array_equal(back[key], got[key][::-1])


# ---------------------------------------------------------------------------
# utils/png.py
# ---------------------------------------------------------------------------

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _filter_rows(rows, filt, bpp):
    """Filter (H, row_bytes) int64 bytes; ``filt`` is one filter for every
    row, or a sequence with one per row."""
    prev = np.zeros(rows.shape[1], np.int64)
    out = []
    for y, cur in enumerate(rows):
        f = filt if isinstance(filt, int) else filt[y % len(filt)]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - up_left
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, up_left))
        out.append(bytes([f]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def _pack_rows(samples, depth):
    """(H, W, C) integer samples -> (H, row_bytes) int64 bytes."""
    h, w, c = samples.shape
    if depth == 8:
        return samples.reshape(h, w * c).astype(np.int64)
    if depth == 16:
        be = samples.astype(">u2").reshape(h, w * c).view(np.uint8)
        return be.reshape(h, 2 * w * c).astype(np.int64)
    bits = (samples.reshape(h, w * c, 1).astype(np.uint8)
            >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1
    return np.packbits(bits.reshape(h, -1), axis=1).astype(np.int64)


def _png_file(w, h, depth, color, interlace, idat, plte=None):
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                         interlace))
            + (chunk(b"PLTE", plte) if plte is not None else b"")
            + chunk(b"IDAT", zlib.compress(idat))
            + chunk(b"IEND", b""))


def _png(image, filt, depth=8, color=None, interlace=0, plte=None):
    """Encode (H, W, C) samples of ``depth`` bits, every row under filter
    ``filt`` (or the filters of a sequence in turn), Adam7-interlaced
    when ``interlace`` is 1."""
    h, w, c = image.shape
    color = {3: 2, 4: 6}[c] if color is None else color
    bpp = max(1, c * depth // 8)
    if interlace:
        passes = [image[y0::dy, x0::dx] for x0, y0, dx, dy in _ADAM7]
        idat = b"".join(_filter_rows(_pack_rows(sub, depth), filt, bpp)
                        for sub in passes if sub.size)
    else:
        idat = _filter_rows(_pack_rows(image, depth), filt, bpp)
    return _png_file(w, h, depth, color, interlace, idat, plte)


def test_png_matches_pil_on_committed_frames():
    for path in chip_smoke.FRAMES:
        want = np.asarray(Image.open(path).convert("RGB"))
        got = read_png_rgb(path)
        assert got.dtype == np.uint8 and got.shape == (376, 1408, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
def test_png_filters_match_pil(tmp_path, filt, channels):
    rng = np.random.default_rng(filt)
    # smooth gradients plus noise, so that every predictor sees carries
    yy, xx = np.mgrid[0:13, 0:17]
    base = (yy[..., None] * 19 + xx[..., None] * 7
            + np.arange(channels) * 50)
    image = ((base + rng.integers(0, 40, base.shape)) % 256).astype(np.uint8)
    path = tmp_path / f"f{filt}.png"
    path.write_bytes(_png(image, filt))
    got = read_png_rgb(str(path))
    np.testing.assert_array_equal(got, image[..., :3])
    np.testing.assert_array_equal(
        got, np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("source", ["noise", "mirror"])
def test_png_mixed_row_filters_match_pil(tmp_path, source):
    """Rows filtered adaptively, as libpng writes them: a different filter
    from one row to the next, which the diagonal decode must follow."""
    if source == "noise":
        rng = np.random.default_rng(4)
        yy, xx = np.mgrid[0:29, 0:41]
        base = yy[..., None] * 9 + xx[..., None] * 5 + np.arange(3) * 70
        noise = rng.integers(0, 256, base.shape) * (rng.random((29, 1, 1))
                                                    < 0.5)
        image = ((base + noise) % 256).astype(np.uint8)
    else:
        image = np.ascontiguousarray(read_png_rgb(chip_smoke.FRAMES[0])
                                     [:, ::-1])
    kinds = set(png_filter_rows(image)[:, 0].tolist())
    assert len(kinds) >= 3
    path = tmp_path / "mixed.png"
    write_png_rgb(str(path), image)
    got = read_png_rgb(str(path))
    np.testing.assert_array_equal(got, image)
    np.testing.assert_array_equal(
        got, np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("kw", [dict(interlace=2), dict(depth=16, color=3),
                                dict(color=5), dict(depth=4, color=2)])
def test_png_rejects_other_formats(tmp_path, kw):
    """Formats the PNG standard does not define are refused, as is a file
    that is not a PNG."""
    fields = dict(depth=8, color=2, interlace=0)
    fields.update(kw)
    path = tmp_path / "x.png"
    path.write_bytes(_png_file(5, 4, fields["depth"], fields["color"],
                               fields["interlace"], bytes(4 * 16)))
    with pytest.raises(ValueError, match="not a standard PNG format"):
        read_png_rgb(str(path))
    path.write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="not a PNG"):
        read_png_rgb(str(path))


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("color,depth", [
    (0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
    (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)])
def test_png_formats_match_pil(tmp_path, color, depth, interlace):
    """Every colour type at every bit depth it allows, plain and Adam7,
    decoded as PIL's ``convert("RGB")`` decodes it (its 16-bit and
    sub-byte reductions included).  The rows cycle through all five
    filters; the palette is shorter than the index range, so some indices
    fall past it."""
    rng = np.random.default_rng(color * 100 + depth * 2 + interlace)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    h, w = 13, 19
    # smooth ramps plus noise, so that the predictors see carries
    yy, xx = np.mgrid[0:h, 0:w]
    top = 1 << depth
    base = (yy[..., None] * 7 + xx[..., None] * 3
            + np.arange(channels) * 11) * max(1, top // 256)
    image = ((base + rng.integers(0, top, base.shape) // 4) % top)
    if depth == 16:
        image[0, :4, 0] = [0, 255, 256, 65535]   # clipped or low byte
    plte = None
    if color == 3:
        n = max(1, top - 3) if depth < 8 else 200
        plte = rng.integers(0, 256, (n, 3), dtype=np.uint8).tobytes()
    path = tmp_path / f"c{color}d{depth}i{interlace}.png"
    path.write_bytes(_png(image, (0, 1, 2, 3, 4), depth, color, interlace,
                          plte))
    want = np.asarray(Image.open(path).convert("RGB"))
    got = read_png_rgb(str(path))
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)
