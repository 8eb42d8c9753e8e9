"""The port's JPEG codec (``utils/jpeg.py``, ``csrc/jpeg_codec.cpp``) and
its format dispatch (``utils/image.py``) against Pillow, on the CPU.

The JAX package reads images with ``Image.open(p).convert("RGB")`` and
writes them with ``Image.fromarray(a).save(p)``; Pillow calls
libjpeg-turbo.  The inputs are crops of the committed frame
``artifacts/learned_detector/seg_overlays/0000000100.png`` and seeded
numpy noise, written by Pillow into memory or ``tmp_path``.

* Decoding: every case's pixels equal Pillow's exactly, the native codec
  at every size and the numpy twin at the small ones: qualities 10 to
  100, 4:4:4, 4:2:2, 4:2:0 and 4:4:0 (Pillow cannot write 4:4:0, so the
  numpy twin's blocks are written as a baseline file), grey, progressive, optimized Huffman tables,
  restart markers, ``keep_rgb`` (Adobe RGB), sizes 1 x 1 to 376 x 1408,
  16-bit DQT, the colour-space markers, APPn and COM segments,
  non-interleaved sequential scans, and coefficients whose dequantised
  values overflow the 16-bit lanes of libjpeg-turbo's SIMD IDCT.
* Encoding: the bytes equal Pillow's ``save`` at its defaults (the only
  settings the JAX package writes) at every size.
* Refusals: each kind of file outside the decoder's scope raises its
  named ``ValueError`` on both backends.
* Dispatch: by signature on reading (a JPEG named ``.png`` reads as
  Pillow reads it), by extension on writing.
"""

import io
import json
import os

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from lidar_object_detection_tpu_torch.utils import image as image_io
from lidar_object_detection_tpu_torch.utils import jpeg, native_build
from lidar_object_detection_tpu_torch.utils.png import (read_png_rgb,
                                                        write_png_rgb)

FRAME = read_png_rgb(chip_smoke.FRAMES[0])          # 376 x 1408
SMALL = 2000     # the numpy twin decodes images of fewer pixels than this


def _image(size, source, seed=0):
    h, w = size
    if source == "noise":
        return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                    dtype=np.uint8)
    y0, x0 = (0, 0) if (h, w) == FRAME.shape[:2] else (137, 411)
    return np.ascontiguousarray(FRAME[y0:y0 + h, x0:x0 + w])


def _pillow_bytes(array, **options):
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, format="JPEG", **options)
    return buf.getvalue()


def _pillow_pixels(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _marker(data, code):
    """(offset, length) of the first segment of marker 0xFF<code>."""
    i = data.find(bytes([0xFF, code]))
    assert i >= 0
    return i, int.from_bytes(data[i + 2:i + 4], "big")


def _strip(data, code):
    i, n = _marker(data, code)
    return data[:i] + data[i + 2 + n:]


def _extreme(hs, vs, q, separate=False, seed=0, size=(21, 35)):
    """A baseline file of large random coefficients: the dequantised
    values pass 16 bits and the IDCT's outputs leave 0..255 by far."""
    rng = np.random.default_rng(seed)
    h, w = size
    mcux, mcuy = -(-w // (8 * hs)), -(-h // (8 * vs))
    blocks = []
    for bh, bw in ((mcuy * vs, mcux * hs), (mcuy, mcux), (mcuy, mcux)):
        b = rng.integers(-1023, 1024, (bh, bw, 64))
        b = np.where(rng.random(b.shape) < 0.3, b, 0)
        b[rng.random((bh, bw)) < 0.3, 8:] = 0          # DC-only blocks
        b[..., 0] = rng.integers(-1000, 1001, (bh, bw))
        blocks.append(b)
    return jpeg.baseline_file(blocks, np.full((2, 64), q), h, w, hs, vs,
                              separate_scans=separate)


def _moderate_separate():
    """Three non-interleaved sequential scans of a 4:2:0 image."""
    rng = np.random.default_rng(2)
    h, w = 21, 35
    blocks = [rng.integers(-30, 31, (4, 6, 64)),
              rng.integers(-30, 31, (2, 3, 64)),
              rng.integers(-30, 31, (2, 3, 64))]
    for b in blocks:
        b[..., 20:] = 0
    return jpeg.baseline_file(blocks, jpeg.quality_tables(60), h, w,
                              separate_scans=True)


def _written_4_4_0(image, quality=95):
    """A baseline 4:4:0 file of ``image``: the encoder's blocks with the
    luma sampled 1 x 2, as libjpeg writes it."""
    qt = jpeg.quality_tables(quality)
    return jpeg.baseline_file(jpeg._quantised_blocks(image, qt, 1, 2), qt,
                              *image.shape[:2], 1, 2)


def _recoded_dqt16(data):
    """The file with its first DQT rewritten in 16-bit precision."""
    i, n = _marker(data, 0xDB)
    body = data[i + 4:i + 2 + n]
    table = b"".join(int(v).to_bytes(2, "big") for v in body[1:65])
    seg = b"\xff\xdb" + (3 + 128).to_bytes(2, "big") \
        + bytes([0x10 | body[0]]) + table
    return data[:i] + seg + data[i + 2 + n:]


def _replace_app0(segment):
    """The small crop's default file with its JFIF APP0 replaced."""
    data = _pillow_bytes(_image(SMALL_CROP, "crop"))
    return data[:2] + segment + data[20:]


ADOBE_YCC = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x01"
SMALL_CROP = (17, 33)

# name -> (bytes of the case, built lazily)
DECODE_CASES = {
    **{f"quality{q}_{src}": (lambda q=q, src=src: _pillow_bytes(
        _image(SMALL_CROP, src), quality=q))
       for q in (10, 50, 75, 95, 100) for src in ("crop", "noise")},
    **{f"subsampling{s}_{size[0]}x{size[1]}": (
        lambda s=s, size=size: _pillow_bytes(_image(size, "crop"),
                                             subsampling=s))
       for s in ("4:4:4", "4:2:2", "4:2:0") for size in ((7, 5), (17, 33))},
    **{f"subsampling4:4:0_{src}_{size[0]}x{size[1]}": (
        lambda src=src, size=size: _written_4_4_0(_image(size, src)))
       for src, size in (("crop", (17, 33)), ("noise", (17, 33)),
                         ("crop", (1, 1)), ("crop", (375, 1242)))},
    **{f"size{h}x{w}": (lambda h=h, w=w: _pillow_bytes(_image((h, w),
                                                              "crop")))
       for h, w in ((1, 1), (7, 5), (17, 33), (375, 1242), (376, 1408))},
    "grey_17x33": lambda: _pillow_bytes(
        np.asarray(Image.fromarray(_image(SMALL_CROP, "crop")).convert("L"))),
    "grey_375x1242": lambda: _pillow_bytes(
        np.asarray(Image.fromarray(_image((375, 1242), "crop"))
                   .convert("L"))),
    "progressive_17x33": lambda: _pillow_bytes(_image(SMALL_CROP, "crop"),
                                               progressive=True),
    "progressive_noise_444": lambda: _pillow_bytes(
        _image(SMALL_CROP, "noise"), progressive=True, subsampling="4:4:4",
        quality=95),
    "progressive_375x1242": lambda: _pillow_bytes(_image((375, 1242), "crop"),
                                                  progressive=True),
    "optimize": lambda: _pillow_bytes(_image(SMALL_CROP, "crop"),
                                      optimize=True),
    "optimize_progressive": lambda: _pillow_bytes(
        _image(SMALL_CROP, "noise"), optimize=True, progressive=True),
    "restart_blocks": lambda: _pillow_bytes(_image(SMALL_CROP, "crop"),
                                            restart_marker_blocks=3),
    "restart_rows": lambda: _pillow_bytes(_image(SMALL_CROP, "crop"),
                                          restart_marker_rows=1),
    "restart_progressive": lambda: _pillow_bytes(
        _image(SMALL_CROP, "noise"), restart_marker_blocks=2,
        progressive=True),
    "keep_rgb": lambda: _pillow_bytes(_image(SMALL_CROP, "crop"),
                                      keep_rgb=True),
    "rgb_ids_without_adobe": lambda: _strip(_pillow_bytes(
        _image(SMALL_CROP, "crop"), keep_rgb=True), 0xEE),
    "adobe_transform1": lambda: _replace_app0(ADOBE_YCC),
    "no_colour_marker": lambda: _replace_app0(b""),
    "comment_and_app1": lambda: _pillow_bytes(
        _image(SMALL_CROP, "crop"), comment=b"KITTI",
        xmp=b"<x:xmpmeta xmlns:x='adobe:ns:meta/'/>"),
    "dqt16": lambda: _recoded_dqt16(_pillow_bytes(_image(SMALL_CROP,
                                                         "crop"))),
    "sof1_dqt16": lambda: _pillow_bytes(
        _image(SMALL_CROP, "crop"),
        qtables=[[300] * 64, list(range(1, 65))]),
    "separate_scans": _moderate_separate,
    **{f"extreme_{hs}x{vs}_q{q}": (lambda hs=hs, vs=vs, q=q: _extreme(
        hs, vs, q, separate=(q == 31), seed=hs * 10 + vs))
       for hs, vs in ((1, 1), (2, 1), (1, 2), (2, 2)) for q in (8, 31)},
    "extreme_q65535": lambda: _extreme(2, 2, 65535, seed=9),
}


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_decode_matches_pillow(name):
    data = DECODE_CASES[name]()
    want = _pillow_pixels(data)
    got = jpeg.read_jpeg_rgb(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if want.shape[0] * want.shape[1] < SMALL:
        np.testing.assert_array_equal(
            jpeg.read_jpeg_rgb(data, backend="numpy"), want)


def test_extreme_coefficients_leave_the_sample_range():
    """The extreme files reach what the C code's range-limit table would
    wrap: Pillow's pixels there are clamped (its x86 SIMD IDCT), and so
    are the port's."""
    data = _extreme(2, 2, 8)
    got = jpeg.read_jpeg_rgb(data)
    assert (got == 0).mean() > 0.1 and (got == 255).mean() > 0.1
    np.testing.assert_array_equal(got, _pillow_pixels(data))


# the matrix's sizes, and whole, partial and odd MCUs around 16 x 16
ENCODE_SIZES = ((1, 1), (7, 5), (17, 33), (375, 1242), (376, 1408),
                (16, 16), (8, 24), (23, 41), (9, 17))


@pytest.mark.parametrize("size", ENCODE_SIZES,
                         ids=[f"{h}x{w}" for h, w in ENCODE_SIZES])
@pytest.mark.parametrize("source", ("crop", "noise"))
def test_write_matches_pillow_save(tmp_path, size, source):
    image = _image(size, source, seed=size[0])
    want = tmp_path / "pil.jpg"
    Image.fromarray(image).save(want)
    path = tmp_path / "port.jpg"
    jpeg.write_jpeg_rgb(path, image)
    assert path.read_bytes() == want.read_bytes()
    if size[0] * size[1] < SMALL:
        assert jpeg.encode_jpeg_rgb(image, backend="numpy") == \
            want.read_bytes()


def test_encoded_header_is_pillows_default():
    """SOI, JFIF 1.01 at density 1 x 1, two DQT, SOF0 (Y 2 x 2, Cb and Cr
    1 x 1, ids 1 2 3), DHT DC0 AC0 DC1 AC1 of lengths 31 181 31 181, one
    interleaved SOS."""
    data = jpeg.encode_jpeg_rgb(_image((40, 50), "noise"))
    assert data[:20] == bytes.fromhex(
        "ffd8ffe000104a46494600010100000100010000")
    pos, segments = 2, []
    while True:
        code, n = data[pos + 1], int.from_bytes(data[pos + 2:pos + 4], "big")
        segments.append((code, n, data[pos + 4:pos + 4 + min(n - 2, 15)]))
        if code == 0xDA:
            break
        pos += 2 + n
    assert [(c, n) for c, n, _ in segments] == [
        (0xE0, 16), (0xDB, 67), (0xDB, 67), (0xC0, 17), (0xC4, 31),
        (0xC4, 181), (0xC4, 31), (0xC4, 181), (0xDA, 12)]
    assert segments[3][2] == bytes.fromhex("080028003203012200021101031101")
    assert [s[2][0] for s in segments[4:8]] == [0x00, 0x10, 0x01, 0x11]
    assert data.endswith(b"\xff\xd9")


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _patched(offset_from_sof, value, base=None):
    data = bytearray(base or _pillow_bytes(_image(SMALL_CROP, "crop")))
    i, _ = _marker(bytes(data), 0xC0)
    data[i + offset_from_sof:i + offset_from_sof + len(value)] = value
    return bytes(data)


def _incomplete_progressive():
    data = _pillow_bytes(_image(SMALL_CROP, "crop"), progressive=True)
    last_sos = data.rfind(b"\xff\xda")
    return data[:last_sos] + b"\xff\xd9"


def _wrong_restart():
    data = _pillow_bytes(_image(SMALL_CROP, "crop"),
                         restart_marker_blocks=1)
    i = data.find(b"\xff\xd1")
    return data[:i + 1] + b"\xd2" + data[i + 2:]


def _cmyk():
    buf = io.BytesIO()
    Image.new("CMYK", (9, 9), (1, 2, 3, 4)).save(buf, format="JPEG")
    return buf.getvalue()


REFUSALS = {
    "sof9": (lambda: _patched(1, b"\xc9"), r"arithmetic coding \(SOF9\)"),
    "sof10": (lambda: _patched(1, b"\xca"), r"arithmetic coding \(SOF10\)"),
    "sof11": (lambda: _patched(1, b"\xcb"), r"arithmetic coding \(SOF11\)"),
    "dac": (lambda: (lambda d: d[:2] + b"\xff\xcc\x00\x04\x00\x00" + d[2:])(
        _pillow_bytes(_image(SMALL_CROP, "crop"))), r"arithmetic coding "
        r"\(DAC marker\)"),
    "sof3": (lambda: _patched(1, b"\xc3"), r"lossless or hierarchical JPEG "
             r"\(SOF3\)"),
    "sof5": (lambda: _patched(1, b"\xc5"), r"\(SOF5\) is not supported"),
    "sof7": (lambda: _patched(1, b"\xc7"), r"\(SOF7\) is not supported"),
    "precision12": (lambda: _patched(4, b"\x0c"),
                    r"12-bit precision \(SOF0\)"),
    "cmyk": (_cmyk, r"four components \(CMYK or YCCK\)"),
    "sampling_chroma_2x1": (lambda: _patched(14, b"\x21"),
                            r"sampling factors 2x2,2x1,1x1"),
    "sampling_luma_3x1": (lambda: _patched(11, b"\x31"),
                          r"sampling factors 3x1,1x1,1x1"),
    "dnl_height0": (lambda: _patched(5, b"\x00\x00"), r"height 0 \(DNL\)"),
    "truncated_header": (lambda: _pillow_bytes(_image(SMALL_CROP,
                                                      "crop"))[:300],
                         r"truncated file"),
    "truncated_scan": (lambda: (lambda d: d[:len(d) * 2 // 3])(
        _pillow_bytes(_image((64, 96), "noise"))), r"truncated"),
    "no_eoi": (lambda: _pillow_bytes(_image(SMALL_CROP, "crop"))[:-2],
               r"no EOI marker \(truncated file\)"),
    "wrong_rst": (_wrong_restart, r"expected RST1 marker, found 0xFFD2"),
    "progressive_unknown_bits": (_incomplete_progressive,
                                 r"leave coefficient bits unknown"),
    "not_jpeg": (lambda: b"GIF89a\x00\x00", r"no SOI marker"),
}


@pytest.mark.parametrize("kind", sorted(REFUSALS))
@pytest.mark.parametrize("backend", jpeg.BACKENDS)
def test_refused_files_raise_named_errors(kind, backend):
    make, message = REFUSALS[kind]
    with pytest.raises(ValueError, match=message):
        jpeg.read_jpeg_rgb(make(), backend=backend)


def test_pillow_refuses_truncated_files_too():
    data = _pillow_bytes(_image((64, 96), "noise"))
    for cut in (data[:-2], data[:len(data) * 2 // 3]):
        with pytest.raises(OSError, match="truncated"):
            _pillow_pixels(cut)


def test_unknown_backend_and_shapes_raise():
    data = _pillow_bytes(_image((8, 8), "crop"))
    with pytest.raises(ValueError, match="backend"):
        jpeg.read_jpeg_rgb(data, backend="python")
    with pytest.raises(ValueError, match="RGB"):
        jpeg.encode_jpeg_rgb(np.zeros((4, 4), np.uint8))


def test_codec_is_built_from_the_port_copy():
    path = jpeg.build()
    assert path == jpeg.build()
    assert path.name == "libjpeg_codec.so"
    assert path.parent.parent == native_build.BUILD_ROOT
    assert path.parent.name == native_build.source_hash(jpeg.SOURCE)
    assert jpeg.SOURCE.parent.name == "csrc"
    assert jpeg.library() is jpeg.library()


def test_failed_codec_build_raises_with_the_compiler_error(tmp_path):
    bad = tmp_path / "jpeg_codec.cpp"
    bad.write_text("int broken( {\n")
    with pytest.raises(RuntimeError, match="jpeg_codec.cpp.*error"):
        native_build.build(bad, "libjpeg_codec.so", "the JPEG codec",
                           tmp_path / "build")
    assert not list((tmp_path / "build").rglob("*.so*"))


# ---------------------------------------------------------------------------
# dispatch by signature and by extension
# ---------------------------------------------------------------------------

def test_jpeg_named_png_reads_as_pillow_reads_it(tmp_path):
    image = _image(SMALL_CROP, "crop")
    path = tmp_path / "frame.png"
    Image.fromarray(image).save(path, format="JPEG")
    want = np.asarray(Image.open(path).convert("RGB"))
    assert not np.array_equal(want, image)       # lossy: JPEG was read
    np.testing.assert_array_equal(image_io.read_image_rgb(path), want)
    other = tmp_path / "frame.jpg"
    write_png_rgb(str(other), image)
    np.testing.assert_array_equal(image_io.read_image_rgb(other), image)


def test_unknown_signature_raises(tmp_path):
    path = tmp_path / "x.png"
    path.write_bytes(b"BM\x00\x00\x00\x00\x00\x00")
    with pytest.raises(ValueError, match="signature 424d"):
        image_io.read_image_rgb(path)


@pytest.mark.parametrize("name", ("a.jpg", "a.JPG", "b.jpeg", "c.JpEg",
                                  "d.png", "e.PNG"))
def test_write_by_extension_as_pillow_save(tmp_path, name):
    image = _image((19, 27), "noise", seed=len(name))
    path = tmp_path / name
    image_io.write_image_rgb(path, image)
    if name.lower().endswith((".jpg", ".jpeg")):
        ref = tmp_path / ("ref_" + name)
        Image.fromarray(image).save(ref)
        assert path.read_bytes() == ref.read_bytes()
    else:
        assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        np.testing.assert_array_equal(read_png_rgb(str(path)), image)


def test_write_unknown_extension_raises(tmp_path):
    with pytest.raises(ValueError, match="'.bmp'"):
        image_io.write_image_rgb(tmp_path / "x.bmp",
                                 np.zeros((2, 2, 3), np.uint8))
    assert not os.path.exists(tmp_path / "x.bmp")


# ---------------------------------------------------------------------------
# the committed fixtures of chip_smoke.py's JPEG phase
# ---------------------------------------------------------------------------

FIXTURES = os.path.join(chip_smoke.REPO, "tests", "fixtures", "jpeg")
with open(os.path.join(FIXTURES, "fixtures.json")) as _f:
    FIXTURE_RECORD = json.load(_f)


@pytest.mark.parametrize("name", sorted(FIXTURE_RECORD["fixtures"]))
def test_committed_fixture_matches_its_record(name):
    """Pillow still decodes each committed fixture to the recorded hash,
    and so do both of the port's backends (what the card's phase
    checks)."""
    entry = FIXTURE_RECORD["fixtures"][name]
    path = os.path.join(FIXTURES, name)
    assert os.path.getsize(path) == entry["bytes"] < 200_000
    want = np.asarray(Image.open(path).convert("RGB"))
    assert list(want.shape) == entry["shape"]
    assert chip_smoke.sha256_hex(want.tobytes()) == entry["pixels_sha256"]
    for backend in jpeg.BACKENDS:
        got = jpeg.read_jpeg_rgb(path, backend=backend)
        assert chip_smoke.sha256_hex(got.tobytes()) == entry["pixels_sha256"]


def test_committed_encode_hash_is_pillows():
    y0, y1, x0, x1 = FIXTURE_RECORD["encode"]["crop"]
    crop = np.ascontiguousarray(FRAME[y0:y1, x0:x1])
    want = FIXTURE_RECORD["encode"]["sha256"]
    assert chip_smoke.sha256_hex(_pillow_bytes(crop)) == want
    for backend in jpeg.BACKENDS:
        assert chip_smoke.sha256_hex(
            jpeg.encode_jpeg_rgb(crop, backend=backend)) == want
    total = sum(e["bytes"] for e in FIXTURE_RECORD["fixtures"].values())
    assert total < 600_000
