"""JPEG decoding and encoding as the JAX package's Pillow calls do them.

The JAX package reads images with ``Image.open(p).convert("RGB")`` and
writes them with ``Image.fromarray(rgb).save(p)``; Pillow calls
libjpeg-turbo at its defaults.  The card's machine promises no Pillow, so
the port has its own codec, which computes what libjpeg computes, bit for
bit:

* :func:`read_jpeg_rgb` decodes baseline, extended and progressive Huffman
  JPEGs (SOF0, SOF1, SOF2) of 8-bit samples, grey or three components,
  with the luma sampled 1 or 2 in each direction and the chroma 1 x 1
  (4:4:4, 4:2:2, 4:4:0, 4:2:0), interleaved or not, with restart markers,
  to the pixels Pillow gives: the integer islow IDCT as libjpeg-turbo's
  x86 SIMD code computes it (16-bit lanes that wrap and saturate, the
  output clamped; for coefficients that fit, the C code's bits), the
  "fancy" triangle upsampling and the fixed-point YCbCr -> RGB tables.  The colour space of three components follows
  libjpeg's rule (JFIF APP0: YCbCr; else Adobe APP14: its transform; else
  component ids ``R G B``: RGB; else YCbCr).  Grey is replicated into RGB.
* :func:`write_jpeg_rgb` writes the bytes of Pillow's ``save`` of an RGB
  array at its defaults: quality 75, 4:2:0, JFIF 1.01, the standard
  Huffman tables, the islow FDCT.

Refused, with a ``ValueError`` naming the marker or field: arithmetic
coding (SOF9-SOF11, SOF13-SOF15, DAC), lossless and hierarchical modes
(SOF3, SOF5-SOF7), 12-bit samples, four components, other sampling
factors, DNL, truncated or corrupt data, and a progressive file whose
scans leave coefficient bits unknown (libjpeg would smooth those blocks).

``backend="native"`` runs ``csrc/jpeg_codec.cpp``, built with ``g++`` on
first use (``utils/native_build.py``); ``backend="numpy"`` is its plain
twin in Python and numpy, which runs only when asked for, and gives the
same pixels, bytes and errors.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Union

import numpy as np

from lidar_object_detection_tpu_torch.utils import native_build

SOURCE = native_build.CSRC / "jpeg_codec.cpp"
BACKENDS = ("native", "numpy")
SIGNATURE = b"\xff\xd8\xff"
QUALITY = 75     # Pillow's default; the encoder writes 4:2:0 at it

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_U8P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "jpeg_codec_probe": (ctypes.c_int, (
        _U8P, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p, ctypes.c_int)),
    "jpeg_codec_decode": (ctypes.c_int, (
        _U8P, ctypes.c_int64, _U8P, ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_int)),
    "jpeg_codec_encode": (ctypes.c_int64, (
        _U8P, ctypes.c_int32, ctypes.c_int32, _U8P, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int)),
}


def build():
    """Compile the codec unless its hash has a build; returns its path."""
    return native_build.build(SOURCE, "libjpeg_codec.so",
                              "the JPEG codec")


def library() -> ctypes.CDLL:
    """The loaded codec library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = native_build.load(build(), _SIGNATURES)
        return _lib


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")


def _u8p(buf):
    return ctypes.cast(buf, _U8P)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def read_jpeg_rgb(source: Union[str, os.PathLike, bytes],
                  backend: str = "native") -> np.ndarray:
    """(H, W, 3) uint8 pixels of a JPEG file (a path) or of its bytes,
    equal to ``np.asarray(Image.open(p).convert("RGB"))``."""
    _check_backend(backend)
    if isinstance(source, (bytes, bytearray, memoryview)):
        data, where = bytes(source), "JPEG data"
    else:
        where = os.fspath(source)
        with open(where, "rb") as f:
            data = f.read()
    if backend == "numpy":
        try:
            return _Decoder(data).decode()
        except _JpegError as e:
            raise ValueError(f"{where}: {e}") from None
    lib = library()
    err = ctypes.create_string_buffer(256)
    src = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    hwc = (ctypes.c_int32 * 3)()
    if lib.jpeg_codec_probe(src, len(data), hwc, err, 256) != 0:
        raise ValueError(f"{where}: {err.value.decode()}")
    out = np.empty((hwc[0], hwc[1], 3), np.uint8)
    if lib.jpeg_codec_decode(src, len(data), _u8p(out.ctypes.data),
                             out.size, err, 256) != 0:
        raise ValueError(f"{where}: {err.value.decode()}")
    return out


def encode_jpeg_rgb(image: np.ndarray, backend: str = "native") -> bytes:
    """The JPEG bytes of (H, W, 3) uint8 RGB that Pillow's ``save`` writes
    at its defaults (quality 75, 4:2:0)."""
    _check_backend(backend)
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) RGB, got {image.shape}")
    h, w, _ = image.shape
    if backend == "numpy":
        qt = quality_tables(QUALITY)
        try:
            return baseline_file(_quantised_blocks(image, qt), qt, h, w)
        except _JpegError as e:
            raise ValueError(str(e)) from None
    lib = library()
    err = ctypes.create_string_buffer(256)
    capacity = h * w * 3 + 4096
    while True:
        out = (ctypes.c_uint8 * capacity)()
        n = lib.jpeg_codec_encode(_u8p(image.ctypes.data), h, w, out,
                                  capacity, err, 256)
        if n < 0:
            raise ValueError(err.value.decode())
        if n <= capacity:
            return bytes(out[:n])
        capacity = n


def write_jpeg_rgb(path: Union[str, os.PathLike], image: np.ndarray,
                   backend: str = "native") -> None:
    """Write (H, W, 3) uint8 RGB as the bytes of
    ``Image.fromarray(image).save(path)`` for a ``.jpg`` name."""
    data = encode_jpeg_rgb(image, backend=backend)
    with open(path, "wb") as f:
        f.write(data)


# ---------------------------------------------------------------------------
# the plain twin: tables
# ---------------------------------------------------------------------------

class _JpegError(ValueError):
    pass


NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_NAT = NATURAL.tolist()

STD_QUANT = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    [17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4
    + [24, 26, 56] + [99] * 5 + [47, 66] + [99] * 38])

_DC_COUNTS = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
              (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0))
_DC_SYMBOLS = tuple(range(12))
_AC_COUNTS = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d),
              (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77))
_AC_SYMBOLS = (bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))

# islow constants: FIX(x) = x * 2^13 rounded
_F = dict(f0_298631336=2446, f0_390180644=3196, f0_541196100=4433,
          f0_765366865=6270, f0_899976223=7373, f1_175875602=9633,
          f1_501321110=12299, f1_847759065=15137, f1_961570560=16069,
          f2_053119869=16819, f2_562915447=20995, f3_072711026=25172)
_CONST_BITS, _PASS1_BITS = 13, 2


def _fix16(x: float) -> int:
    return int(x * 65536.0 + 0.5)


_X = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix16(1.40200) * _X + (1 << 15)) >> 16
_CB_B = (_fix16(1.77200) * _X + (1 << 15)) >> 16
_CR_G = -_fix16(0.71414) * _X
_CB_G = -_fix16(0.34414) * _X + (1 << 15)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _odd_part(t0, t1, t2, t3):
    """The islow (I)DCT's odd part, shared by both directions: inputs in
    the IDCT's order (y7, y5, y3, y1) or the FDCT's (tmp4..tmp7)."""
    f = _F
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["f1_175875602"]
    t0 = t0 * f["f0_298631336"]
    t1 = t1 * f["f2_053119869"]
    t2 = t2 * f["f3_072711026"]
    t3 = t3 * f["f1_501321110"]
    z1 = z1 * -f["f0_899976223"]
    z2 = z2 * -f["f2_562915447"]
    z3 = z3 * -f["f1_961570560"] + z5
    z4 = z4 * -f["f0_390180644"] + z5
    return t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4


def _wrap16(x):
    return ((x + 32768) & 0xFFFF) - 32768


def _wrap32(x):
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _idct_pass(x, shift):
    """One 1-D islow IDCT over the last axis of int64 16-bit lanes ``x``,
    in the form of libjpeg-turbo's x86 SIMD code: each rotation a sum of
    two products by 16-bit constants, the sums ahead of the rotations
    16-bit adds, each output descaled by ``shift`` in 32 bits."""
    f = _F
    c541, c765, c1847 = (f["f0_541196100"], f["f0_765366865"],
                         f["f1_847759065"])
    tmp3 = x[..., 2] * (c541 + c765) + x[..., 6] * c541
    tmp2 = x[..., 2] * c541 + x[..., 6] * (c541 - c1847)
    tmp0 = _wrap16(x[..., 0] + x[..., 4]) << _CONST_BITS
    tmp1 = _wrap16(x[..., 0] - x[..., 4]) << _CONST_BITS
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    y7, y5, y3, y1 = x[..., 7], x[..., 5], x[..., 3], x[..., 1]
    z3, z4 = _wrap16(y7 + y3), _wrap16(y5 + y1)
    c1175, c899, c2562 = (f["f1_175875602"], f["f0_899976223"],
                          f["f2_562915447"])
    z3r = z3 * (c1175 - f["f1_961570560"]) + z4 * c1175
    z4r = z3 * c1175 + z4 * (c1175 - f["f0_390180644"])
    o0 = y7 * (f["f0_298631336"] - c899) + y1 * -c899 + z3r
    o3 = y7 * -c899 + y1 * (f["f1_501321110"] - c899) + z4r
    o1 = y5 * (f["f2_053119869"] - c2562) + y3 * -c2562 + z4r
    o2 = y5 * -c2562 + y3 * (f["f3_072711026"] - c2562) + z3r
    out = [t10 + o3, t11 + o2, t12 + o1, t13 + o0,
           t13 - o0, t12 - o1, t11 - o2, t10 - o3]
    return np.stack([_wrap32(v + (1 << (shift - 1))) >> shift
                     for v in out], -1)


def _idct_blocks(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """jpeg_idct_islow of (N, 64) natural-order coefficients with the
    (64,) dequantisation table, as libjpeg-turbo's x86 SIMD code computes
    it: (N, 8, 8) uint8 samples.  The dequantised values and pass 1's
    results are 16-bit lanes (products wrap, results saturate), and the
    output is clamped to 0..255.  A block whose coefficient rows 1..7 are
    all zero takes pass 1's DC shortcut, a 16-bit shift."""
    coef = coef.astype(np.int64)
    dq = _wrap16(coef * qt.astype(np.int64)).reshape(-1, 8, 8)
    ws = np.clip(_idct_pass(dq.transpose(0, 2, 1),
                            _CONST_BITS - _PASS1_BITS), -32768, 32767)
    ws = ws.transpose(0, 2, 1)
    dc_only = ~coef[:, 8:].any(axis=1)
    ws[dc_only] = _wrap16(dq[dc_only, :1, :] * 4)
    out = _idct_pass(ws, _CONST_BITS + _PASS1_BITS + 3)
    return (np.clip(out, -128, 127) + 128).astype(np.uint8)


# ---------------------------------------------------------------------------
# the plain twin: decoding
# ---------------------------------------------------------------------------

class _Huff:
    def __init__(self, counts, symbols):
        n = sum(counts)
        if n > 256:
            raise _JpegError(f"bad Huffman table: {n} symbols (DHT)")
        self.counts = tuple(counts)
        self.symbols = bytes(symbols[:n])
        self.lut = None

    def build(self, dc: bool):
        """A 65536-entry table: 16 bits from the stream -> length << 8 |
        symbol, 0 where no code matches."""
        lut = np.zeros(1 << 16, np.int32)
        code = k = 0
        for length in range(1, 17):
            for _ in range(self.counts[length - 1]):
                lo = code << (16 - length)
                lut[lo:lo + (1 << (16 - length))] = \
                    (length << 8) | self.symbols[k]
                k += 1
                code += 1
            if code >= (1 << length) and k > 0:
                raise _JpegError(f"bad Huffman table: codes of length "
                                 f"{length} overflow (DHT)")
            code <<= 1
        if dc:
            for s in self.symbols:
                if s > 15:
                    raise _JpegError(f"bad Huffman table: DC symbol {s} "
                                     "(DHT)")
        self.lut = lut.tolist()


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.coef = None
        self.qt = None
        self.coef_bits = [-1] * 64
        self.scanned = False


def _extend(v, s):
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


class _Segment:
    """The bits of one restart interval of entropy-coded data, read
    through a table of the 16 bits at every position (zeros past the
    end, as libjpeg fills)."""

    def __init__(self, data: bytes):
        raw = np.frombuffer(data, np.uint8)
        self.nbits = raw.size * 8
        bits = np.concatenate([np.unpackbits(raw),
                               np.zeros(48, np.uint8)]).astype(np.int64)
        windows = np.lib.stride_tricks.sliding_window_view(bits, 16)
        self.window = (windows @ (1 << np.arange(15, -1, -1))).tolist()
        self.pos = 0


class _Decoder:
    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0
        self.qt = [None] * 4
        self.dc = [None] * 4
        self.ac = [None] * 4
        self.std_tables = False
        self.restart_interval = 0
        self.jfif = self.adobe = False
        self.adobe_transform = 0
        self.sof = None
        self.scans = 0

    # -- markers ------------------------------------------------------------
    def _u8(self, p):
        if p >= len(self.d):
            raise _JpegError("unexpected end of file (truncated file)")
        return self.d[p]

    def _u16(self, p):
        return (self._u8(p) << 8) | self._u8(p + 1)

    def _next_marker(self):
        d, n = self.d, len(self.d)
        while True:
            if self.pos >= n:
                raise _JpegError("unexpected end of file: no EOI marker "
                                 "(truncated file)")
            if d[self.pos] != 0xFF:
                self.pos += 1
                continue
            while self.pos < n and d[self.pos] == 0xFF:
                self.pos += 1
            if self.pos >= n:
                raise _JpegError("unexpected end of file: no EOI marker "
                                 "(truncated file)")
            m = d[self.pos]
            self.pos += 1
            if m != 0:
                return m

    def _segment(self):
        length = self._u16(self.pos)
        if length < 2:
            raise _JpegError(f"bad marker length {length}")
        if self.pos + length > len(self.d):
            raise _JpegError("unexpected end of file in a marker segment "
                             "(truncated file)")
        body = self.d[self.pos + 2:self.pos + length]
        self.pos += length
        return body

    def decode(self) -> np.ndarray:
        self._run()
        return self._output()

    def _run(self):
        d = self.d
        if len(d) < 2 or d[0] != 0xFF or d[1] != 0xD8:
            raise _JpegError("not a JPEG file: no SOI marker")
        self.pos = 2
        while True:
            m = self._next_marker()
            if m == 0xD8:
                raise _JpegError("second SOI marker (corrupt file)")
            if m == 0xD9:
                if self.sof is None:
                    raise _JpegError("no SOF marker before EOI (corrupt "
                                     "file)")
                if self.scans == 0:
                    raise _JpegError("no SOS marker before EOI (corrupt "
                                     "file)")
                break
            if 0xD0 <= m <= 0xD7:
                raise _JpegError(f"RST{m - 0xD0} marker outside a scan "
                                 "(corrupt file)")
            if m == 0x01:
                continue
            if m in (0xC0, 0xC1, 0xC2):
                self._parse_sof(m, self._segment())
                continue
            if m in (0xC3, 0xC5, 0xC6, 0xC7, 0xC8):
                raise _JpegError(f"lossless or hierarchical JPEG "
                                 f"(SOF{m - 0xC0}) is not supported")
            if m in (0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
                raise _JpegError(f"arithmetic coding (SOF{m - 0xC0}) is "
                                 "not supported")
            if m == 0xCC:
                raise _JpegError("arithmetic coding (DAC marker) is not "
                                 "supported")
            if m == 0xDC:
                raise _JpegError("DNL marker is not supported")
            body = self._segment()
            if m == 0xC4:
                self._parse_dht(body)
            elif m == 0xDB:
                self._parse_dqt(body)
            elif m == 0xDD:
                if len(body) < 2:
                    raise _JpegError("bad DRI marker length")
                self.restart_interval = (body[0] << 8) | body[1]
            elif m == 0xDA:
                if self.sof is None:
                    raise _JpegError("SOS marker before SOF (corrupt file)")
                self._scan(body)
            elif m == 0xE0:
                if len(body) >= 14 and body[:5] == b"JFIF\0":
                    self.jfif = True
            elif m == 0xEE:
                if len(body) >= 12 and body[:5] == b"Adobe":
                    self.adobe = True
                    self.adobe_transform = body[11]
            elif 0xE1 <= m <= 0xEF or m == 0xFE or 0xF0 <= m <= 0xFD:
                pass
            else:
                raise _JpegError(f"unknown JPEG marker 0xFF{m:02X}")
        for c, k in enumerate(self.comps):
            if not k.scanned:
                raise _JpegError(f"component {c} has no scan (truncated or "
                                 "corrupt file)")
            if self.progressive:
                for i in range(64):
                    if k.coef_bits[i] != 0:
                        raise _JpegError(
                            f"progressive scans leave coefficient bits "
                            f"unknown (component {c}, coefficient {i}): "
                            "libjpeg would smooth these blocks")

    def _parse_sof(self, m, b):
        if self.sof is not None:
            raise _JpegError("second SOF marker (corrupt file)")
        sof = m - 0xC0
        if len(b) < 6:
            raise _JpegError(f"bad SOF{sof} marker length")
        precision = b[0]
        self.height = (b[1] << 8) | b[2]
        self.width = (b[3] << 8) | b[4]
        self.nc = nc = b[5]
        if precision != 8:
            raise _JpegError(f"{precision}-bit precision (SOF{sof}) is not "
                             "supported: 8-bit samples only")
        if nc == 4:
            raise _JpegError("four components (CMYK or YCCK) are not "
                             "supported")
        if nc not in (1, 3):
            raise _JpegError(f"{nc} components are not supported: 1 or 3 "
                             "only")
        if len(b) < 6 + 3 * nc:
            raise _JpegError(f"bad SOF{sof} marker length")
        if self.height == 0:
            raise _JpegError("image height 0 (DNL) is not supported")
        if self.width == 0:
            raise _JpegError("image width 0 (corrupt file)")
        self.sof = sof
        self.progressive = m == 0xC2
        self.comps = []
        for c in range(nc):
            cid, hv, tq = b[6 + 3 * c:9 + 3 * c]
            if tq > 3:
                raise _JpegError(f"quantization table {tq} out of range "
                                 f"(SOF{sof})")
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4):
                raise _JpegError(f"sampling factors {h}x{v} out of range "
                                 f"(SOF{sof})")
            self.comps.append(_Component(cid, h, v, tq))
        cs = self.comps
        if nc == 1:
            cs[0].h = cs[0].v = 1
        elif not (cs[0].h <= 2 and cs[0].v <= 2
                  and all(k.h == 1 and k.v == 1 for k in cs[1:])):
            raise _JpegError(
                "sampling factors " + ",".join(f"{k.h}x{k.v}" for k in cs)
                + " are not supported: luma 1 or 2 in each direction with "
                "chroma 1x1 only")
        self.maxh, self.maxv = cs[0].h, cs[0].v
        W, H = self.width, self.height
        self.mcux = -(-W // (8 * self.maxh))
        self.mcuy = -(-H // (8 * self.maxv))
        for k in cs:
            k.wib = -(-W * k.h // (8 * self.maxh))
            k.hib = -(-H * k.v // (8 * self.maxv))
            k.dw = -(-W * k.h // self.maxh)
            k.dh = -(-H * k.v // self.maxv)
            k.bw = k.wib if nc == 1 else self.mcux * k.h
            k.bh = k.hib if nc == 1 else self.mcuy * k.v

    def _parse_dht(self, b):
        i = 0
        while i < len(b):
            if i + 17 > len(b):
                raise _JpegError("bad DHT marker length")
            tc, th = b[i] >> 4, b[i] & 15
            if tc > 1 or th > 3:
                raise _JpegError(f"bad Huffman table class {tc} or id {th} "
                                 "(DHT)")
            counts = b[i + 1:i + 17]
            n = sum(counts)
            if n > 256 or i + 17 + n > len(b):
                raise _JpegError("bad DHT marker length")
            (self.ac if tc else self.dc)[th] = _Huff(counts,
                                                     b[i + 17:i + 17 + n])
            i += 17 + n

    def _parse_dqt(self, b):
        i = 0
        while i < len(b):
            pq, tq = b[i] >> 4, b[i] & 15
            if tq > 3:
                raise _JpegError(f"quantization table id {tq} out of range "
                                 "(DQT)")
            if pq > 1:
                raise _JpegError(f"bad quantization table precision {pq} "
                                 "(DQT)")
            size = 128 if pq else 64
            if i + 1 + size > len(b):
                raise _JpegError("bad DQT marker length")
            raw = np.frombuffer(b[i + 1:i + 1 + size],
                                ">u2" if pq else np.uint8)
            qt = np.zeros(64, np.int64)
            # libjpeg keeps the islow multiplier in a short
            qt[NATURAL] = raw.astype(np.uint16).view(np.int16)
            self.qt[tq] = qt
            i += 1 + size

    # -- scans --------------------------------------------------------------
    def _entropy_segments(self):
        """The scan's entropy-coded data, split at its RST markers and
        unstuffed: [(rst number or None, bytes)], and the position of the
        marker that ends the scan."""
        d, n, p = self.d, len(self.d), self.pos
        segments, rst, cur = [], None, bytearray()
        while True:
            if p >= n:
                segments.append((rst, bytes(cur)))
                return segments, n
            c = d[p]
            if c != 0xFF:
                cur.append(c)
                p += 1
                continue
            q = p + 1
            while q < n and d[q] == 0xFF:
                q += 1
            if q < n and d[q] == 0:
                cur.append(0xFF)
                p = q + 1
                continue
            if q < n and 0xD0 <= d[q] <= 0xD7:
                segments.append((rst, bytes(cur)))
                rst, cur = d[q] - 0xD0, bytearray()
                p = q + 1
                continue
            segments.append((rst, bytes(cur)))
            return segments, p

    def _scan(self, b):
        if len(b) < 1:
            raise _JpegError("bad SOS marker length")
        ns = b[0]
        if not 1 <= ns <= 4 or len(b) < 4 + 2 * ns:
            raise _JpegError(f"bad SOS marker ({ns} components)")
        comps, td, ta = [], [], []
        for i in range(ns):
            cid, t = b[1 + 2 * i], b[2 + 2 * i]
            idx = [c for c, k in enumerate(self.comps) if k.id == cid]
            if not idx:
                raise _JpegError(f"SOS names component id {cid}, which SOF "
                                 "does not")
            if idx[-1] in comps:
                raise _JpegError(f"SOS names component id {cid} twice")
            comps.append(idx[-1])
            td.append(t >> 4)
            ta.append(t & 15)
            if td[-1] > 3 or ta[-1] > 3:
                raise _JpegError("Huffman table id out of range (SOS)")
        ss, se = b[1 + 2 * ns], b[2 + 2 * ns]
        ah, al = b[3 + 2 * ns] >> 4, b[3 + 2 * ns] & 15
        if ns > 1 and sum(self.comps[c].h * self.comps[c].v
                          for c in comps) > 10:
            raise _JpegError("too many blocks in an MCU (SOS)")
        for c in comps:
            k = self.comps[c]
            if k.qt is None:
                if self.qt[k.tq] is None:
                    raise _JpegError(f"quantization table {k.tq} is not "
                                     "defined (DQT)")
                k.qt = self.qt[k.tq].copy()
                k.coef = [0] * (k.bw * k.bh * 64)
            k.scanned = True
        if not self.std_tables:
            self.std_tables = True
            for i in range(2):
                if self.dc[i] is None:
                    self.dc[i] = _Huff(_DC_COUNTS[i], _DC_SYMBOLS)
                if self.ac[i] is None:
                    self.ac[i] = _Huff(_AC_COUNTS[i], _AC_SYMBOLS[i])
        kind = "seq"
        if self.progressive:
            bad = (se != 0) if ss == 0 else (ss > se or se > 63 or ns != 1)
            if (ah != 0 and al != ah - 1) or al > 13:
                bad = True
            if bad:
                raise _JpegError(f"bad progressive scan (Ss={ss} Se={se} "
                                 f"Ah={ah} Al={al})")
            for c in comps:
                k = self.comps[c]
                if ss > 0 and k.coef_bits[0] < 0:
                    raise _JpegError(f"bogus progression: AC scan before DC "
                                     f"(component {c})")
                for i in range(ss, se + 1):
                    expected = max(k.coef_bits[i], 0)
                    if ah != expected:
                        raise _JpegError(f"bogus progression: component {c} "
                                         f"coefficient {i} (Ah={ah})")
                    k.coef_bits[i] = al
            kind = ("dc_first" if ah == 0 else "dc_refine") if ss == 0 \
                else ("ac_first" if ah == 0 else "ac_refine")
        for i in range(ns):
            if kind in ("seq", "dc_first"):
                t = self.dc[td[i]]
                if t is None:
                    raise _JpegError(f"Huffman table DC{td[i]} is not "
                                     "defined (DHT)")
                if t.lut is None:
                    t.build(True)
            if kind in ("seq", "ac_first", "ac_refine"):
                t = self.ac[ta[i]]
                if t is None:
                    raise _JpegError(f"Huffman table AC{ta[i]} is not "
                                     "defined (DHT)")
                if t.lut is None:
                    t.build(False)
        self.scans += 1

        segments, end = self._entropy_segments()
        state = {"seg": 0, "bits": _Segment(segments[0][1]), "eobrun": 0,
                 "pred": [0] * len(self.comps)}
        ri = self.restart_interval
        left = ri

        def restart(expected):
            nonlocal left
            state["seg"] += 1
            if state["seg"] >= len(segments):
                raise _JpegError(f"expected RST{expected} marker (corrupt "
                                 "file)")
            rst, data = segments[state["seg"]]
            if rst != expected:
                raise _JpegError(f"expected RST{expected} marker, found "
                                 f"0xFF{0xD0 + rst:02X} (corrupt file)")
            state["bits"] = _Segment(data)
            state["eobrun"] = 0
            state["pred"] = [0] * len(self.comps)
            left = ri

        decode_block = getattr(self, "_" + kind)
        # each MCU as a list of (component, scan index, block row, column)
        if ns == 1:
            k = self.comps[comps[0]]
            mcus = ([(comps[0], 0, by, bx)] for by in range(k.hib)
                    for bx in range(k.wib))
        else:
            def mcus_gen():
                for my in range(self.mcuy):
                    for mx in range(self.mcux):
                        yield [(c, i, my * self.comps[c].v + y,
                                mx * self.comps[c].h + x)
                               for i, c in enumerate(comps)
                               for y in range(self.comps[c].v)
                               for x in range(self.comps[c].h)]
            mcus = mcus_gen()
        next_rst = 0
        for mcu in mcus:
            if ri:
                if left == 0:
                    restart(next_rst)
                    next_rst = (next_rst + 1) & 7
                left -= 1
            try:
                for c, i, by, bx in mcu:
                    k = self.comps[c]
                    decode_block(state, c, k, self.dc[td[i]],
                                 self.ac[ta[i]], (by * k.bw + bx) * 64, ss,
                                 se, al)
            except IndexError:      # read past the zero padding
                state["bits"].pos = state["bits"].nbits + 1
            seg = state["bits"]
            if seg.pos > seg.nbits:
                raise _JpegError("entropy-coded data ends early (truncated "
                                 "or corrupt file)")
        if state["seg"] + 1 < len(segments):
            rst = segments[state["seg"] + 1][0]
            raise _JpegError(f"RST{rst} marker outside a scan (corrupt "
                             "file)")
        self.pos = end

    @staticmethod
    def _symbol(seg, table):
        e = table.lut[seg.window[seg.pos]]
        if not e:
            raise _JpegError("bad Huffman code in the entropy-coded data "
                             "(corrupt file)")
        seg.pos += e >> 8
        return e & 255

    @staticmethod
    def _bits(seg, s):
        if s == 0:
            return 0
        v = seg.window[seg.pos] >> (16 - s)
        seg.pos += s
        return v

    def _seq(self, state, c, k, dc, ac, base, ss, se, al):
        seg, coef, nat = state["bits"], k.coef, _NAT
        for i in range(64):
            coef[base + i] = 0
        s = self._symbol(seg, dc)
        diff = _extend(self._bits(seg, s), s) if s else 0
        state["pred"][c] += diff
        coef[base] = state["pred"][c]
        lut, window = ac.lut, seg.window
        i = 1
        while i < 64:
            e = lut[window[seg.pos]]
            if not e:
                raise _JpegError("bad Huffman code in the entropy-coded "
                                 "data (corrupt file)")
            seg.pos += e >> 8
            rs = e & 255
            r, s = rs >> 4, rs & 15
            if s:
                i += r
                if i > 63:
                    raise _JpegError("bad coefficient index in the "
                                     "entropy-coded data (corrupt file)")
                v = window[seg.pos] >> (16 - s)
                seg.pos += s
                coef[base + nat[i]] = _extend(v, s)
            else:
                if r != 15:
                    break
                i += 15
            i += 1

    def _dc_first(self, state, c, k, dc, ac, base, ss, se, al):
        seg = state["bits"]
        s = self._symbol(seg, dc)
        diff = _extend(self._bits(seg, s), s) if s else 0
        state["pred"][c] += diff
        k.coef[base] = state["pred"][c] * (1 << al)

    def _dc_refine(self, state, c, k, dc, ac, base, ss, se, al):
        if self._bits(state["bits"], 1):
            k.coef[base] |= 1 << al

    def _ac_first(self, state, c, k, dc, ac, base, ss, se, al):
        if state["eobrun"] > 0:
            state["eobrun"] -= 1
            return
        seg, coef, nat = state["bits"], k.coef, _NAT
        i = ss
        while i <= se:
            rs = self._symbol(seg, ac)
            r, s = rs >> 4, rs & 15
            if s:
                i += r
                if i > se:
                    raise _JpegError("bad coefficient index in the "
                                     "entropy-coded data (corrupt file)")
                coef[base + nat[i]] = _extend(self._bits(seg, s), s) * \
                    (1 << al)
            elif r == 15:
                i += 15
            else:
                eobrun = 1 << r
                if r:
                    eobrun += self._bits(seg, r)
                state["eobrun"] = eobrun - 1
                break
            i += 1

    def _ac_refine(self, state, c, k, dc, ac, base, ss, se, al):
        seg, coef, nat = state["bits"], k.coef, _NAT
        p1, m1 = 1 << al, -1 * (1 << al)

        def correct(pos):
            if self._bits(seg, 1) and (coef[pos] & p1) == 0:
                coef[pos] += p1 if coef[pos] >= 0 else m1

        i = ss
        if state["eobrun"] == 0:
            while i <= se:
                rs = self._symbol(seg, ac)
                r, s = rs >> 4, rs & 15
                if s:
                    if s != 1:
                        raise _JpegError("bad Huffman symbol in a refinement "
                                         "scan (corrupt file)")
                    s = p1 if self._bits(seg, 1) else m1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += self._bits(seg, r)
                    state["eobrun"] = eobrun
                    break
                while True:
                    pos = base + nat[i]
                    if coef[pos] != 0:
                        correct(pos)
                    else:
                        r -= 1
                        if r < 0:
                            break
                    i += 1
                    if i > se:
                        break
                if s:
                    if i > se:
                        raise _JpegError("bad coefficient index in the "
                                         "entropy-coded data (corrupt file)")
                    coef[base + nat[i]] = s
                i += 1
        if state["eobrun"] > 0:
            while i <= se:
                pos = base + nat[i]
                if coef[pos] != 0:
                    correct(pos)
                i += 1
            state["eobrun"] -= 1

    # -- output -------------------------------------------------------------
    def _plane(self, k) -> np.ndarray:
        """One component upsampled to (H, W) uint8."""
        coef = np.array(k.coef, np.int64).reshape(k.bh, k.bw, 64)
        blocks = _idct_blocks(coef[:k.hib, :k.wib].reshape(-1, 64), k.qt)
        plane = blocks.reshape(k.hib, k.wib, 8, 8).transpose(0, 2, 1, 3) \
            .reshape(k.hib * 8, k.wib * 8)[:k.dh, :k.dw].astype(np.int64)
        H, W = self.height, self.width
        hr, vr = self.maxh // k.h, self.maxv // k.v
        if vr == 2:
            # output row y: nearer input row y // 2, farther the row above
            # (even y) or below (odd y), edges replicated
            y = np.arange(H)
            near = plane[y // 2]
            far = plane[np.clip(np.where(y % 2, y // 2 + 1, y // 2 - 1),
                                0, k.dh - 1)]
            if hr == 1:
                bias = np.where(y % 2, 2, 1)[:, None]
                return ((near * 3 + far + bias) >> 2)[:, :W].astype(np.uint8)
            if k.dw <= 2:
                return np.repeat(near, 2, axis=1)[:, :W].astype(np.uint8)
            cs = near * 3 + far
            left = np.concatenate([cs[:, :1], cs[:, :-1]], 1)
            right = np.concatenate([cs[:, 1:], cs[:, -1:]], 1)
            out = np.empty((H, 2 * k.dw), np.int64)
            out[:, 0::2] = (cs * 3 + left + 8) >> 4
            out[:, 1::2] = (cs * 3 + right + 7) >> 4
            return out[:, :W].astype(np.uint8)
        rows = plane[:H]
        if hr == 1:
            return rows[:, :W].astype(np.uint8)
        if k.dw <= 2:
            return np.repeat(rows, 2, axis=1)[:, :W].astype(np.uint8)
        left = np.concatenate([rows[:, :1], rows[:, :-1]], 1)
        right = np.concatenate([rows[:, 1:], rows[:, -1:]], 1)
        out = np.empty((H, 2 * k.dw), np.int64)
        out[:, 0::2] = (rows * 3 + left + 1) >> 2
        out[:, 1::2] = (rows * 3 + right + 2) >> 2
        return out[:, :W].astype(np.uint8)

    def _output(self) -> np.ndarray:
        planes = [self._plane(k) for k in self.comps]
        if self.nc == 1:
            return np.repeat(planes[0][..., None], 3, axis=2)
        if self.jfif:
            ycc = True
        elif self.adobe:
            ycc = self.adobe_transform != 0
        else:
            ycc = [k.id for k in self.comps] != [ord("R"), ord("G"),
                                                 ord("B")]
        if not ycc:
            return np.stack(planes, -1)
        y = planes[0].astype(np.int64)
        cb, cr = planes[1], planes[2]
        r = y + _CR_R[cr]
        g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
        b = y + _CB_B[cb]
        return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# the plain twin: encoding
# ---------------------------------------------------------------------------

def quality_tables(quality: int) -> np.ndarray:
    """(2, 64) natural-order tables of jpeg_set_quality(quality, TRUE)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((STD_QUANT * scale + 50) // 100, 1, 255)


def _divisors(qt: np.ndarray):
    """libjpeg-turbo's reciprocal quantiser (16-bit DCTELEM) for the
    islow divisors ``qt << 3``: (recip, corr, shift) arrays."""
    recip, corr, shift = [], [], []
    for q in (qt.astype(np.int64) << 3).tolist():
        b = q.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, q)
        c = q // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= q // 2:
            c += 1
        else:
            fq += 1
        recip.append(fq)
        corr.append(c)
        shift.append(r)
    return np.array(recip), np.array(corr), np.array(shift)


def _fdct_pass(x, first: bool):
    """One 1-D islow FDCT over the last axis of int64 ``x``."""
    f = _F
    t0, t7 = x[..., 0] + x[..., 7], x[..., 0] - x[..., 7]
    t1, t6 = x[..., 1] + x[..., 6], x[..., 1] - x[..., 6]
    t2, t5 = x[..., 2] + x[..., 5], x[..., 2] - x[..., 5]
    t3, t4 = x[..., 3] + x[..., 4], x[..., 3] - x[..., 4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    sh = _CONST_BITS - _PASS1_BITS if first else _CONST_BITS + _PASS1_BITS
    if first:
        o0, o4 = (t10 + t11) << _PASS1_BITS, (t10 - t11) << _PASS1_BITS
    else:
        o0 = _descale(t10 + t11, _PASS1_BITS)
        o4 = _descale(t10 - t11, _PASS1_BITS)
    z1 = (t12 + t13) * f["f0_541196100"]
    o2 = _descale(z1 + t13 * f["f0_765366865"], sh)
    o6 = _descale(z1 + t12 * -f["f1_847759065"], sh)
    o7, o5, o3, o1 = (_descale(v, sh) for v in _odd_part(t4, t5, t6, t7))
    return np.stack([o0, o1, o2, o3, o4, o5, o6, o7], -1)


def _downsample(src: np.ndarray, he: int, ve: int, cols: int, rows: int,
                group_rows: int) -> np.ndarray:
    """A full-resolution plane downsampled by (he, ve) as libjpeg does it,
    with the right edge replicated out to ``cols * he`` columns, the last
    row group padded with the last row, and the result's last row
    replicated down to ``rows``."""
    H, W = src.shape
    ys = np.minimum(np.arange(group_rows), H - 1)
    xs = np.minimum(np.arange(cols * he), W - 1)
    full = src[ys][:, xs].astype(np.int64)
    if (he, ve) == (1, 1):
        out = full
    elif (he, ve) == (2, 2):
        bias = 1 + np.arange(cols) % 2
        out = (full[0::2, 0::2] + full[0::2, 1::2] + full[1::2, 0::2]
               + full[1::2, 1::2] + bias) >> 2
    else:   # (1, 2): int_downsample
        out = (full[0::2] + full[1::2] + 1) // 2
    pad = np.minimum(np.arange(rows), out.shape[0] - 1)
    return out[pad]


def _huff_codes(counts, symbols):
    code, k, codes, sizes = 0, 0, [0] * 256, [0] * 256
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]], sizes[symbols[k]] = code, length
            k += 1
            code += 1
        code <<= 1
    return codes, sizes


def _pack_bits(codes, sizes) -> bytes:
    """Concatenate the codes MSB first, pad the last byte with 1 bits and
    stuff a zero byte after every 0xFF."""
    codes = np.asarray(codes, np.int64)
    sizes = np.asarray(sizes, np.int64)
    ends = np.cumsum(sizes)
    total = int(ends[-1]) if len(ends) else 0
    nbytes = -(-total // 8)
    bits = np.ones(nbytes * 8, np.uint8)
    starts = ends - sizes
    for j in range(int(sizes.max(initial=0))):
        sel = sizes > j
        bits[starts[sel] + j] = (codes[sel] >> (sizes[sel] - 1 - j)) & 1
    raw = np.packbits(bits)
    ff = np.flatnonzero(raw == 0xFF)
    return np.insert(raw, ff + 1, 0).tobytes()


def _quantised_blocks(image: np.ndarray, qt: np.ndarray, hs: int = 2,
                      vs: int = 2):
    """The three components' quantised blocks of (H, W, 3) uint8 RGB, with
    their dummy blocks, for :func:`baseline_file`: ``qt`` the (2, 64)
    tables, the luma sampled (hs, vs) = (2, 2) (4:2:0, what the encoder
    writes) or (1, 2) (4:4:0, libjpeg's ``int_downsample``, which Pillow
    cannot write: the decoder's test inputs)."""
    if (hs, vs) not in ((2, 2), (1, 2)):
        raise _JpegError(f"luma sampling {hs}x{vs} is not written")
    H, W, _ = image.shape
    if not (1 <= H <= 65535 and 1 <= W <= 65535):
        raise _JpegError(f"image size {W}x{H} out of range")
    rgb = image.astype(np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    half, offset = 1 << 15, 128 << 16
    ycc = [
        (_fix16(0.29900) * r + _fix16(0.58700) * g + _fix16(0.11400) * b
         + half) >> 16,
        (-_fix16(0.16874) * r - _fix16(0.33126) * g + _fix16(0.5) * b
         + offset + half - 1) >> 16,
        (_fix16(0.5) * r - _fix16(0.41869) * g - _fix16(0.08131) * b
         + offset + half - 1) >> 16]
    samp = [(hs, vs), (1, 1), (1, 1)]
    mcux, mcuy = -(-W // (8 * hs)), -(-H // (8 * vs))
    group_rows = -(-H // vs) * vs
    blocks = []
    for c, (h, v) in enumerate(samp):
        wib, hib = -(-W * h // (8 * hs)), -(-H * v // (8 * vs))
        px = _downsample(ycc[c], hs // h, vs // v, wib * 8, mcuy * v * 8,
                         group_rows)
        x = (px[:hib * 8] - 128).reshape(hib, 8, wib, 8).transpose(0, 2, 1, 3)
        x = _fdct_pass(x, True)
        x = _fdct_pass(x.transpose(0, 1, 3, 2), False).transpose(0, 1, 3, 2)
        recip, corr, shift = _divisors(qt[0 if c == 0 else 1])
        t = x.reshape(hib, wib, 64)
        q = ((np.abs(t) + corr) * recip) >> shift
        coef = np.zeros((mcuy * v, mcux * h, 64), np.int64)
        coef[:hib, :wib] = np.where(t < 0, -q, q)
        # dummy blocks: the DC of the block to the left, or of the MCU's
        # last block of the row above
        for bx in range(wib, mcux * h):
            coef[:hib, bx, 0] = coef[:hib, bx - 1, 0]
        for by in range(hib, mcuy * v):
            for mx in range(mcux):
                coef[by, mx * h:(mx + 1) * h, 0] = \
                    coef[by - 1, mx * h + h - 1, 0]
        blocks.append(coef)
    return blocks


def baseline_file(blocks, qt: np.ndarray, height: int, width: int,
                  hs: int = 2, vs: int = 2, separate_scans: bool = False
                  ) -> bytes:
    """A baseline JFIF file of quantised coefficients, Huffman coded with
    the standard tables: the writer the encoder ends with.

    ``blocks`` holds each of the three components' (rows, cols, 64)
    natural-order blocks, whole MCUs with their dummy blocks; ``qt`` the
    (2, 64) natural-order tables (luma, chroma), written with 16 bits
    where a value passes 255.  ``separate_scans`` writes one
    non-interleaved scan per component (only the blocks that cover the
    component's samples) instead of one interleaved scan.
    """
    H, W = height, width
    samp = [(hs, vs), (1, 1), (1, 1)]
    mcux, mcuy = -(-W // (8 * hs)), -(-H // (8 * vs))
    out = bytearray(b"\xff\xd8\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01"
                    b"\x00\x01\x00\x00")
    for t in range(2):
        table = np.asarray(qt[t])[NATURAL]
        if table.max() > 255:
            out += b"\xff\xdb\x00\x83" + bytes([0x10 | t])
            out += table.astype(">u2").tobytes()
        else:
            out += b"\xff\xdb\x00\x43" + bytes([t])
            out += bytes(table.astype(np.uint8))
    out += b"\xff\xc0\x00\x11\x08" + H.to_bytes(2, "big") \
        + W.to_bytes(2, "big") + b"\x03"
    for c, (h, v) in enumerate(samp):
        out += bytes([c + 1, (h << 4) | v, 0 if c == 0 else 1])
    for t in range(2):
        for ac, counts, symbols in ((0, _DC_COUNTS[t], _DC_SYMBOLS),
                                    (1, _AC_COUNTS[t], _AC_SYMBOLS[t])):
            n = sum(counts)
            out += b"\xff\xc4" + (19 + n).to_bytes(2, "big") \
                + bytes([(ac << 4) | t]) + bytes(counts) + bytes(symbols[:n])

    dc_tab = [_huff_codes(_DC_COUNTS[t], _DC_SYMBOLS) for t in range(2)]
    ac_tab = [_huff_codes(_AC_COUNTS[t], _AC_SYMBOLS[t]) for t in range(2)]
    zz = [np.asarray(blk)[..., NATURAL] for blk in blocks]
    codes, sizes = [], []
    last = [0, 0, 0]

    def block(c, by, bx):
        dcc, dcs = dc_tab[0 if c == 0 else 1]
        acc, acs = ac_tab[0 if c == 0 else 1]
        blk = zz[c][by, bx]
        dc = int(blk[0])
        diff = dc - last[c]
        last[c] = dc
        nbits = abs(diff).bit_length()
        if nbits > 11:
            raise _JpegError("DC coefficient out of range")
        codes.append(dcc[nbits])
        sizes.append(dcs[nbits])
        if nbits:
            codes.append((diff - 1 if diff < 0 else diff)
                         & ((1 << nbits) - 1))
            sizes.append(nbits)
        prev = 0
        for k in np.flatnonzero(blk[1:]).tolist():
            k += 1
            run = k - prev - 1
            while run > 15:
                codes.append(acc[0xF0])
                sizes.append(acs[0xF0])
                run -= 16
            val = int(blk[k])
            nbits = abs(val).bit_length()
            if nbits > 10:
                raise _JpegError("AC coefficient out of range")
            s = (run << 4) + nbits
            codes.append(acc[s])
            sizes.append(acs[s])
            codes.append((val - 1 if val < 0 else val) & ((1 << nbits) - 1))
            sizes.append(nbits)
            prev = k
        if prev < 63:
            codes.append(acc[0])
            sizes.append(acs[0])

    def scan(header, order):
        nonlocal codes, sizes
        codes, sizes = [], []
        for args in order:
            block(*args)
        return bytes.fromhex(header) + _pack_bits(codes, sizes)

    if separate_scans:
        for c, (h, v) in enumerate(samp):
            wib, hib = -(-W * h // (8 * hs)), -(-H * v // (8 * vs))
            t = 0 if c == 0 else 0x11
            out += scan(f"ffda000801{c + 1:02x}{t:02x}003f00",
                        ((c, by, bx) for by in range(hib)
                         for bx in range(wib)))
    else:
        out += scan("ffda000c03010002110311003f00",
                    ((c, my * v + y, mx * h + x)
                     for my in range(mcuy) for mx in range(mcux)
                     for c, (h, v) in enumerate(samp)
                     for y in range(v) for x in range(h)))
    out += b"\xff\xd9"
    return bytes(out)
