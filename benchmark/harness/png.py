# Adapted from lidar_object_detection_tpu_torch/utils/png.py:39-90 (the reader, 8-bit RGB and RGBA without interlacing only) and 178-219 (_unfilter, frozen) at 072d88e.
"""A PNG reader with the standard library and numpy, for the camera frames
the benchmark's traffic is made from (8-bit RGB or RGBA, not interlaced:
the committed frames' format)."""

import struct
import zlib

import numpy as np


def read_png_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB pixels of an 8-bit RGB or RGBA PNG file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in (2, 6) or interlace != 0:
        raise ValueError(f"{path}: only 8-bit RGB or RGBA without "
                         f"interlacing is read (bit depth {depth}, colour "
                         f"type {color}, interlace {interlace})")
    channels = 3 if color == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    row_bytes = width * channels
    if len(raw) != height * (row_bytes + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of pixel data")
    rows = raw.reshape(height, row_bytes + 1)
    if int(rows[:, 0].max(initial=0)) > 4:
        raise ValueError(f"{path}: unknown PNG filter")
    data = _unfilter(rows[:, 0], rows[:, 1:].reshape(height, width,
                                                     channels))
    return np.ascontiguousarray(data[..., :3])


def _unfilter(kinds: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Undo the row filters of (H, W, bpp) filtered bytes.

    Pixel (y, x) depends on its left, upper and upper-left neighbours, so
    every pixel of one anti-diagonal y + x = t depends only on the two
    diagonals before it.  The pixels are held diagonal by diagonal
    (``skew[t + 2, y + 1]``, with a zero border for the missing
    neighbours), and each step decodes one whole diagonal with numpy:
    H + W - 1 steps, rather than a Python step per byte of the Average and
    Paeth filters.
    """
    height, width, bpp = data.shape
    steps = height + width - 1
    ys = np.arange(height)[:, None]
    diag = ys + np.arange(width)[None, :]
    filtered = np.zeros((steps, height, bpp), np.int16)
    filtered[diag, ys] = data
    skew = np.zeros((steps + 2, height + 1, bpp), np.int16)
    kind = kinds.astype(np.int16)[:, None]
    present = set(np.unique(kinds).tolist())
    for t in range(steps):
        lo, hi = max(0, t - width + 1), min(height, t + 1)
        a = skew[t + 1, lo + 1:hi + 1]     # left
        b = skew[t + 1, lo:hi]             # up
        c = skew[t, lo:hi]                 # upper left
        k = kind[lo:hi]
        if 4 in present:                   # Paeth
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        else:
            pred = np.zeros_like(a)
        if 3 in present:                   # Average
            pred = np.where(k == 3, (a + b) >> 1, pred)
        if 2 in present:                   # Up
            pred = np.where(k == 2, b, pred)
        if 1 in present:                   # Sub
            pred = np.where(k == 1, a, pred)
        if 0 in present:                   # None
            pred = np.where(k == 0, 0, pred)
        skew[t + 2, lo + 1:hi + 1] = (filtered[t, lo:hi] + pred) & 0xFF
    return skew[diag + 2, ys + 1].astype(np.uint8)
