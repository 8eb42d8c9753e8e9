"""PNG decoding and encoding with the standard library and numpy.

The JAX package decodes camera frames with PIL, as
``Image.open(path).convert("RGB")`` (``data/kitti360.py``), which the
card's machine does not promise.  This reader decodes every standard PNG
format to the pixels that call gives:

* colour types 0 (grey), 2 (RGB), 3 (palette), 4 (grey and alpha) and 6
  (RGBA), at each bit depth the format allows (1, 2, 4, 8 and 16);
* Adam7 interlacing and all five row filters.

The reductions to 8-bit RGB are Pillow's: grey of 1, 2 and 4 bits is
scaled to 0-255 (x 255, x 85, x 17); 16-bit grey is clipped to 255;
16-bit RGB, RGBA and grey-and-alpha samples keep their high byte; a palette
index past the PLTE entries is black; alpha and tRNS are dropped.

The writer, :func:`write_png_rgb`, stores 8-bit RGB with each row's filter
chosen as libpng's default encoder chooses it.  It is the port's image
writer (depth-map figures, segmentation overlays), where the JAX package
draws with matplotlib and saves with PIL.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples per pixel, allowed bit depths)
_FORMATS = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
            4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def read_png_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB pixels of a PNG file, as PIL's
    ``convert("RGB")`` gives them."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header, palette = 8, [], None, None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if color not in _FORMATS or depth not in _FORMATS[color][1] \
            or interlace not in (0, 1):
        raise ValueError(f"{path}: not a standard PNG format (bit depth "
                         f"{depth}, colour type {color}, interlace "
                         f"{interlace})")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    channels = _FORMATS[color][0]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if interlace == 0:
        samples, used = _decode_pass(raw, width, height, channels, depth)
    else:
        samples = np.zeros((height, width, channels), np.uint16)
        used = 0
        for x0, y0, dx, dy in _ADAM7:
            pw = (width - x0 + dx - 1) // dx
            ph = (height - y0 + dy - 1) // dy
            if pw <= 0 or ph <= 0:
                continue
            part, n = _decode_pass(raw[used:], pw, ph, channels, depth)
            samples[y0::dy, x0::dx] = part
            used += n
    if used != len(raw):
        raise ValueError(f"{path}: {len(raw)} bytes of pixel data, expected "
                         f"{used}")
    return _to_rgb(samples, color, depth, palette)


def png_filter_rows(image: np.ndarray) -> np.ndarray:
    """Filter the rows of (H, W, 3) uint8 as libpng's default encoder does:
    each row takes whichever of the five filters gives the least sum of
    absolute signed bytes.  Returns the (H, 1 + 3 W) filtered rows."""
    h, w, _ = image.shape
    x = image.reshape(h, w * 3).astype(np.int16)
    a = np.zeros_like(x)
    a[:, 3:] = x[:, :-3]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 3:] = x[:-1, :-3]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cand = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth]) & 0xFF
    cost = np.minimum(cand, 256 - cand).sum(axis=2)      # (5, H)
    kinds = cost.argmin(axis=0)
    rows = cand[kinds, np.arange(h)].astype(np.uint8)
    return np.concatenate([kinds[:, None].astype(np.uint8), rows], 1)


def write_png_rgb(path: str, image: np.ndarray) -> None:
    """Write (H, W, 3) uint8 as an 8-bit RGB PNG with zlib only, the rows
    filtered adaptively (:func:`png_filter_rows`)."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, _ = image.shape

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(
                    png_filter_rows(image).tobytes(), 6))
                + chunk(b"IEND", b""))


def _decode_pass(raw: np.ndarray, width: int, height: int, channels: int,
                 depth: int):
    """Unfilter and unpack one (sub-)image of ``height`` rows from the
    front of ``raw``.  Returns ((H, W, channels) integer samples, bytes
    used)."""
    row_bytes = (width * channels * depth + 7) // 8
    used = height * (row_bytes + 1)
    if len(raw) < used:
        raise ValueError(f"{len(raw)} bytes of pixel data, expected at "
                         f"least {used}")
    rows = raw[:used].reshape(height, row_bytes + 1)
    kinds = rows[:, 0]
    if int(kinds.max(initial=0)) > 4:
        raise ValueError(f"unknown PNG filter {int(kinds.max())}")
    # the filters predict from the byte one whole pixel to the left (one
    # byte when a pixel is smaller than a byte)
    bpp = max(1, channels * depth // 8)
    data = _unfilter(kinds, rows[:, 1:].reshape(height, row_bytes // bpp,
                                                bpp))
    data = data.reshape(height, row_bytes)
    if depth == 8:
        out = data.reshape(height, width, channels)
    elif depth == 16:
        out = data.reshape(height, width, channels, 2)
        out = (out[..., 0].astype(np.uint16) << 8) | out[..., 1]
    else:
        bits = np.unpackbits(data, axis=1).reshape(height, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        out = (bits * weights).sum(axis=2)[:, :width, None]
    return out, used


def _to_rgb(samples: np.ndarray, color: int, depth: int, palette):
    """(H, W, C) samples -> (H, W, 3) uint8, with Pillow's reductions."""
    if color == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[samples[..., 0]]
    if depth < 8:
        samples = samples * (255 // ((1 << depth) - 1))
    elif depth == 16:
        samples = (np.minimum(samples, 255) if color == 0
                   else samples >> 8)
    if color in (0, 4):
        return np.repeat(samples[..., :1].astype(np.uint8), 3, axis=2)
    return np.ascontiguousarray(samples[..., :3].astype(np.uint8))


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
