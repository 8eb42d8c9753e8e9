# Frozen copy of lidar_object_detection_tpu_torch/utils/flax_msgpack.py:22-133 at 072d88e (the reader; the writer left out).
"""Reader of flax msgpack checkpoints, with the standard library, numpy
and torch: the reference reads the committed checkpoints itself.

A flax msgpack document is nested maps whose leaves are arrays in msgpack
extension type 1, the payload of which is a msgpack triple ``(shape,
dtype name, raw bytes)``.  Arrays come back as numpy arrays, ``bfloat16``
ones as ``torch.bfloat16`` tensors.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3     # a numpy scalar, as a 0-d array's encoding


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack document")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def read(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.read_map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.read_array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):
            n = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self.take(n))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xD4 <= b <= 0xD8:
            n = 1 << (b - 0xD4)
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        if b in (0xD9, 0xDA, 0xDB):
            n = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return str(self.take(n), "utf-8")
        if b in (0xDC, 0xDD):
            return self.read_array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.read_map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def read_array(self, n: int) -> list:
        return [self.read() for _ in range(n)]


def _array(shape: Tuple[int, ...], dtype_name: str, raw: bytes):
    shape = tuple(int(s) for s in shape)
    if dtype_name == "bfloat16":
        flat = torch.frombuffer(bytearray(raw), dtype=torch.int16)
        return flat.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def _ext(code: int, payload: bytes):
    if code in (EXT_NDARRAY, EXT_NPSCALAR):
        shape, dtype_name, raw = unpackb(payload)
        arr = _array(shape, dtype_name, raw)
        return arr if code == EXT_NDARRAY else arr[()]
    raise ValueError(f"unsupported msgpack extension type {code}")


def unpackb(data: bytes) -> Any:
    """Decode one msgpack document."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} trailing bytes "
                         "after the msgpack document")
    return out


def read_flax_msgpack(path: str) -> Any:
    """The state tree of a flax msgpack checkpoint file."""
    with open(path, "rb") as f:
        return unpackb(f.read())
