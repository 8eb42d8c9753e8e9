"""Reader and writer of flax msgpack checkpoints, with the standard library
and numpy.

The committed detector checkpoints are written by
``flax.serialization.msgpack_serialize``: a msgpack document of nested maps
whose leaves are arrays in msgpack extension type 1, the payload of which
is itself a msgpack triple ``(shape, dtype name, raw bytes)``.  Neither
``msgpack`` nor flax is installed on every machine that serves the port,
so this module decodes the format itself: maps, arrays, str and bin of all
widths, ints, floats, nil and bool, and the ndarray extension.

Arrays come back as numpy arrays, except ``bfloat16`` ones (numpy has no
such type), which come back as ``torch.bfloat16`` tensors.

:func:`write_flax_msgpack` is the inverse: it encodes a tree of maps with
string keys, lists, scalars and arrays (numpy, or tensors, bfloat16 ones
as flax names them) as ``flax.serialization.msgpack_serialize`` does,
byte for byte (maps in sorted key order), so ``msgpack_restore`` reads the
file back.
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


def _pack_uint(n: int, small: int, codes) -> bytes:
    """A length or count: in the fixed form below ``small``, else the
    narrowest of the 8-, 16- and 32-bit forms whose codes are given."""
    if n < small and codes[0] is not None:
        return bytes([codes[0] | n])
    for code, fmt, limit in zip(codes[1:], (">B", ">H", ">I"),
                                (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} does not fit 32 bits")


def _pack_int(n: int) -> bytes:
    if 0 <= n <= 0x7F:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, bits in ((0xCC, ">B", 8), (0xCD, ">H", 16),
                                (0xCE, ">I", 32), (0xCF, ">Q", 64)):
            if n < 1 << bits:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, bits in ((0xD0, ">b", 8), (0xD1, ">h", 16),
                                (0xD2, ">i", 32), (0xD3, ">q", 64)):
            if n >= -(1 << (bits - 1)):
                return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit 64 bits")


def _array_payload(x) -> bytes:
    """flax's ndarray encoding: msgpack of (shape, dtype name, C bytes)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name = tuple(t.shape), "bfloat16"
            raw = t.view(torch.int16).numpy().tobytes()
            return packb((shape, name, raw))
        x = t.numpy()
    arr = np.asarray(x)
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured arrays are not serialized")
    return packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


def _pack(x, out: list) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int) and not isinstance(x, np.integer):
        out.append(_pack_int(x))
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        data = x.encode("utf-8")
        out.append(_pack_uint(len(data), 32, (0xA0, 0xD9, 0xDA, 0xDB)))
        out.append(data)
    elif isinstance(x, (bytes, bytearray)):
        out.append(_pack_uint(len(x), 0, (None, 0xC4, 0xC5, 0xC6)))
        out.append(bytes(x))
    elif isinstance(x, dict):
        # keys in sorted order, as flax's tree flattening leaves them
        out.append(_pack_uint(len(x), 16, (0x80, None, 0xDE, 0xDF)))
        for key in sorted(x):
            _pack(key, out)
            _pack(x[key], out)
    elif isinstance(x, (list, tuple)):
        out.append(_pack_uint(len(x), 16, (0x90, None, 0xDC, 0xDD)))
        for value in x:
            _pack(value, out)
    elif isinstance(x, (np.ndarray, np.generic, torch.Tensor)):
        payload = _array_payload(x)
        code = EXT_NPSCALAR if isinstance(x, np.generic) else EXT_NDARRAY
        n = len(payload)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            out.append(bytes([fixed[n], code]))
        else:
            out.append(_pack_uint(n, 0, (None, 0xC7, 0xC8, 0xC9))
                       + bytes([code]))
        out.append(payload)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def packb(tree: Any) -> bytes:
    """Encode one msgpack document."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


def write_flax_msgpack(path: str, tree: Any) -> None:
    """Write ``tree`` as a flax msgpack checkpoint file."""
    data = packb(tree)
    with open(path, "wb") as f:
        f.write(data)
