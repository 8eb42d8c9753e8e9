"""ctypes binding of the port's native scan loader (``csrc/lidar_loader.cpp``).

Counterpart of ``lidar_object_detection_tpu/data/native.py``: one scan read
and padded to a fixed shape, the same with the camera-frustum cull
(:class:`CompactionSpec`), and a threaded read-ahead over a frame list
(:class:`ScanPrefetcher`), which the streaming path
(``pipelines/runner.py`` ``FusionPipeline.stream``) runs.

The library is built from the port's own copy of the source on first use,
with ``g++ -O3 -std=c++17 -fPIC -shared -pthread``, into
``csrc/build/<hash>/liblidar_loader.so``, keyed by a hash of the source and
the flags (``utils/native_build.py``, which the JPEG codec shares).
Nothing builds at import time.

There is no quiet fallback: a failed build or load raises and carries the
compiler's output.  The NumPy code is the plain twin of the native code and
runs only when asked for (``backend="numpy"``); both give the same arrays.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from lidar_object_detection_tpu_torch.utils import native_build

CSRC = native_build.CSRC
SOURCE = CSRC / "lidar_loader.cpp"
BUILD_ROOT = native_build.BUILD_ROOT
CXX_FLAGS = native_build.CXX_FLAGS
BACKENDS = ("native", "numpy")


@dataclasses.dataclass(frozen=True)
class CompactionSpec:
    """Host-side FOV/depth point culling, done in the loader threads.

    Most of a KITTI-360 scan (about three quarters) lies outside the camera
    frustum and fails the device's validity test; culling those points on
    the host shrinks every per-point device stage.  The cull is
    CONSERVATIVE: ``margin`` pixels and 1e-3 of depth widen the bounds, and
    the device still applies the exact
    :func:`~lidar_object_detection_tpu_torch.geom.projection.point_validity`,
    so the fusion's outputs equal those of the uncompacted scans.
    """

    proj: np.ndarray          # (3, 4) f32: intrinsics @ velo_to_rect[:3, :]
    width: int
    height: int
    depth_min: float
    depth_max: float
    max_out: int              # fixed compacted point capacity
    margin: float = 1.0

    @staticmethod
    def build(velo_to_rect, intrinsics, width, height, depth_min, depth_max,
              max_out, margin: float = 1.0) -> "CompactionSpec":
        proj = (np.asarray(intrinsics, np.float64)
                @ np.asarray(velo_to_rect, np.float64)[:3, :])
        return CompactionSpec(proj=proj.astype(np.float32), width=int(width),
                              height=int(height), depth_min=float(depth_min),
                              depth_max=float(depth_max),
                              max_out=int(max_out), margin=float(margin))

    def cull_mask(self, points: np.ndarray) -> np.ndarray:
        """NumPy twin of the C++ predicate: keep-mask over (N, 4).

        It rounds as the scalar C++ path does (float32, each product and
        sum in the source's order, no fused multiply-add), so the two agree
        bit for bit.  The AVX-512 path fuses and multiplies by a reciprocal
        and may differ from both by an ulp at the widened bounds."""
        f = np.float32
        x, y, z = (points[:, i].astype(f) for i in range(3))
        m = self.proj.astype(f)
        row = lambda r: ((m[r, 0] * x + m[r, 1] * y) + m[r, 2] * z) + m[r, 3]
        depth = row(2)
        keep = ((depth > f(self.depth_min) - f(1e-3))
                & (depth < f(self.depth_max) + f(1e-3)))
        az = np.maximum(np.abs(depth), f(1e-6))
        u = row(0) / az
        v = row(1) / az
        lo = -(f(self.margin) + f(0.5))
        keep &= (u >= lo) & (u <= (f(self.width) - f(0.5)) + f(self.margin))
        keep &= (v >= lo) & (v <= (f(self.height) - f(0.5)) + f(self.margin))
        return keep


# ---------------------------------------------------------------------------
# building and loading the library
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_F = ctypes.c_float
_PF = ctypes.POINTER(ctypes.c_float)
_PU8 = ctypes.POINTER(ctypes.c_uint8)
_PI32 = ctypes.POINTER(ctypes.c_int32)
_PCHAR = ctypes.POINTER(ctypes.c_char_p)
SIGNATURES = {
    "lidar_load_scan": (ctypes.c_int, (ctypes.c_char_p, _PF, _I32, _PU8,
                                       _PI32)),
    "lidar_load_scan_compact": (ctypes.c_int, (
        ctypes.c_char_p, _PF, _F, _F, _F, _F, _F, _PF, _I32, _PU8, _PI32,
        _PI32)),
    "lidar_prefetcher_create": (_P, (_PCHAR, _I32, _I32, _I32, _I32)),
    "lidar_prefetcher_create_compact": (_P, (
        _PCHAR, _I32, _I32, _I32, _I32, _PF, _F, _F, _F, _F, _F)),
    "lidar_prefetcher_next": (ctypes.c_int, (_P, _PF, _PU8, _PI32, _PI32)),
    "lidar_prefetcher_destroy": (None, (_P,)),
}


def source_hash() -> str:
    return native_build.source_hash(SOURCE, CXX_FLAGS)


def build() -> Path:
    """Compile the library unless its hash has a build; returns its path.
    Raises with the compiler's output when the build fails."""
    return native_build.build(SOURCE, "liblidar_loader.so",
                              "the native scan loader", BUILD_ROOT,
                              CXX_FLAGS)


def library() -> ctypes.CDLL:
    """The loaded loader library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = native_build.load(build(), SIGNATURES)
        return _lib


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")


def _raise_for(rc: int, path: str, capacity: int, compacted: bool):
    """The exception of a native load's status ``rc``: the one the NumPy
    twin raises for the same file."""
    if rc == -1:
        raise FileNotFoundError(f"{path}: no such scan")
    if rc == -2:
        raise ValueError(f"{path}: not a whole number of 16-byte points")
    if rc == -3:
        raise ValueError(f"{path}: more than {capacity} points"
                         + (" after compaction" if compacted else ""))
    raise OSError(f"{path}: native load failed ({rc})")


def _read_raw(path: str) -> np.ndarray:
    """NumPy twin of the native read: (N, 4) float32, raising as
    :func:`_raise_for` does."""
    if not os.path.isfile(path):
        _raise_for(-1, path, 0, False)
    if os.path.getsize(path) % 16:
        _raise_for(-2, path, 0, False)
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def _padded(points: np.ndarray, capacity: int, path: str, compacted: bool
            ) -> Tuple[np.ndarray, np.ndarray, int]:
    n = points.shape[0]
    if n > capacity:
        _raise_for(-3, path, capacity, compacted)
    out = np.zeros((capacity, 4), np.float32)
    out[:n] = points
    valid = np.zeros((capacity,), bool)
    valid[:n] = True
    return out, valid, n


def _ptr(array: np.ndarray, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------------------------------------------------------------------
# the loads
# ---------------------------------------------------------------------------

def load_scan_padded(path: str, max_points: int, backend: str = "native"
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Load and pad one scan: (points (P, 4) f32, valid (P,) bool, n)."""
    _check_backend(backend)
    if backend == "numpy":
        return _padded(_read_raw(path), max_points, path, False)
    out = np.empty((max_points, 4), np.float32)
    valid = np.empty((max_points,), np.uint8)
    n = ctypes.c_int32(0)
    rc = library().lidar_load_scan(path.encode(), _ptr(out, ctypes.c_float),
                                   max_points, _ptr(valid, ctypes.c_uint8),
                                   ctypes.byref(n))
    if rc != 0:
        _raise_for(rc, path, max_points, False)
    return out, valid.view(np.bool_), int(n.value)


def load_scan_compacted(path: str, spec: CompactionSpec,
                        backend: str = "native"
                        ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Load one scan with the host-side FOV/depth cull: (points (max_out, 4)
    f32 zero-padded, valid (max_out,) bool, n).  The NumPy twin applies the
    same predicate (:meth:`CompactionSpec.cull_mask`)."""
    _check_backend(backend)
    if backend == "numpy":
        raw = _read_raw(path)
        return _padded(raw[spec.cull_mask(raw)], spec.max_out, path, True)
    out = np.empty((spec.max_out, 4), np.float32)
    valid = np.empty((spec.max_out,), np.uint8)
    n = ctypes.c_int32(0)
    proj = np.ascontiguousarray(spec.proj, np.float32)
    rc = library().lidar_load_scan_compact(
        path.encode(), _ptr(proj, ctypes.c_float), spec.width, spec.height,
        spec.depth_min, spec.depth_max, spec.margin,
        _ptr(out, ctypes.c_float), spec.max_out,
        _ptr(valid, ctypes.c_uint8), ctypes.byref(n), None)
    if rc != 0:
        _raise_for(rc, path, spec.max_out, True)
    return out, valid.view(np.bool_), int(n.value)


class ScanPrefetcher:
    """Threaded read-ahead over a list of scan files.

    Yields ``(frame_index, points, valid, num_points)`` in completion order
    (``frame_index`` indexes ``paths``).  The native backend runs
    ``num_threads`` C++ threads with at most ``queue_depth`` finished scans
    waiting; its NumPy twin a Python thread pool.  A scan that fails to load
    raises, when its turn comes, the exception :func:`load_scan_padded`
    would raise for it.

    With ``compaction`` set, the loader threads also project and cull each
    scan (:class:`CompactionSpec`), and the yielded arrays are
    ``(spec.max_out, 4)`` compacted buffers instead of full padded scans.
    """

    def __init__(self, paths: List[str], max_points: int,
                 num_threads: int = 2, queue_depth: int = 4,
                 compaction: Optional[CompactionSpec] = None,
                 backend: str = "native"):
        _check_backend(backend)
        self.paths = list(paths)
        self.compaction = compaction
        self.max_points = compaction.max_out if compaction else max_points
        self.num_threads = num_threads
        self.queue_depth = queue_depth
        self.backend = backend

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray, np.ndarray, int]]:
        if self.backend == "numpy":
            yield from self._numpy_iter()
            return
        lib = library()
        c_paths = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        spec = self.compaction
        if spec is not None:
            proj = np.ascontiguousarray(spec.proj, np.float32)
            handle = lib.lidar_prefetcher_create_compact(
                c_paths, len(self.paths), spec.max_out, self.num_threads,
                self.queue_depth, _ptr(proj, ctypes.c_float), spec.width,
                spec.height, spec.depth_min, spec.depth_max, spec.margin)
        else:
            handle = lib.lidar_prefetcher_create(
                c_paths, len(self.paths), self.max_points, self.num_threads,
                self.queue_depth)
        try:
            while True:
                out = np.empty((self.max_points, 4), np.float32)
                valid = np.empty((self.max_points,), np.uint8)
                n = ctypes.c_int32(0)
                idx = ctypes.c_int32(0)
                rc = lib.lidar_prefetcher_next(
                    handle, _ptr(out, ctypes.c_float),
                    _ptr(valid, ctypes.c_uint8), ctypes.byref(n),
                    ctypes.byref(idx))
                if rc == 1:
                    break
                if rc != 0:
                    _raise_for(rc, self.paths[idx.value], self.max_points,
                               spec is not None)
                yield int(idx.value), out, valid.view(np.bool_), int(n.value)
        finally:
            lib.lidar_prefetcher_destroy(handle)

    def _numpy_iter(self):
        from concurrent.futures import ThreadPoolExecutor, as_completed

        if self.compaction is not None:
            load = lambda p: load_scan_compacted(p, self.compaction, "numpy")
        else:
            load = lambda p: load_scan_padded(p, self.max_points, "numpy")
        with ThreadPoolExecutor(max_workers=self.num_threads) as ex:
            futures = {ex.submit(load, p): i
                       for i, p in enumerate(self.paths)}
            for fut in as_completed(futures):
                pts, valid, n = fut.result()
                yield futures[fut], pts, valid, n
