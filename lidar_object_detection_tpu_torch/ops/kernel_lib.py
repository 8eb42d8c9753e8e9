"""Build and load the port's CUDA kernels.

The sources under ``lidar_object_detection_tpu_torch/csrc/`` are compiled
on first use with ``nvcc`` for ``sm_90a`` into one shared library with a
plain C interface, which is loaded with ``ctypes``.  Each source compiles
to an object in its own ``nvcc`` process, all started together, and one
more ``nvcc`` links them.  The library lands in ``csrc/build/<hash>/``,
keyed by a hash of the sources and flags, so it is rebuilt only when they
change.  No PyTorch header is included: such a build takes minutes, this
one seconds.

Nothing here runs at import time; :func:`library` builds on its first
call.  Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("inside_counts.cu", "mask_assembly.cu", "nms.cu", "lap.cu",
           "rotated_nms.cu", "launch_floor.cu")
BUILD_ROOT = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    "inside_counts_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                             _I, _P),
    "mask_assemble_launch": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                             _P, _P, _P, _P, _F, _I, _I, _I, _P, _P),
    "mask_count_launch": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                          _P, _P, _I, _I, _P, _P),
    "mask_peak_launch": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                         _P, _I, _I, _P, _P),
    "nms_launch": (_P, _P, _P, _I, _I, _I, _F, _P, _P, _P),
    "lap_launch": (_P, _P, _P, _I, _I, _I, _P, _P),
    "rotated_nms_launch": (_P, _P, _P, _I, _I, _I, _F, _P, _P, _P, _P,
                           _P),
    "rotated_iou_pairs_launch": (_P, _I, _P, _P, _P, _I, _I, _I, _P, _P,
                                 _P),
}

# entry points for measurements only: launched by no path, counted nowhere
MEASURE_SIGNATURES = {"empty_launch": (_P,)}

_lib = None
build_info: dict = {}
# Launches of each kernel, counted by its wrapper where it launches it:
# a run shows through these that the main path went through the kernels.
LAUNCHES = {name[:-len("_launch")]: 0 for name in SIGNATURES}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the library if its hash has no build yet; returns its path.

    ``build_info`` records the seconds taken and ptxas' register and
    shared-memory report (``-Xptxas -v``) of a fresh build.
    """
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / "libport_kernels.so"
    if lib_path.exists():
        build_info.update(seconds=0.0, cached=True, path=str(lib_path))
        return lib_path
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        procs = []
        objects = []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            objects.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
                   str(CSRC / name), "-o", obj]
            procs.append((name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        reports = {}
        for name, proc in procs:
            text, _ = proc.communicate()
            reports[name] = text
            if proc.returncode != 0:
                for _, other in procs:
                    if other.poll() is None:
                        other.kill()
                raise RuntimeError(f"nvcc failed on {name}:\n{text}")
        tmp_lib = os.path.join(tmp, "libport_kernels.so")
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objects,
                               "-o", tmp_lib], capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        out_dir.mkdir(parents=True, exist_ok=True)
        os.replace(tmp_lib, lib_path)
    build_info.update(seconds=time.perf_counter() - t0, cached=False,
                      path=str(lib_path), ptxas=reports)
    if verbose:
        for name, text in reports.items():
            print(f"[{name}] {text.strip()}")
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in {**SIGNATURES, **MEASURE_SIGNATURES}.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def check_operand(t, name: str, dtype, shape, device) -> None:
    """Raise unless tensor ``t`` is on ``device``, of ``dtype`` and
    ``shape``, and contiguous: what a kernel's pointer may be given."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_handle(device) -> int:
    """The current PyTorch stream of ``device`` as a C pointer value."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def sm_count(device) -> int:
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count
