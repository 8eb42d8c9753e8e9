"""Building and loading the port's host C++ libraries with ``g++``.

Each library is compiled from the port's own source on first use, into
``<build_root>/<hash>/<name>``, keyed by a hash of the source and the
flags.  The compiler writes a temporary file that is then moved into
place, so processes that build at once do not see each other's
half-written library.  Nothing builds at import time, and a failed build
or load raises with the compiler's output: there is no quiet fallback.

The scan loader (``data/native.py``, ``csrc/lidar_loader.cpp``) and the
JPEG codec (``utils/jpeg.py``, ``csrc/jpeg_codec.cpp``) are built here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared",
             "-pthread")


def _compiler(what: str, source: Path) -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: {what} is built from {source} "
                           "with the host's C++ compiler")
    return cxx


def source_hash(source: Path, flags: Sequence[str] = CXX_FLAGS) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(Path(source).read_bytes())
    return h.hexdigest()[:16]


def build(source: Path, lib_name: str, what: str,
          build_root: Path = BUILD_ROOT,
          flags: Sequence[str] = CXX_FLAGS) -> Path:
    """Compile ``source`` into ``build_root/<hash>/lib_name`` unless that
    exists; returns its path.  Raises with the compiler's output when the
    build fails."""
    out_dir = Path(build_root) / source_hash(source, flags)
    lib_path = out_dir / lib_name
    if lib_path.exists():
        return lib_path
    cxx = _compiler(what, source)
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *flags, str(source), "-o", tmp],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {what} failed ({cxx} exited "
                f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def load(path: Path, signatures: Dict[str, Tuple[object, tuple]]
         ) -> ctypes.CDLL:
    """``ctypes.CDLL`` of ``path`` with each function's ``restype`` and
    ``argtypes`` set from ``signatures``."""
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = list(argtypes)
    return lib
