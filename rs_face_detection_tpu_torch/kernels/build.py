"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``_build/lib<name>-<hash>.so`` for ``sm_90a``.  The hash covers the
source and the flags, so an edited source builds anew and a stale library is
never loaded.  The build runs at first use (``load``), never at import, so
``python3 chip_smoke.py`` alone builds every kernel it runs.

Counterpart of rs_face_detection_tpu/runtime/native.py, which does the same
for the g++ host NMS; unlike it, a failed build raises: a CUDA caller has no
other path to take.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Dict, Optional, Set

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

#: -fmad=false: no FMA contraction, so products and sums round as the
#: reference's separate f32 ops do (the NMS threshold test is bit-exact).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: Libraries whose wrapper's setup has run.
_set_up: Set[str] = set()
#: nvcc's output (ptxas register and shared-memory report) per library.
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    """The nvcc binary: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    candidates = [
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, PATH)"
        )
    return found


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu builds to; the name carries the content hash."""
    source = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library of the same hash exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile into a temporary file and rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on csrc/{name}.cu ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_logs[name] = proc.stdout + proc.stderr
    return out


def load(name: str, setup: Optional[Callable[[ctypes.CDLL], None]] = None) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; memoized per process.

    ``setup`` (the wrapper's argtypes and restypes) runs once, under the
    lock, before any caller gets the library: concurrent first calls from
    serving threads never see a function without its signature."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        if setup is not None and name not in _set_up:
            setup(lib)
            _set_up.add(name)
        return lib
