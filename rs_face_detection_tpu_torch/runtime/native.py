"""ctypes binding of the native JPEG loader (native/rsfd_native.cc).

The port's copy of the loader half of rs_face_detection_tpu/runtime/
native.py (that module's package imports JAX): the same C library, ABI
version 4, whose ``rsfd_decode_letterbox_batch`` decodes JPEG bytes with
libjpeg and letterboxes them (half-pixel bilinear, zero pad bottom/right,
det_scale = new_h / src_h) on host threads.  The serving path's canvases
then equal the JAX server's default ones bit for bit.

The library builds at first use, never at import, from the checkout's
``native/rsfd_native.cc`` with ``g++ -O3 -fPIC -shared -std=c++17 ...
-ljpeg -lpthread`` into ``rs_face_detection_tpu_torch/_build/`` (named by a
hash of the source and the flags); ``native/`` is never written.  As in
JAX, the loader is host code with a fallback: ``load`` never raises, and a
machine without g++ or libjpeg's headers serves through OpenCV instead
(serving/detection_server.py); ``unavailable_reason`` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from ..kernels.build import BUILD_DIR, PACKAGE_DIR

SOURCE = PACKAGE_DIR.parent / "native" / "rsfd_native.cc"
ABI_VERSION = 4
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
LIBS = ("-ljpeg", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_reason: Optional[str] = None  # why the library is unavailable, once known


def library_path() -> Path:
    """Where the library builds to; the name carries the content hash."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"librsfd_native-{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # A temporary file renamed at the end: an interrupted or concurrent
    # build never leaves a half-written library under the final name.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE), *LIBS], capture_output=True, text=True
        )
        if proc.returncode != 0:
            errors = [ln for ln in proc.stderr.splitlines() if "error" in ln] or proc.stderr.splitlines()[-1:]
            raise OSError(f"g++ failed on {SOURCE.name} ({proc.returncode}): {' | '.join(errors)[:400]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the library; None when it cannot be, with
    the reason kept for ``unavailable_reason``.  Never raises, and a failure
    is remembered, so serving does not retry a doomed build per batch."""
    global _lib, _reason
    with _lock:
        if _lib is not None or _reason is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
            lib.rsfd_abi_version.restype = ctypes.c_int
            version = lib.rsfd_abi_version()
            if version != ABI_VERSION:
                raise OSError(f"ABI version {version}, expected {ABI_VERSION}")
        except (OSError, FileNotFoundError, subprocess.SubprocessError) as e:
            _reason = str(e) or type(e).__name__
            return None
        lib.rsfd_decode_letterbox_batch.restype = None
        lib.rsfd_decode_letterbox_batch.argtypes = [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def unavailable_reason() -> Optional[str]:
    """Why the library could not be built or loaded (None if it loads)."""
    load()
    return _reason


def decode_letterbox_batch(
    payloads: Sequence[bytes], dst_w: int, dst_h: int, num_threads: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode and letterbox JPEG payloads on ``num_threads`` host threads
    (0: one per core): (imgs (N, dst_h, dst_w, 3) uint8 BGR, det_scales (N,)
    float32, ok (N,) bool); a payload libjpeg cannot decode is not ok."""
    lib = load()
    if lib is None:
        raise RuntimeError(f"the native loader is unavailable: {_reason}")
    n = len(payloads)
    imgs = np.zeros((n, dst_h, dst_w, 3), dtype=np.uint8)
    scales = np.ones((n,), dtype=np.float32)
    status = np.zeros((n,), dtype=np.int32)
    if n == 0:
        return imgs, scales, status == 0
    bufs = [np.frombuffer(p, dtype=np.uint8) for p in payloads]
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)(*[b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) for b in bufs])
    lens = (ctypes.c_size_t * n)(*[len(p) for p in payloads])
    lib.rsfd_decode_letterbox_batch(
        ptrs,
        lens,
        n,
        dst_w,
        dst_h,
        imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        scales.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        num_threads,
    )
    return imgs, scales, status == 0
