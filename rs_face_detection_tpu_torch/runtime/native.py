"""ctypes binding of the native runtime library (native/rsfd_native.cc).

The port's copy of rs_face_detection_tpu/runtime/native.py (that module's
package imports JAX): the same C library, ABI version 4, and its host entry
points with JAX's signatures, contracts and errors:

- ``decode_letterbox_batch``: JPEG bytes decoded with libjpeg and
  letterboxed (half-pixel bilinear, zero pad bottom/right, det_scale =
  new_h / src_h) on host threads; the serving path's canvases then equal
  the JAX server's default ones bit for bit;
- ``decode_letterbox``: the same for one payload, ValueError on a bad JPEG;
- ``nms``: greedy NMS over host (N, 5) rows, the contract of
  ops/nms.py::nms_numpy (the device path's NMS is the kernel K1);
- ``ensure_built``: build the library now and return its path.

JAX's ``s2d_batch`` / ``s4d_batch`` are TPU layouts and are not bound.

The library builds at first use, never at import, from the checkout's
``native/rsfd_native.cc`` with ``g++ -O3 -fPIC -shared -std=c++17 ...
-ljpeg -lpthread`` into ``rs_face_detection_tpu_torch/_build/`` (named by a
hash of the source and the flags); ``native/`` is never written.  As in
JAX, the loader is host code with a fallback: ``load`` never raises, and a
machine without g++ or libjpeg's headers serves through OpenCV instead
(serving/detection_server.py); ``unavailable_reason`` says why, and the
entry points raise RuntimeError with it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

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


def _build(force: bool = False) -> Path:
    out = library_path()
    if out.exists() and not force:
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


def ensure_built(force: bool = False) -> str:
    """Build the library if it is missing, or again when ``force`` is set;
    returns its path.  Raises OSError when the build fails (JAX's
    ``ensure_built`` raises from its ``make``)."""
    return str(_build(force))


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
        lib.rsfd_nms.restype = ctypes.c_int
        lib.rsfd_nms.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_float,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.rsfd_decode_letterbox.restype = ctypes.c_int
        lib.rsfd_decode_letterbox.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_size_t,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float),
        ]
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


def _library() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError(f"the native library is unavailable: {_reason}")
    return lib


def nms(dets: np.ndarray, thresh: float) -> List[int]:
    """Greedy NMS over (N, 5) [x1, y1, x2, y2, score] float32 rows in C++:
    the kept rows' indices, the contract of ops/nms.py::nms_numpy.  Any
    other shape raises ValueError before the C side could read past the
    buffer."""
    lib = _library()
    dets = np.ascontiguousarray(dets, dtype=np.float32)
    if dets.ndim != 2 or dets.shape[1] != 5:
        raise ValueError(f"dets must be (N, 5) [x1 y1 x2 y2 score]; got {dets.shape}")
    n = dets.shape[0]
    keep = np.zeros(n, dtype=np.int32)
    num = lib.rsfd_nms(
        dets.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        ctypes.c_float(thresh),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return keep[:num].tolist()


def decode_letterbox(data: bytes, dst_w: int, dst_h: int) -> Tuple[np.ndarray, float]:
    """Decode one JPEG and letterbox it: a (dst_h, dst_w, 3) uint8 BGR
    canvas and its det_scale.  ValueError when libjpeg cannot decode it."""
    lib = _library()
    out = np.zeros((dst_h, dst_w, 3), dtype=np.uint8)
    scale = ctypes.c_float(0.0)
    buf = np.frombuffer(data, dtype=np.uint8)
    rc = lib.rsfd_decode_letterbox(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(data),
        dst_w,
        dst_h,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(scale),
    )
    if rc != 0:
        raise ValueError("native JPEG decode failed")
    return out, float(scale.value)


def decode_letterbox_batch(
    payloads: Sequence[bytes], dst_w: int, dst_h: int, num_threads: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode and letterbox JPEG payloads on ``num_threads`` host threads
    (0: one per core): (imgs (N, dst_h, dst_w, 3) uint8 BGR, det_scales (N,)
    float32, ok (N,) bool); a payload libjpeg cannot decode is not ok."""
    lib = _library()
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
