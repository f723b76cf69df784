"""Host-side image byte decoding and the named-landmark layout.

The port's copy of rs_face_detection_tpu/utils/image_io.py:
``decode_image_bytes``, raw JPEG/PNG bytes -> (H, W, 3) uint8 BGR, alpha dropped
and grayscale replicated.  OpenCV and PIL are imported at the call, so the
package imports on a machine that has neither; such a machine feeds arrays.

``decode_images`` decodes a batch's byte payloads in parallel on one
process-wide pool of host threads (``rsfd-decode``), built at its first use:
OpenCV's and PIL's decoders release the interpreter lock, so one batch of
JPEGs takes about the time of its largest share per CPU rather than the sum.
"""

from __future__ import annotations

import io
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

from . import tracing


def decode_image_bytes(data: bytes) -> np.ndarray:
    """Decode image bytes to an (H, W, 3) uint8 BGR array (OpenCV, else PIL)."""
    img = None
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imdecode(np.frombuffer(data, dtype=np.uint8), cv2.IMREAD_UNCHANGED)
    if img is None:
        try:
            from PIL import Image
        except ImportError as e:
            if cv2 is None:
                raise ValueError("no image decoder available (cv2 or PIL)") from e
            raise ValueError("could not decode image bytes") from e
        try:
            arr = np.asarray(Image.open(io.BytesIO(data)))
        except Exception as e:  # PIL raises several types for bad input
            raise ValueError(f"could not decode image bytes: {e}") from e
        # PIL decodes RGB(A); flip to BGR to match the OpenCV convention.
        img = arr[:, :, :3][:, :, ::-1] if arr.ndim == 3 and arr.shape[2] >= 3 else arr
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    elif img.shape[2] == 2:  # gray + alpha: replicate luminance
        img = np.repeat(img[:, :, :1], 3, axis=2)
    elif img.shape[2] == 4:
        img = img[:, :, :3]
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(img)


_pool: Optional[ThreadPoolExecutor] = None
_pool_lock = threading.Lock()


def _cpus() -> int:
    """The CPUs this process may run on."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # a platform without affinity
        return os.cpu_count() or 1


def _forget_pool() -> None:
    # A forked child has none of the parent's threads: it builds its own pool.
    global _pool, _pool_lock
    _pool, _pool_lock = None, threading.Lock()


os.register_at_fork(after_in_child=_forget_pool)


def _decode_pool() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(_cpus(), thread_name_prefix="rsfd-decode")
        return _pool


def _is_bytes(payload) -> bool:
    return isinstance(payload, (bytes, bytearray))


def decode_workers(payloads: Sequence) -> int:
    """The pool threads ``decode_images(payloads)`` decodes on: one per byte
    payload, at most one per CPU the process may use; 0 below two byte
    payloads, which decode on the calling thread."""
    n = sum(map(_is_bytes, payloads))
    return min(n, _cpus()) if n >= 2 else 0


def decode_images(payloads: Sequence) -> List[np.ndarray]:
    """``decode_image_bytes`` over a batch of payloads (bytes, or BGR arrays
    passed through as they are), in payload order.

    Two or more byte payloads decode on the shared pool, one task each, so
    at most ``decode_workers(payloads)`` threads work on the call; an
    undecodable payload raises as ``decode_image_bytes`` does, the first in
    payload order if several do.  The ``decode_pooled`` counter of the
    calling thread's innermost span (utils/tracing.py) counts the images
    decoded on the pool.
    """
    images = list(payloads)
    todo = [i for i, p in enumerate(payloads) if _is_bytes(p)]
    pooled = decode_workers(payloads) > 0
    decode = _decode_pool().map if pooled else map
    for i, image in zip(todo, decode(decode_image_bytes, [payloads[i] for i in todo])):
        images[i] = image
    tracing.count("decode_pooled", len(todo) if pooled else 0)
    return images


def named_landmarks_to_array(landmarks: dict) -> np.ndarray:
    """A named-landmark mapping -> the (5, 2) detector layout, rows
    [left_eye, right_eye, nose, left_mouth, right_mouth] (JAX's
    ``named_landmarks_to_array``, copied)."""
    order = ("left_eye", "right_eye", "nose", "left_mouth", "right_mouth")
    return np.asarray([landmarks[k] for k in order], dtype=np.float32)
