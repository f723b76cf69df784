"""Host-side image byte decoding and the named-landmark layout.

The port's copy of rs_face_detection_tpu/utils/image_io.py:
``decode_image_bytes``, raw JPEG/PNG bytes -> (H, W, 3) uint8 BGR, alpha dropped
and grayscale replicated.  OpenCV and PIL are imported at the call, so the
package imports on a machine that has neither; such a machine feeds arrays.
"""

from __future__ import annotations

import io

import numpy as np


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


def named_landmarks_to_array(landmarks: dict) -> np.ndarray:
    """A named-landmark mapping -> the (5, 2) detector layout, rows
    [left_eye, right_eye, nose, left_mouth, right_mouth] (JAX's
    ``named_landmarks_to_array``, copied)."""
    order = ("left_eye", "right_eye", "nose", "left_mouth", "right_mouth")
    return np.asarray([landmarks[k] for k in order], dtype=np.float32)
