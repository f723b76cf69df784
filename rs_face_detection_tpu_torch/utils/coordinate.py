"""Coordinate types and the BGR-to-RGB array conversion.

A copy of rs_face_detection_tpu/utils/coordinate.py: ``Coord2D`` and
``Coord3D`` (frozen dataclasses) and ``image_to_rgb_array``, which turns an
(H, W, 3) BGR image into a new RGB array and writes nothing to disk.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Coord2D:
    x: float
    y: float


@dataclass(frozen=True)
class Coord3D:
    x: float
    y: float
    z: float


def image_to_rgb_array(image_bgr: np.ndarray) -> np.ndarray:
    """(H, W, 3) BGR uint8 -> (H, W, 3) RGB uint8 array."""
    img = np.asarray(image_bgr)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3), got {img.shape}")
    return img[:, :, ::-1].copy()
