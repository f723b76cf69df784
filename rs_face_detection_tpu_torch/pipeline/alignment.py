"""5-point landmark alignment to the 112x112 ArcFace template.

Counterpart of rs_face_detection_tpu/pipeline/alignment.py: the similarity
is solved on the host (ops/umeyama.py); the warp runs on the image's device
(ops/image.py::warp_affine).  Without usable landmarks, a margin-44 crop
around the box (or a 6.25%-inset frame) is resized to the output size.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..configs import FaceAlignmentConfig

from ..ops.image import crop_resize, warp_affine
from ..ops.umeyama import umeyama_similarity_np
from ..utils.device import to_device


class FaceAlignment:
    def __init__(self, cfg: Optional[FaceAlignmentConfig] = None) -> None:
        self.cfg = cfg or FaceAlignmentConfig()
        self.template = np.asarray(self.cfg.standard_landmarks, dtype=np.float32)

    def estimate(self, landmarks: np.ndarray) -> Optional[np.ndarray]:
        """Landmarks -> template 2x3 similarity, or None if degenerate."""
        lm = np.asarray(landmarks, dtype=np.float32)
        if lm.shape != self.template.shape:
            return None
        spread = (lm - lm.mean(axis=0)).astype(np.float64)
        if (spread**2).sum() < 1e-6:  # coincident points: no similarity exists
            return None
        m = umeyama_similarity_np(lm, self.template)
        if not np.isfinite(m).all():
            return None
        return m

    def _crop_box(self, image_shape, bbox: Optional[np.ndarray]) -> np.ndarray:
        """Floored inclusive-corner crop box of the no-landmark fallback."""
        src_h, src_w = image_shape[:2]
        if bbox is None:
            det = np.array(
                [src_w * 0.0625, src_h * 0.0625, src_w - src_w * 0.0625, src_h - src_h * 0.0625],
                dtype=np.float32,
            )
        else:
            det = np.asarray(bbox[:4], dtype=np.float32)
        margin = 44.0
        bb = np.floor(
            np.array(
                [
                    max(det[0] - margin / 2.0, 0.0),
                    max(det[1] - margin / 2.0, 0.0),
                    min(det[2] + margin / 2.0, src_w - 1.0),
                    min(det[3] + margin / 2.0, src_h - 1.0),
                ],
                dtype=np.float32,
            )
        )
        if bb[2] < bb[0] or bb[3] < bb[1]:
            raise ValueError(f"bbox {det.tolist()} lies outside the {src_w}x{src_h} image")
        return bb

    def __call__(
        self,
        image_bgr: torch.Tensor,
        bbox: Optional[np.ndarray],
        landmarks: Optional[np.ndarray],
    ) -> torch.Tensor:
        """Align one (H, W, 3) uint8 face image on its device; returns an
        (out_h, out_w, 3) float32 BGR crop in [0, 255]."""
        out_w, out_h = self.cfg.image_size
        img = image_bgr.float()
        matrix = self.estimate(landmarks) if landmarks is not None else None
        if matrix is not None:
            return warp_affine(img[None], to_device(matrix, img.device)[None], out_h, out_w)[0]
        box = to_device(self._crop_box(img.shape, bbox), img.device)
        return crop_resize(img, box, out_h, out_w)
