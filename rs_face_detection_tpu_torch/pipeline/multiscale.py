"""Size-bucketed multi-scale detection (the high-resolution path).

Counterpart of rs_face_detection_tpu/pipeline/multiscale.py.  A small set
of detector input sizes ("buckets") serves any input resolution: RetinaFace
and SCRFD are fully convolutional, so ONE module serves every bucket, and
each bucket holds only its own anchor table.  An image goes to the smallest
bucket that contains it; anything larger than the biggest bucket is
letterboxed down into it.  Every call detects at its bucket's size with one
NMS launch (K1 on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from ..configs import FaceDetectionConfig
from ..models.registry import ModelRegistry
from ..utils.device import DeviceLike
from .detection import RetinaFaceDetection

DEFAULT_BUCKETS: Tuple[Tuple[int, int], ...] = ((640, 640), (1280, 768), (1920, 1088))


class MultiScaleDetection:
    """Route images to per-resolution detectors that share one module."""

    def __init__(
        self,
        buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS,
        cfg: Optional[FaceDetectionConfig] = None,
        registry: Optional[ModelRegistry] = None,
        model=None,
        device: DeviceLike = "cuda",
        detector_factory=None,
    ) -> None:
        """Buckets are (width, height).  ``model`` (or ``cfg.model_name`` from
        ``registry``, or from the default registry on ``device``) serves the
        smallest bucket's RetinaFaceDetection; every other bucket gets the
        same module and the first detector's registry, so every bucket's
        calls feed the statistics.  ``detector_factory(image_size, model) ->
        detector`` builds the ladder of another family instead (SCRFD:
        ``lambda size, m: SCRFDDetection(model=m, image_size=size)``); it is
        called with ``model`` for the first bucket, then with the first
        detector's module."""
        if not buckets:
            raise ValueError("need at least one bucket")
        base = cfg or FaceDetectionConfig()
        # Ascending by area.
        self.buckets = sorted((tuple(b) for b in buckets), key=lambda b: b[0] * b[1])
        if detector_factory is None:
            first = RetinaFaceDetection(self._cfg_for(base, self.buckets[0]), model, device, registry)

            def detector_factory(size, m):
                det = RetinaFaceDetection(self._cfg_for(base, size), m, first.device)
                det._registry = first._registry
                return det

        else:
            first = detector_factory(self.buckets[0], model)
        self.detectors = {self.buckets[0]: first}
        for bucket in self.buckets[1:]:
            self.detectors[bucket] = detector_factory(bucket, first.model)

    @staticmethod
    def _cfg_for(base: FaceDetectionConfig, bucket: Tuple[int, int]) -> FaceDetectionConfig:
        return dataclasses.replace(base, image_size=bucket)

    def pick_bucket(self, height: int, width: int) -> Tuple[int, int]:
        """Smallest bucket that fully contains the (letterboxed) image."""
        for bucket in self.buckets:
            bw, bh = bucket
            if width <= bw and height <= bh:
                return bucket
        return self.buckets[-1]

    def __call__(self, image_bgr: np.ndarray):
        h, w = image_bgr.shape[:2]
        return self.detectors[self.pick_bucket(h, w)](image_bgr)
