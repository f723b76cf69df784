"""Scalar face-quality assessment (the ``face_quality_assetment`` model).

Counterpart of rs_face_detection_tpu/pipeline/quality_assessment.py: BGR
crops -> resize to 112 -> BGR->RGB -> (px - 127.5) * 0.00784313725 -> a
ResNet-18 with one output and no softmax, one batched pass on the device; a
score above the threshold (55.0 on the 0-100 scale) passes.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..configs import FaceQualityAssessmentConfig
from ..models.registry import ModelRegistry, from_registry, record
from ..ops.image import crops_to_nchw
from ..utils.device import DeviceLike, resolve_device

FQA_MEAN = (127.5, 127.5, 127.5)
FQA_SCALE = (0.00784313725, 0.00784313725, 0.00784313725)


class FaceQualityAssessment:
    def __init__(
        self,
        cfg: Optional[FaceQualityAssessmentConfig] = None,
        model: Optional[nn.Module] = None,
        device: DeviceLike = "cuda",
        registry: Optional[ModelRegistry] = None,
    ) -> None:
        """``model``: a one-output ResNet-18 without softmax; else the
        registry's ``cfg.model_name`` (models/registry.py::from_registry),
        whose statistics then count the calls."""
        self.cfg = cfg or FaceQualityAssessmentConfig()
        self.device = resolve_device(device)
        model, self._registry = from_registry(model, registry, self.cfg.model_name, self.device, quality_assessment=self.cfg)
        self.model = model.to(self.device).eval()

    def __call__(self, imgs_bgr: Sequence[np.ndarray]) -> Tuple[List[float], List[int]]:
        """Score same-shaped crops; returns (scores, pass flags (score > threshold))."""
        if len(imgs_bgr) == 0:
            return [], []
        start = time.perf_counter()
        x = crops_to_nchw(imgs_bgr, self.cfg.image_size, FQA_MEAN, FQA_SCALE, self.device)
        with torch.no_grad():
            scores = [float(s) for s in self.model(x).reshape(-1).cpu()]
        record(self._registry, self.cfg.model_name, len(imgs_bgr), start)
        return scores, [1 if s > self.cfg.threshold else 0 for s in scores]
