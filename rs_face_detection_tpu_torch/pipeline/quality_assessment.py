"""Scalar face-quality assessment (the ``face_quality_assetment`` model).

Counterpart of rs_face_detection_tpu/pipeline/quality_assessment.py: BGR
crops -> resize to 112 -> BGR->RGB -> (px - 127.5) * 0.00784313725 -> a
ResNet-18 with one output and no softmax, one batched pass on the device; a
score above the threshold (55.0 on the 0-100 scale) passes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..configs import FaceQualityAssessmentConfig
from ..models.weights import init_state, load_model
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
    ) -> None:
        """``model``: a one-output ResNet-18 without softmax; None builds one
        on seeded (seed 0) full-width weights."""
        self.cfg = cfg or FaceQualityAssessmentConfig()
        self.device = resolve_device(device)
        if model is None:
            family = "resnet18_classifier"
            model = load_model(family, init_state(family, 0, 1), softmax=False)
        self.model = model.to(self.device).eval()

    def __call__(self, imgs_bgr: Sequence[np.ndarray]) -> Tuple[List[float], List[int]]:
        """Score same-shaped crops; returns (scores, pass flags (score > threshold))."""
        if len(imgs_bgr) == 0:
            return [], []
        x = crops_to_nchw(imgs_bgr, self.cfg.image_size, FQA_MEAN, FQA_SCALE, self.device)
        with torch.no_grad():
            scores = [float(s) for s in self.model(x).reshape(-1).cpu()]
        return scores, [1 if s > self.cfg.threshold else 0 for s in scores]
