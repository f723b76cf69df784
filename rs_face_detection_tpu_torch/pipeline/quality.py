"""Face-quality classification (Bad / Good / WearingMask / WearingSunGlasses).

Counterpart of rs_face_detection_tpu/pipeline/quality.py: BGR crops ->
resize to 112 -> BGR->RGB -> ImageNet mean and 1/std -> ResNet-18 -> class
probabilities, one batched pass on the device; then argmax with the
threshold demotion (``demote_quality``), which FacePipeline's tail shares.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..configs import FaceQualityConfig
from ..models.registry import ModelRegistry, from_registry, record
from ..ops.image import crops_to_nchw
from ..utils.device import DeviceLike, resolve_device

#: Quality head input: ImageNet mean and 1/std on 0-255 RGB.
QUALITY_MEAN = (123.675, 116.28, 103.53)
QUALITY_SCALE = (0.01712475, 0.017507, 0.01742919)


def demote_quality(probs: np.ndarray, threshold: float) -> Tuple[int, float]:
    """Argmax class; class 1 (Good) below `threshold` demotes to class 0
    (Bad) and reports class 0's probability."""
    predict = int(np.argmax(probs))
    score = float(probs[predict])
    if predict == 1 and score < threshold:
        predict, score = 0, float(probs[0])
    return predict, score


class FaceQuality:
    def __init__(
        self,
        cfg: Optional[FaceQualityConfig] = None,
        model: Optional[nn.Module] = None,
        device: DeviceLike = "cuda",
        registry: Optional[ModelRegistry] = None,
    ) -> None:
        """``model``: a ResNet-18 classifier; else the registry's
        ``cfg.model_name`` (models/registry.py::from_registry), whose
        statistics then count the calls."""
        self.cfg = cfg or FaceQualityConfig()
        self.device = resolve_device(device)
        model, self._registry = from_registry(model, registry, self.cfg.model_name, self.device, quality=self.cfg)
        self.model = model.to(self.device).eval()

    def probabilities(self, imgs_bgr: Sequence[np.ndarray]) -> np.ndarray:
        """Raw (B, num_classes) class probabilities for same-shaped BGR crops."""
        if len(imgs_bgr) == 0:
            return np.zeros((0, self.cfg.num_classes), np.float32)
        start = time.perf_counter()
        x = crops_to_nchw(imgs_bgr, self.cfg.image_size, QUALITY_MEAN, QUALITY_SCALE, self.device)
        with torch.no_grad():
            out = self.model(x).cpu().numpy()
        record(self._registry, self.cfg.model_name, len(imgs_bgr), start)
        return out

    def __call__(self, imgs_bgr: Sequence[np.ndarray]) -> Tuple[List[float], List[int]]:
        """Classify crops; returns (scores, class indices) per image."""
        scores: List[float] = []
        classes: List[int] = []
        for row in self.probabilities(imgs_bgr):
            predict, score = demote_quality(row, self.cfg.threshold)
            classes.append(predict)
            scores.append(score)
        return scores, classes
