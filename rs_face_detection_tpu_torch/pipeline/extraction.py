"""ArcFace embedding extraction (the ``face_identification`` model), alone.

Counterpart of rs_face_detection_tpu/pipeline/extraction.py::FaceExtraction:
aligned BGR crops -> resize to 112 (half-pixel bilinear) -> BGR->RGB ->
(px - 127.5) * 0.0078125 -> IResNet -> L2-normalized rows, one batched pass
on the device.

``quantized=True`` is the weight-only int8 serving mode: the network is
quantized once at construction (models/quantized.py, quantize_tree's rule)
and its weights stay int8 on the device.  Convolutions dequantize per call;
the ``fc`` runs K3, the int8 dequant-matmul, once per call on the card.
"""

from __future__ import annotations

import copy
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..configs import FaceIdentificationConfig
from ..models.quantized import is_quantized, quantize_module
from ..models.registry import ModelRegistry, from_registry, record
from ..ops.image import crops_to_nchw
from ..utils.device import DeviceLike, resolve_device

#: ArcFace input: (px - 127.5) * 0.0078125.
EMBED_MEAN = (127.5, 127.5, 127.5)
EMBED_SCALE = (0.0078125, 0.0078125, 0.0078125)


def l2_normalize(emb: torch.Tensor) -> torch.Tensor:
    """Rows divided by their norm, floored at 1e-12."""
    return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True), min=1e-12)


class FaceExtraction:
    def __init__(
        self,
        cfg: Optional[FaceIdentificationConfig] = None,
        model: Optional[nn.Module] = None,
        device: DeviceLike = "cuda",
        quantized: bool = False,
        registry: Optional[ModelRegistry] = None,
    ) -> None:
        """``model``: an IResNet (float, or already int8); else the
        registry's ``cfg.model_name`` (models/registry.py::from_registry),
        whose statistics then count the calls.  With ``quantized`` a float
        model is quantized on a copy."""
        self.cfg = cfg or FaceIdentificationConfig()
        self.device = resolve_device(device)
        model, self._registry = from_registry(model, registry, self.cfg.model_name, self.device, identification=self.cfg)
        if quantized and not is_quantized(model):
            model = copy.deepcopy(model)
        if quantized and not is_quantized(model):
            quantize_module(model)
        self.quantized = quantized
        self.model = model.to(self.device).eval()

    def __call__(self, imgs_bgr: Sequence[np.ndarray]) -> np.ndarray:
        """Embed same-shaped BGR crops -> (N, embedding_dim) float32 with
        L2-normalized rows."""
        if len(imgs_bgr) == 0:
            return np.zeros((0, self.cfg.embedding_dim), np.float32)
        start = time.perf_counter()
        x = crops_to_nchw(imgs_bgr, self.cfg.image_size, EMBED_MEAN, EMBED_SCALE, self.device)
        with torch.no_grad():
            out = l2_normalize(self.model(x)).cpu().numpy()
        record(self._registry, self.cfg.model_name, len(imgs_bgr), start)
        return out
