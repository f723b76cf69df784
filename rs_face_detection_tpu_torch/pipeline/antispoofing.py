"""MiniFAS multi-scale anti-spoofing ensemble.

Counterpart of rs_face_detection_tpu/pipeline/antispoofing.py: four
MiniFASNets at scales (4.0, 2.7, 2.0, 1.0) and input sizes 80/80/256/128
vote on scale-clamped square crops around each detection.  Kept as they are:

  - the crop geometry (``detection_to_crop_box``, ``get_new_box``, copied
    with their int truncations), on the host;
  - raw 0-255 pixels in BGR order;
  - each face's class-1 probabilities averaged with the clamp weights
    (``clamped_scale / requested_scale``) in float64; live if above the
    threshold (0.55).

Per scale, one batched crop + resize over the faces and one forward run on
the device.  JAX pads the face count to a power of two for its jit shapes;
PyTorch needs no static shape, and the rows come out the same.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..configs import FaceAntiSpoofingConfig
from ..models.registry import ModelRegistry, registry_on
from ..ops.image import crop_resize_batch
from ..utils.device import DeviceLike, resolve_device


def get_new_box(
    src_w: int, src_h: int, box_xywh: Tuple[float, float, float, float], scale: float
) -> Tuple[int, int, int, int, float]:
    """Scale-clamped square crop: integer (left, top, right, bottom)
    inclusive corners plus the weight = achieved_scale / requested_scale."""
    x, y, box_w, box_h = box_xywh
    eff = min((src_h - 1.0) / box_h, (src_w - 1.0) / box_w, scale)

    new_w = box_w * eff
    new_h = box_h * eff
    cx, cy = box_w / 2.0 + x, box_h / 2.0 + y

    ltx = cx - new_w / 2.0
    lty = cy - new_h / 2.0
    rbx = cx + new_w / 2.0
    rby = cy + new_h / 2.0

    if ltx < 0:
        rbx -= ltx
        ltx = 0.0
    if lty < 0:
        rby -= lty
        lty = 0.0
    if rbx > src_w - 1.0:
        ltx -= rbx - src_w + 1.0
        rbx = src_w - 1.0
    if rby > src_h - 1.0:
        lty -= rby - src_h + 1.0
        rby = src_h - 1.0

    return int(ltx), int(lty), int(rbx), int(rby), eff / scale


def detection_to_crop_box(face_box: np.ndarray) -> Tuple[float, float, float, float]:
    """Detection -> pre-crop square bbox (x, y, w, h): c_x +/- 0.47 * det
    height, the detection's y range, every component truncated to an int."""
    x1, y1, x2, y2 = (float(face_box[i]) for i in range(4))
    det_h = y2 - y1
    cx = (x1 + x2) / 2.0
    left = float(int(cx - 0.47 * det_h))
    right = float(int(cx + 0.47 * det_h))
    return left, float(int(y1)), float(int(right - left + 1.0)), float(int(y2 - y1 + 1.0))


class FaceAntiSpoofing:
    def __init__(
        self,
        cfg: Optional[FaceAntiSpoofingConfig] = None,
        models: Optional[Sequence[nn.Module]] = None,
        device: DeviceLike = "cuda",
        registry: Optional[ModelRegistry] = None,
    ) -> None:
        """``models``: one MiniFASNet per scale, in the config's order; else
        the config's ``model_names`` from ``registry`` or the default one
        (models/registry.py::registry_on; the JAX module records no
        statistics, and neither does this one)."""
        self.cfg = cfg or FaceAntiSpoofingConfig()
        self.device = resolve_device(device)
        if models is None:
            registry = registry_on(registry, self.device, antispoofing=self.cfg)
            models = [registry.get(name) for name in self.cfg.model_names]
        elif registry is not None:
            raise ValueError("pass models or a registry, not both")
        models = list(models)
        if len(models) != len(self.cfg.scales):
            raise ValueError(f"{len(models)} models for {len(self.cfg.scales)} scales")
        self.models = [m.to(self.device).eval() for m in models]

    def __call__(
        self, imgs_bgr: Sequence[np.ndarray], face_boxes: Sequence[np.ndarray]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Liveness for (image, detection) pairs of one image shape.

        Returns (liveness (N,) int32 0/1, live_scores (N,) float32).
        """
        n = len(imgs_bgr)
        if n == 0:
            return np.zeros((0,), np.int32), np.zeros((0,), np.float32)
        if len(face_boxes) != n:
            raise ValueError(f"{len(face_boxes)} boxes for {n} images")
        src_h, src_w = imgs_bgr[0].shape[:2]

        crop_boxes = np.zeros((len(self.cfg.scales), n, 4), np.float32)
        weights = np.zeros((len(self.cfg.scales), n), np.float32)
        for i, face_box in enumerate(face_boxes):
            xywh = detection_to_crop_box(np.asarray(face_box))
            for s, scale in enumerate(self.cfg.scales):
                l, t, r, b, w = get_new_box(src_w, src_h, xywh, scale)
                crop_boxes[s, i] = (l, t, r, b)
                weights[s, i] = w

        stack = torch.from_numpy(np.stack(imgs_bgr)).to(self.device).float()
        pending = []
        with torch.no_grad():
            for s, model in enumerate(self.models):
                out_w, out_h = self.cfg.image_sizes[s]
                boxes = torch.from_numpy(crop_boxes[s]).to(self.device)
                crops = crop_resize_batch(stack, boxes, out_h, out_w)  # raw 0-255 BGR
                pending.append(model(crops.permute(0, 3, 1, 2).contiguous()))
        weighted = np.zeros((n,), np.float64)
        total_w = np.zeros((n,), np.float64)
        for s, probs_dev in enumerate(pending):
            probs = probs_dev.cpu().numpy()
            weighted += probs[:, 1] * weights[s]
            total_w += weights[s]

        live_score = (weighted / np.maximum(total_w, 1e-12)).astype(np.float32)
        liveness = (live_score > self.cfg.threshold).astype(np.int32)
        return liveness, live_score
