"""Loaders for the committed trained-weight fixtures.

Counterpart of rs_face_detection_tpu/utils/fixtures.py.  The fixture
checkpoints under tests/fixtures/ (``trained_mnet64.npz``,
``trained_real64.npz``, ``trained_real640.npz``) are the JAX package's
registry files, some stored in float16; they reach the port through the
weight bridge of models/weights.py.  ``load_ap_eval_set`` reads the labeled
eval set and the AP recorded when the fixture was frozen.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..configs import FaceDetectionConfig
from ..models import weights
from ..utils.device import DeviceLike, resolve_device


def load_trained_detector(
    ckpt_path: str, cfg: Optional[FaceDetectionConfig] = None, device: DeviceLike = "cuda"
):
    """The port's RetinaFaceDetection on a fixture checkpoint (float16
    leaves widen to float32), with ``cfg`` or the JAX loader's default: 64
    px, scores >= 0.3, 64 candidates, 8 rows."""
    from ..pipeline.detection import RetinaFaceDetection

    device = resolve_device(device)  # raises before the weights load when CUDA is absent
    cfg = cfg or FaceDetectionConfig(
        image_size=(64, 64),
        confidence_threshold=0.3,
        max_candidates=64,
        max_detections=8,
    )
    family = f"retinaface_{cfg.backbone}"
    model = weights.load_model(family, weights.state_dict_from_jax(family, ckpt_path))
    return RetinaFaceDetection(cfg, model, device=device)


def load_ap_eval_set(path: str):
    """[(img_u8, gt_boxes)] + recorded metrics from ap_eval_set.npz."""
    with np.load(path) as data:
        imgs = data["images"]
        padded = data["gt_boxes"]
        counts = data["gt_counts"]
        recorded = {
            "ap": float(data["recorded_ap"]),
            "recall": float(data["recorded_recall"]),
        }
    dataset = [
        (imgs[i], padded[i, : counts[i]].copy()) for i in range(len(imgs))
    ]
    return dataset, recorded
