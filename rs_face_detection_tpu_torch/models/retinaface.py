"""RetinaFace detector network: backbone + FPN + SSH + multi-task heads.

Counterpart of rs_face_detection_tpu/models/retinaface.py for the
MobileNet-0.25 and ResNet-50 backbones, in the biubug6 key layout
(``body``, ``fpn``, ``ssh1..3``, ``ClassHead/BboxHead/LandmarkHead.{i}.conv1x1``).
Input (B, 3, H, W) normalized RGB; for the ResNet-50, whose stem runs on the
2x2 space-to-depth layout, ``forward_pooled`` starts instead from the pooled
stem output that the fused stem kernel computes from uint8 frames.  A model
passed through ops/quantize.py::quantize_retinaface runs its ConvBN convs
on int8 activations (``quant``), the ResNet-50's s2d stem included.  The output is the JAX model's contract: {stride:
{"score": (B, H, W, A), "bbox": (B, H, W, A*4), "landmark": (B, H, W, A*10)}}
for strides 8, 16, 32.  Each head's NCHW output is permuted to NHWC before
any reshape, so rows flatten in (h, w, a) order, the anchor table's order.
For training (parallel/train.py), ``forward(x, raw=True)`` gives the raw
(B, H, W, A, 2) class logits as "score", without the softmax, and
``remat=True`` recomputes the backbone's blocks on the backward pass: the
flax model's ``raw`` and ``remat``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from .layers import FPN, SSH
from .mobilenet import NEGATIVE_SLOPE, MobileNetV1_025
from .quantized import has_int8_activations
from .resnet import ResNet50

#: per-backbone (backbone channels C3..C5, fpn/ssh channels, leaky slope)
_BACKBONES = {
    "mobilenet025": ((64, 128, 256), 64, NEGATIVE_SLOPE),
    "resnet50": ((512, 1024, 2048), 256, 0.0),
}


class _Head(nn.Module):
    """One 1x1 conv with bias (biubug6 ClassHead/BboxHead/LandmarkHead)."""

    def __init__(self, in_channels: int, out_channels: int) -> None:
        super().__init__()
        self.conv1x1 = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv1x1(x).permute(0, 2, 3, 1)  # NHWC


class RetinaFace(nn.Module):
    def __init__(self, backbone: str = "mobilenet025", num_anchors: int = 2, remat: bool = False) -> None:
        super().__init__()
        if backbone not in _BACKBONES:
            raise ValueError(
                f"unknown backbone {backbone!r} (this port has {sorted(_BACKBONES)})"
            )
        in_channels, channels, slope = _BACKBONES[backbone]
        self.backbone = backbone
        self.num_anchors = num_anchors
        self.body = ResNet50(remat) if backbone == "resnet50" else MobileNetV1_025(remat)
        self.fpn = FPN(in_channels, channels, slope)
        self.ssh1 = SSH(channels, channels, slope)
        self.ssh2 = SSH(channels, channels, slope)
        self.ssh3 = SSH(channels, channels, slope)
        a = num_anchors
        self.ClassHead = nn.ModuleList([_Head(channels, a * 2) for _ in range(3)])
        self.BboxHead = nn.ModuleList([_Head(channels, a * 4) for _ in range(3)])
        self.LandmarkHead = nn.ModuleList([_Head(channels, a * 10) for _ in range(3)])

    def uses_s2d_stem(self) -> bool:
        """Whether the backbone's stem runs on the 2x2 space-to-depth layout
        (the ResNet-50), so that ``forward_pooled`` and the fused stem apply."""
        return self.backbone == "resnet50"

    @property
    def quant(self) -> bool:
        """Whether the convs run int8 activations (ops/quantize.py::
        quantize_retinaface): the flax model's ``quant``."""
        return has_int8_activations(self)

    def forward(self, x: torch.Tensor, raw: bool = False) -> Dict[int, Dict[str, torch.Tensor]]:
        return self._neck_and_heads(self.body(x), raw)

    def forward_pooled(self, pooled: torch.Tensor) -> Dict[int, Dict[str, torch.Tensor]]:
        """The network from the pooled (B, 64, H/4, W/4) stem output of the
        s2d backbone: the flax model's ``stem_precomputed=True``."""
        if not self.uses_s2d_stem():
            raise ValueError(f"backbone {self.backbone!r} has no s2d stem to start after")
        return self._neck_and_heads(self.body.from_pooled(pooled))

    def _neck_and_heads(self, feats, raw: bool = False) -> Dict[int, Dict[str, torch.Tensor]]:
        pyramid = self.fpn(feats)
        contexts = [ssh(p) for ssh, p in zip((self.ssh1, self.ssh2, self.ssh3), pyramid)]
        out: Dict[int, Dict[str, torch.Tensor]] = {}
        for i, (stride, feat) in enumerate(zip((8, 16, 32), contexts)):
            logits = self.ClassHead[i](feat)
            b, h, w, _ = logits.shape
            logits = logits.reshape(b, h, w, self.num_anchors, 2)
            out[stride] = {
                "score": logits if raw else torch.softmax(logits, dim=-1)[..., 1],
                "bbox": self.BboxHead[i](feat),
                "landmark": self.LandmarkHead[i](feat),
            }
        return out
