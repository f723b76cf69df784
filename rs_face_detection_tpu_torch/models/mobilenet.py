"""MobileNetV1-0.25 backbone for RetinaFace (biubug6 ``body.stage*`` layout).

Counterpart of rs_face_detection_tpu/models/mobilenet.py (natural 3x3/s2
stem, leaky slope 0.1).  Emits C3 (stride 8, 64 ch), C4 (stride 16, 128 ch)
and C5 (stride 32, 256 ch), NCHW.  ``remat`` recomputes each depthwise-
separable block on the backward pass, as the flax model's ``remat`` does.
"""

from __future__ import annotations

import torch.nn as nn

from .layers import conv_bn, conv_dw, remat

NEGATIVE_SLOPE = 0.1


class MobileNetV1_025(nn.Module):
    def __init__(self, remat: bool = False) -> None:
        super().__init__()
        self.remat = remat
        s = NEGATIVE_SLOPE
        self.stage1 = nn.Sequential(
            conv_bn(3, 8, 3, 2, negative_slope=s),
            conv_dw(8, 16, 1, s),
            conv_dw(16, 32, 2, s),
            conv_dw(32, 32, 1, s),
            conv_dw(32, 64, 2, s),
            conv_dw(64, 64, 1, s),
        )
        self.stage2 = nn.Sequential(
            conv_dw(64, 128, 2, s), *[conv_dw(128, 128, 1, s) for _ in range(5)]
        )
        self.stage3 = nn.Sequential(conv_dw(128, 256, 2, s), conv_dw(256, 256, 1, s))

    def _stage(self, stage: nn.Sequential, x):
        for block in stage:
            x = remat(block, x) if self.remat and block is not self.stage1[0] else block(x)
        return x

    def forward(self, x):
        c3 = self._stage(self.stage1, x)
        c4 = self._stage(self.stage2, c3)
        return [c3, c4, self._stage(self.stage3, c4)]
