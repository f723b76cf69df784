"""SCRFD-style detector of the eKYC pipeline, in NCHW.

Counterpart of rs_face_detection_tpu/models/scrfd.py (``SCRFD``,
``_ResBlock``, ``_PAFPN``, ``_SharedHead``) at its natural layout: the
s4d front and the packed head there are TPU layout rewrites of the same
math, which the port leaves behind.  A compact residual backbone to strides
8/16/32, a PAFPN neck (top-down, then bottom-up path aggregation) and a head
shared across levels: two 3x3 convs with GroupNorm (16 groups, epsilon
1e-6, flax's default) and ReLU, then 1x1 convs for the score, the distance
box and the landmarks.

Output per stride s in (8, 16, 32), channels last as in the JAX package:
``{"score": (B, H, W, A) sigmoid, "bbox": (B, H, W, A*4),
"kps": (B, H, W, A*10)}`` with A anchors per cell centered at (x*s, y*s).
Module names follow the flax ones (``stem1``, ``s3a.c1``, ``neck.td0``,
``head.gn0``), so the bridge (models/weights.py::scrfd_map) is a renaming.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import conv_bn, upsample_nearest_2x

#: flax nn.GroupNorm's default epsilon (torch's is 1e-5).
GN_EPS = 1e-6
GN_GROUPS = 16


class _ResBlock(nn.Module):
    def __init__(self, inp: int, features: int, stride: int = 1) -> None:
        super().__init__()
        self.c1 = conv_bn(inp, features, 3, stride)
        self.c2 = conv_bn(features, features, 3, 1, negative_slope=None)
        self.proj = (
            conv_bn(inp, features, 1, stride, negative_slope=None)
            if stride != 1 or inp != features
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.c2(self.c1(x))
        shortcut = x if self.proj is None else self.proj(x)
        return F.relu(shortcut + y)


class _PAFPN(nn.Module):
    """FPN top-down + bottom-up path aggregation, all levels -> out_channels."""

    def __init__(self, in_channels, out_channels: int) -> None:
        super().__init__()
        n = len(in_channels)
        for i, c in enumerate(in_channels):
            setattr(self, f"lat{i}", conv_bn(c, out_channels, 1))
        for i in range(n - 1):
            setattr(self, f"td{i}", conv_bn(out_channels, out_channels, 3))
        for i in range(1, n):
            setattr(self, f"bu{i}", conv_bn(out_channels, out_channels, 3, 2))
        self.levels = n

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [getattr(self, f"lat{i}")(f) for i, f in enumerate(feats)]
        td = [laterals[-1]]
        for i in range(self.levels - 2, -1, -1):
            up = upsample_nearest_2x(td[0], laterals[i].shape[2:])
            td.insert(0, getattr(self, f"td{i}")(laterals[i] + up))
        outs = [td[0]]
        for i in range(1, self.levels):
            down = getattr(self, f"bu{i}")(outs[-1])
            down = down[:, :, : td[i].shape[2], : td[i].shape[3]]
            outs.append(F.relu(td[i] + down))
        return outs


class _SharedHead(nn.Module):
    """Conv tower + score/bbox/kps 1x1 convs, shared across levels."""

    def __init__(self, channels: int, num_anchors: int) -> None:
        super().__init__()
        for i in range(2):
            setattr(self, f"tower{i}", nn.Conv2d(channels, channels, 3, 1, 1, bias=False))
            setattr(self, f"gn{i}", nn.GroupNorm(GN_GROUPS, channels, eps=GN_EPS))
        a = num_anchors
        self.cls = nn.Conv2d(channels, a, 1)
        self.bbox = nn.Conv2d(channels, a * 4, 1)
        self.kps = nn.Conv2d(channels, a * 10, 1)

    def forward(self, x: torch.Tensor):
        for i in range(2):
            x = F.relu(getattr(self, f"gn{i}")(getattr(self, f"tower{i}")(x)))
        return self.cls(x), self.bbox(x), self.kps(x)


class SCRFD(nn.Module):
    """Compact SCRFD-style detector emitting per-stride maps."""

    #: Anchors per cell (the JAX package's decode assumes 2).
    num_anchors = 2

    def __init__(self, width: int = 32, neck_channels: int = 32) -> None:
        super().__init__()
        w = width
        self.stem1 = conv_bn(3, w, 3, 2)
        self.stem2 = conv_bn(w, w, 3, 2)
        self.s3a = _ResBlock(w, w * 2, 2)
        self.s3b = _ResBlock(w * 2, w * 2)
        self.s4a = _ResBlock(w * 2, w * 4, 2)
        self.s4b = _ResBlock(w * 4, w * 4)
        self.s5a = _ResBlock(w * 4, w * 8, 2)
        self.s5b = _ResBlock(w * 8, w * 8)
        self.neck = _PAFPN((w * 2, w * 4, w * 8), neck_channels)
        self.head = _SharedHead(neck_channels, self.num_anchors)

    def forward(self, x: torch.Tensor) -> Dict[int, Dict[str, torch.Tensor]]:
        """(B, 3, H, W) normalized RGB -> per-stride channels-last maps."""
        x = self.stem2(self.stem1(x))
        c3 = self.s3b(self.s3a(x))
        c4 = self.s4b(self.s4a(c3))
        c5 = self.s5b(self.s5a(c4))
        out: Dict[int, Dict[str, torch.Tensor]] = {}
        for stride, feat in zip((8, 16, 32), self.neck([c3, c4, c5])):
            score, bbox, kps = self.head(feat)
            out[stride] = {
                "score": torch.sigmoid(score).permute(0, 2, 3, 1),
                "bbox": bbox.permute(0, 2, 3, 1),
                "kps": kps.permute(0, 2, 3, 1),
            }
        return out
