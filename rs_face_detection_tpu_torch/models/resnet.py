"""ResNet-50 trunk of RetinaFace-R50, with the JAX package's s2d stem.

Counterpart of rs_face_detection_tpu/models/resnet.py (default
``stem_space_to_depth=True``) in NCHW, with torchvision key names (``conv1``,
``bn1``, ``layer1..4.{i}.conv1..3 / bn1..3 / downsample.{0,1}``), which are
the names of biubug6's ``Resnet50_Final.pth`` under ``body.``.

The stem is a 4x4/s1 conv on the 2x2 space-to-depth layout (12 channels)
with block-space pad (2, 1): the JAX model is initialised in that form, and
a kernel initialised there has no 7x7 form to map back to.  A 7x7/s2 kernel
maps into it exactly (``stem_to_s2d``).  Strided convs and
the max-pool use torch's symmetric padding, as the flax model does.

Two entry points: ``forward(x)`` on normalized RGB (B, 3, H, W) float, and
``from_pooled(p)`` on the pooled stem output (B, 64, H/4, W/4), which the
fused stem kernel (ops/stem.py) computes from uint8 frames -- the
counterpart of the flax model's ``stem_precomputed=True``.  Both return
(C3, C4, C5) with (512, 1024, 2048) channels.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BN_EPS, BatchNorm2d, remat

#: Bottleneck blocks per stage.
STAGES = (3, 4, 6, 3)


def stem_to_s2d(kernel_hwio: np.ndarray) -> np.ndarray:
    """Exactly convert a (K, K)/stride-2 stem kernel (K odd, symmetric pad
    K//2) to the (KK, KK, 4C, F) kernel of a stride-1 conv on the 2x2
    space-to-depth input, channel (bi*2 + bj)*C + c, padded by
    ``s2d_stem_padding(K)``.

    Output o reads input i = 2o - p + k, which is block floor((k - p)/2) + o
    at phase (k - p) mod 2.  A numpy copy of rs_face_detection_tpu/models/
    import_weights.py::stem_to_s2d (that module's package loads JAX);
    tests/test_torch_resnet.py holds the two equal.
    """
    kh, kw, c, f = kernel_hwio.shape
    if kh != kw or kh % 2 == 0:
        raise ValueError(f"stem kernel must be square with an odd size, got {kernel_hwio.shape}")
    p = kh // 2
    offs = [(u - p) // 2 for u in range(kh)]
    m_min = min(offs)
    kk = max(offs) - m_min + 1
    out = np.zeros((kk, kk, 4 * c, f), dtype=kernel_hwio.dtype)
    for u in range(kh):
        a, bi = (u - p) // 2 - m_min, (u - p) % 2
        for v in range(kw):
            b, bj = (v - p) // 2 - m_min, (v - p) % 2
            out[a, b, (bi * 2 + bj) * c : (bi * 2 + bj + 1) * c] = kernel_hwio[u, v]
    return out


def s2d_stem_padding(k: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Block-space padding of the s2d form of an odd-K, pad-K//2, stride-2
    stem: ((2, 1), (2, 1)) for K = 7.  A numpy copy of
    import_weights.py::s2d_stem_padding."""
    if k % 2 == 0:
        raise ValueError(f"stem kernel size must be odd, got {k}")
    p = k // 2
    offs = [(u - p) // 2 for u in range(k)]
    lo = -min(offs)
    hi = max(offs) - min(offs) - lo
    return ((lo, hi), (lo, hi))


#: Stem block-space conv padding (top/left, bottom/right): that of the s2d
#: form of torchvision's 7x7/s2 pad-3 stem, (2, 1).
STEM_PAD = s2d_stem_padding(7)[0]


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1, 3x3 (stride here), 1x1 x4, residual."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=BN_EPS)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes, eps=BN_EPS)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4, eps=BN_EPS)
        self.downsample = None
        if stride != 1 or inplanes != planes * 4:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                BatchNorm2d(planes * 4, eps=BN_EPS),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


def space_to_depth_nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2), channel (bi*2 + bj)*C + c."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)


class ResNet50(nn.Module):
    def __init__(self, remat: bool = False) -> None:
        super().__init__()
        self.remat = remat
        self.conv1 = nn.Conv2d(12, 64, 4, 1, 0, bias=False)
        self.bn1 = BatchNorm2d(64, eps=BN_EPS)
        inplanes = 64
        for i, (blocks, planes) in enumerate(zip(STAGES, (64, 128, 256, 512))):
            layer = []
            for j in range(blocks):
                layer.append(Bottleneck(inplanes, planes, 2 if j == 0 and i > 0 else 1))
                inplanes = planes * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """Normalized RGB (B, 3, H, W) -> pooled (B, 64, ceil(H/4), ceil(W/4)).

        Odd H or W get a high-side zero row or column first, which falls
        inside the conv's own bottom/right pad, as in the flax model.
        """
        h, w = x.shape[2], x.shape[3]
        if h % 2 or w % 2:
            x = F.pad(x, (0, w % 2, 0, h % 2))
        lo, hi = STEM_PAD
        x = self.conv1(F.pad(space_to_depth_nchw(x), (lo, hi, lo, hi)))
        return F.max_pool2d(F.relu(self.bn1(x)), 3, 2, 1)

    def from_pooled(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Stages 1-4 from the pooled stem output: (C3, C4, C5).  ``remat``
        recomputes each bottleneck on the backward pass (the flax model's)."""
        x = self._stage(self.layer1, x)
        c3 = self._stage(self.layer2, x)
        c4 = self._stage(self.layer3, c3)
        return c3, c4, self._stage(self.layer4, c4)

    def _stage(self, layer: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        for block in layer:
            x = remat(block, x) if self.remat else block(x)
        return x

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.from_pooled(self.stem(x))
