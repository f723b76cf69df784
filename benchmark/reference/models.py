"""Plain PyTorch networks of the face-ID pipeline, in their published layouts.

The benchmark's reference: written from the published architectures, not
from the program under test, and importing nothing of it.

- ``RetinaFace``: biubug6/Pytorch_Retinaface ``models/retinaface.py`` with
  the ``cfg_mnet`` (MobileNetV1-0.25, FPN/SSH width 64, leaky ReLU 0.1) or
  ``cfg_re50`` (torchvision ResNet-50 with its 7x7/s2 stem, width 256, ReLU)
  backbone.  ``forward`` returns per-stride raw class logits, box deltas and
  landmark deltas in (h, w, anchor) row order.
- ``ResNet18Classifier``: torchvision ``resnet18`` with a new ``fc`` and a
  softmax (the quality head).
- ``IResNet``: insightface ``recognition/arcface_torch/backbones/iresnet.py``
  (``iresnet50``: layers 3-4-14-3, 512-d), without dropout (inference).

Every BatchNorm has eps 1e-5, as in the sources.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv_bn(inp: int, oup: int, k: int = 3, stride: int = 1, groups: int = 1, slope=None) -> nn.Sequential:
    """Conv (no bias, pad k//2) + BN (+ leaky ReLU when ``slope`` is a number)."""
    layers = [nn.Conv2d(inp, oup, k, stride, k // 2, groups=groups, bias=False), nn.BatchNorm2d(oup)]
    if slope is not None:
        layers.append(nn.LeakyReLU(slope))
    return nn.Sequential(*layers)


def conv_dw(inp: int, oup: int, stride: int, slope: float) -> nn.Sequential:
    """biubug6 ``conv_dw``: depthwise 3x3 + BN + act, pointwise 1x1 + BN + act."""
    return nn.Sequential(*conv_bn(inp, inp, 3, stride, inp, slope), *conv_bn(inp, oup, 1, 1, 1, slope))


class MobileNetV1(nn.Module):
    """biubug6 ``MobileNetV1`` (width 0.25): C3, C4, C5 of 64, 128, 256 channels."""

    def __init__(self) -> None:
        super().__init__()
        s = 0.1
        self.stage1 = nn.Sequential(
            conv_bn(3, 8, 3, 2, 1, s), conv_dw(8, 16, 1, s), conv_dw(16, 32, 2, s),
            conv_dw(32, 32, 1, s), conv_dw(32, 64, 2, s), conv_dw(64, 64, 1, s),
        )
        self.stage2 = nn.Sequential(conv_dw(64, 128, 2, s), *[conv_dw(128, 128, 1, s) for _ in range(5)])
        self.stage3 = nn.Sequential(conv_dw(128, 256, 2, s), conv_dw(256, 256, 1, s))

    def forward(self, x):
        c3 = self.stage1(x)
        c4 = self.stage2(c3)
        return [c3, c4, self.stage3(c4)]


class Bottleneck(nn.Module):
    """torchvision ``Bottleneck`` (stride on the 3x3 conv)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = None
        if stride != 1 or inplanes != planes * 4:
            self.downsample = nn.Sequential(nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                                            nn.BatchNorm2d(planes * 4))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNet50(nn.Module):
    """torchvision ``resnet50`` trunk: C3, C4, C5 of 512, 1024, 2048 channels."""

    def __init__(self) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for i, (blocks, planes) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
            layer = []
            for j in range(blocks):
                layer.append(Bottleneck(inplanes, planes, 2 if j == 0 and i > 0 else 1))
                inplanes = planes * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        x = self.layer1(x)
        c3 = self.layer2(x)
        c4 = self.layer3(c3)
        return [c3, c4, self.layer4(c4)]


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out: int, slope: float) -> None:
        super().__init__()
        self.output1 = conv_bn(in_channels[0], out, 1, slope=slope)
        self.output2 = conv_bn(in_channels[1], out, 1, slope=slope)
        self.output3 = conv_bn(in_channels[2], out, 1, slope=slope)
        self.merge1 = conv_bn(out, out, 3, slope=slope)
        self.merge2 = conv_bn(out, out, 3, slope=slope)

    def forward(self, feats):
        o1, o2, o3 = self.output1(feats[0]), self.output2(feats[1]), self.output3(feats[2])
        o2 = self.merge2(o2 + F.interpolate(o3, size=o2.shape[2:], mode="nearest"))
        o1 = self.merge1(o1 + F.interpolate(o2, size=o1.shape[2:], mode="nearest"))
        return [o1, o2, o3]


class SSH(nn.Module):
    def __init__(self, inp: int, out: int, slope: float) -> None:
        super().__init__()
        self.conv3X3 = conv_bn(inp, out // 2)
        self.conv5X5_1 = conv_bn(inp, out // 4, slope=slope)
        self.conv5X5_2 = conv_bn(out // 4, out // 4)
        self.conv7X7_2 = conv_bn(out // 4, out // 4, slope=slope)
        self.conv7x7_3 = conv_bn(out // 4, out // 4)

    def forward(self, x):
        c5 = self.conv5X5_1(x)
        return F.relu(torch.cat([self.conv3X3(x), self.conv5X5_2(c5), self.conv7x7_3(self.conv7X7_2(c5))], 1))


class _Head(nn.Module):
    def __init__(self, inp: int, out: int) -> None:
        super().__init__()
        self.conv1x1 = nn.Conv2d(inp, out, 1)

    def forward(self, x):
        return self.conv1x1(x).permute(0, 2, 3, 1)


class RetinaFace(nn.Module):
    """biubug6 RetinaFace.  ``forward`` on (B, 3, H, W) float RGB gives
    {stride: (logits (B, h*w*A, 2), box deltas (B, h*w*A, 4), landmark
    deltas (B, h*w*A, 10))} for strides 8, 16, 32."""

    def __init__(self, backbone: str, in_channels: Sequence[int], width: int, num_anchors: int = 2) -> None:
        super().__init__()
        slope = 0.1 if width <= 64 else 0.0
        self.body = MobileNetV1() if backbone == "mobilenet025" else ResNet50()
        self.fpn = FPN(in_channels, width, slope)
        self.ssh1, self.ssh2, self.ssh3 = (SSH(width, width, slope) for _ in range(3))
        a = num_anchors
        self.ClassHead = nn.ModuleList(_Head(width, a * 2) for _ in range(3))
        self.BboxHead = nn.ModuleList(_Head(width, a * 4) for _ in range(3))
        self.LandmarkHead = nn.ModuleList(_Head(width, a * 10) for _ in range(3))

    def forward(self, x) -> Dict[int, tuple]:
        feats = self.fpn(self.body(x))
        out = {}
        for i, (stride, ssh, f) in enumerate(zip((8, 16, 32), (self.ssh1, self.ssh2, self.ssh3), feats)):
            y = ssh(f)
            b = y.shape[0]
            out[stride] = (
                self.ClassHead[i](y).reshape(b, -1, 2),
                self.BboxHead[i](y).reshape(b, -1, 4),
                self.LandmarkHead[i](y).reshape(b, -1, 10),
            )
        return out


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample=None) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNet18Classifier(nn.Module):
    """torchvision ``resnet18`` with ``fc`` to ``num_classes`` and a softmax."""

    def __init__(self, num_classes: int) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for i, planes in enumerate((64, 128, 256, 512)):
            stride = 1 if i == 0 else 2
            down = None
            if stride != 1 or inplanes != planes:
                down = nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride, bias=False), nn.BatchNorm2d(planes))
            setattr(self, f"layer{i + 1}", nn.Sequential(BasicBlock(inplanes, planes, stride, down),
                                                         BasicBlock(planes, planes)))
            inplanes = planes
        self.fc = nn.Linear(512, num_classes)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = torch.flatten(F.adaptive_avg_pool2d(x, 1), 1)
        return torch.softmax(self.fc(x), dim=1)


class IBasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample=None) -> None:
        super().__init__()
        self.bn1 = nn.BatchNorm2d(inplanes)
        self.conv1 = nn.Conv2d(inplanes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.prelu = nn.PReLU(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        y = self.bn3(self.conv2(self.prelu(self.bn2(self.conv1(self.bn1(x))))))
        return y + (x if self.downsample is None else self.downsample(x))


class IResNet(nn.Module):
    """insightface ``IResNet`` on 112x112 RGB: (B, embedding_dim) features."""

    def __init__(self, layers: Sequence[int], embedding_dim: int = 512) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.prelu = nn.PReLU(64)
        inplanes = 64
        for i, (blocks, planes) in enumerate(zip(layers, (64, 128, 256, 512))):
            down = nn.Sequential(nn.Conv2d(inplanes, planes, 1, 2, bias=False), nn.BatchNorm2d(planes))
            blk = [IBasicBlock(inplanes, planes, 2, down)] + [IBasicBlock(planes, planes) for _ in range(1, blocks)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*blk))
            inplanes = planes
        self.bn2 = nn.BatchNorm2d(512)
        self.fc = nn.Linear(512 * 7 * 7, embedding_dim)
        self.features = nn.BatchNorm1d(embedding_dim)

    def forward(self, x):
        x = self.prelu(self.bn1(self.conv1(x)))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.features(self.fc(torch.flatten(self.bn2(x), 1)))


def build(spec: dict) -> nn.Module:
    """The network a configuration's model entry names (``arch`` and widths)."""
    arch = spec["arch"]
    if arch == "retinaface":
        return RetinaFace(spec["backbone"], spec["in_channels"], spec["width"], spec["num_anchors"])
    if arch == "resnet18_classifier":
        return ResNet18Classifier(spec["num_classes"])
    if arch == "iresnet":
        return IResNet(spec["layers"], spec["embedding_dim"])
    raise ValueError(f"unknown arch {arch!r}")
