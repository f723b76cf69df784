"""MiniFASNet, the anti-spoofing ensemble's network (Silent-Face key layout).

Counterpart of rs_face_detection_tpu/models/minifas.py in NCHW, driven by the
same spec (``DWSpec``, ``MiniFASNetSpec``, ``default_minifas_spec``,
``conv6_kernel_for`` and ``minifasnet_spec_from_state_dict`` are copies), with
Silent-Face's state_dict keys, so a public MiniFASNet V1/V2/V1SE/V2SE
checkpoint loads as it is:

  conv1 (3x3/s2) -> conv2_dw (3x3 grouped) ->
  [Depth_Wise s2 -> Residual xN] x3 (``conv_23``, ``conv_3.model.i``, ...) ->
  conv_6_sep (1x1) -> conv_6_dw (grouped, VALID, the stride-16 map -> 1x1) ->
  flatten -> linear (no bias) -> BatchNorm1d -> prob (no bias) -> softmax.

Conv blocks are conv (no bias) + BN + per-channel PReLU, linear blocks conv
+ BN; squeeze-excite is GAP -> 1x1 -> BN -> ReLU -> 1x1 -> BN -> sigmoid.
Every BatchNorm keeps flax's epsilon of 1e-5.  Input: (B, 3, H, W) raw 0-255
pixels in BGR order (the reference's double channel reversal nets out).
``minifasnet_map`` (the JAX package's import map, copied) is what the weight
bridge (models/weights.py) turns round.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from .checkpoint_maps import strip_module_prefix
from .layers import BN_EPS


@dataclasses.dataclass(frozen=True)
class DWSpec:
    """One Depth_Wise bottleneck: 1x1 -> grouped kxk -> 1x1 project."""

    mid1: int
    mid2: int
    out: int
    groups: int
    kernel: Tuple[int, int] = (3, 3)
    stride: int = 1
    residual: bool = False
    se_reduct: int = 0  # reduced channel count; 0 = no squeeze-excite


@dataclasses.dataclass(frozen=True)
class MiniFASNetSpec:
    conv1_out: int
    conv2_out: int
    conv2_groups: int
    conv_23: DWSpec
    conv_3: Tuple[DWSpec, ...]
    conv_34: DWSpec
    conv_4: Tuple[DWSpec, ...]
    conv_45: DWSpec
    conv_5: Tuple[DWSpec, ...]
    conv6_sep_out: int
    conv6_out: int
    conv6_groups: int
    conv6_kernel: Tuple[int, int]
    embedding_size: int = 128
    num_classes: int = 3


def conv6_kernel_for(input_hw: Tuple[int, int]) -> Tuple[int, int]:
    """Silent-Face get_kernel: the stride-16 feature map size, so the grouped
    'Linear_block' collapses spatial dims to 1x1."""
    h, w = input_hw
    return ((h + 15) // 16, (w + 15) // 16)


def default_minifas_spec(
    input_hw: Tuple[int, int] = (80, 80),
    embedding_size: int = 128,
    num_classes: int = 3,
    se: bool = False,
) -> MiniFASNetSpec:
    """A representative MiniFASNet-shaped spec for checkpoint-less serving
    (the family's published proportions: stride-4 stage 64 channels,
    stride-8/16 128, a 512 head)."""

    def dw(mid, out, stride, residual=False, se_reduct=0):
        return DWSpec(mid, mid, out, groups=mid, kernel=(3, 3), stride=stride,
                      residual=residual, se_reduct=se_reduct)

    def res(mid, out, n, se_last=False):
        blocks = []
        for i in range(n):
            reduct = (out // 4) if (se_last and i == n - 1) else 0
            blocks.append(dw(mid, out, 1, residual=True, se_reduct=reduct))
        return tuple(blocks)

    return MiniFASNetSpec(
        conv1_out=32,
        conv2_out=32,
        conv2_groups=32,
        conv_23=dw(96, 64, 2),
        conv_3=res(64, 64, 4, se_last=se),
        conv_34=dw(224, 128, 2),
        conv_4=res(128, 128, 6, se_last=se),
        conv_45=dw(288, 128, 2),
        conv_5=res(128, 128, 2, se_last=se),
        conv6_sep_out=512,
        conv6_out=512,
        conv6_groups=512,
        conv6_kernel=conv6_kernel_for(input_hw),
        embedding_size=embedding_size,
        num_classes=num_classes,
    )


class ConvBlock(nn.Module):
    """Conv_block: conv (no bias, padding k//2 unless given) + BN + PReLU;
    Linear_block (``prelu=False``): conv + BN."""

    def __init__(self, inp, out, kernel=(1, 1), stride=1, groups=1, padding=None, prelu=True):
        super().__init__()
        pad = tuple(k // 2 for k in kernel) if padding is None else padding
        self.conv = nn.Conv2d(inp, out, kernel, stride, pad, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(out, eps=BN_EPS)
        self.prelu = nn.PReLU(out) if prelu else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return x if self.prelu is None else self.prelu(x)


class SEModule(nn.Module):
    def __init__(self, channels: int, reduct: int) -> None:
        super().__init__()
        self.fc1 = nn.Conv2d(channels, reduct, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(reduct, eps=BN_EPS)
        self.fc2 = nn.Conv2d(reduct, channels, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(channels, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.bn2(self.fc2(torch.relu(self.bn1(self.fc1(s)))))
        return x * torch.sigmoid(s)


class DepthWise(nn.Module):
    def __init__(self, inp: int, spec: DWSpec) -> None:
        super().__init__()
        self.residual = spec.residual
        self.conv = ConvBlock(inp, spec.mid1)
        self.conv_dw = ConvBlock(spec.mid1, spec.mid2, spec.kernel, spec.stride, spec.groups)
        self.project = ConvBlock(spec.mid2, spec.out, prelu=False)
        self.se_module = SEModule(spec.out, spec.se_reduct) if spec.se_reduct else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.project(self.conv_dw(self.conv(x)))
        if self.se_module is not None:
            y = self.se_module(y)
        return y + x if self.residual else y


class Residual(nn.Module):
    """A stage of residual Depth_Wise blocks (Silent-Face's ``.model`` keys)."""

    def __init__(self, inp: int, blocks: Tuple[DWSpec, ...]) -> None:
        super().__init__()
        layers = []
        for blk in blocks:
            layers.append(DepthWise(inp, blk))
            inp = blk.out
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class MiniFASNet(nn.Module):
    """(B, 3, H, W) raw 0-255 BGR -> (B, num_classes) probabilities
    (``softmax=True``, the pipeline's contract) or logits."""

    def __init__(self, spec: MiniFASNetSpec, softmax: bool = True) -> None:
        super().__init__()
        s = spec
        self.spec, self.softmax = spec, softmax
        self.conv1 = ConvBlock(3, s.conv1_out, (3, 3), 2)
        self.conv2_dw = ConvBlock(s.conv1_out, s.conv2_out, (3, 3), groups=s.conv2_groups)
        self.conv_23 = DepthWise(s.conv2_out, s.conv_23)
        self.conv_3 = Residual(s.conv_23.out, s.conv_3)
        self.conv_34 = DepthWise(s.conv_3[-1].out, s.conv_34)
        self.conv_4 = Residual(s.conv_34.out, s.conv_4)
        self.conv_45 = DepthWise(s.conv_4[-1].out, s.conv_45)
        self.conv_5 = Residual(s.conv_45.out, s.conv_5)
        self.conv_6_sep = ConvBlock(s.conv_5[-1].out, s.conv6_sep_out)
        self.conv_6_dw = ConvBlock(
            s.conv6_sep_out, s.conv6_out, s.conv6_kernel, groups=s.conv6_groups, padding=0, prelu=False
        )
        self.linear = nn.Linear(s.conv6_out, s.embedding_size, bias=False)
        self.bn = nn.BatchNorm1d(s.embedding_size, eps=BN_EPS)
        self.prob = nn.Linear(s.embedding_size, s.num_classes, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv2_dw(self.conv1(x))
        x = self.conv_5(self.conv_45(self.conv_4(self.conv_34(self.conv_3(self.conv_23(x))))))
        x = torch.flatten(self.conv_6_dw(self.conv_6_sep(x)), 1)  # (B, C, 1, 1): no permute
        x = self.prob(self.bn(self.linear(x)))
        return torch.softmax(x, dim=-1) if self.softmax else x


def _dw_spec_from_sd(sd: Mapping, prefix: str, stride: int, residual: bool) -> DWSpec:
    w1 = np.asarray(sd[f"{prefix}.conv.conv.weight"])
    w2 = np.asarray(sd[f"{prefix}.conv_dw.conv.weight"])
    w3 = np.asarray(sd[f"{prefix}.project.conv.weight"])
    mid1, mid2, out = w1.shape[0], w2.shape[0], w3.shape[0]
    groups = mid1 // w2.shape[1]
    se_key = f"{prefix}.se_module.fc1.weight"
    se_reduct = int(np.asarray(sd[se_key]).shape[0]) if se_key in sd else 0
    return DWSpec(
        mid1=mid1,
        mid2=mid2,
        out=out,
        groups=groups,
        kernel=(int(w2.shape[2]), int(w2.shape[3])),
        stride=stride,
        residual=residual,
        se_reduct=se_reduct,
    )


def _stage_blocks(sd: Mapping, stage: str) -> Tuple[DWSpec, ...]:
    blocks = []
    i = 0
    while f"{stage}.model.{i}.conv.conv.weight" in sd:
        blocks.append(_dw_spec_from_sd(sd, f"{stage}.model.{i}", 1, True))
        i += 1
    if not blocks:
        raise ValueError(f"no blocks found for stage {stage!r}")
    return tuple(blocks)


def minifasnet_spec_from_state_dict(sd: Mapping[str, Any]) -> MiniFASNetSpec:
    """Derive the complete architecture from a MiniFASNet state_dict's shapes
    (widths, group counts, block counts, SE placement, the conv6 kernel)."""
    sd = strip_module_prefix(sd)
    w1 = np.asarray(sd["conv1.conv.weight"])
    w2 = np.asarray(sd["conv2_dw.conv.weight"])
    w6s = np.asarray(sd["conv_6_sep.conv.weight"])
    w6d = np.asarray(sd["conv_6_dw.conv.weight"])
    wl = np.asarray(sd["linear.weight"])
    wp = np.asarray(sd["prob.weight"])
    return MiniFASNetSpec(
        conv1_out=int(w1.shape[0]),
        conv2_out=int(w2.shape[0]),
        conv2_groups=int(w1.shape[0] // w2.shape[1]),
        conv_23=_dw_spec_from_sd(sd, "conv_23", 2, False),
        conv_3=_stage_blocks(sd, "conv_3"),
        conv_34=_dw_spec_from_sd(sd, "conv_34", 2, False),
        conv_4=_stage_blocks(sd, "conv_4"),
        conv_45=_dw_spec_from_sd(sd, "conv_45", 2, False),
        conv_5=_stage_blocks(sd, "conv_5"),
        conv6_sep_out=int(w6s.shape[0]),
        conv6_out=int(w6d.shape[0]),
        conv6_groups=int(w6s.shape[0] // w6d.shape[1]),
        conv6_kernel=(int(w6d.shape[2]), int(w6d.shape[3])),
        embedding_size=int(wl.shape[0]),
        num_classes=int(wp.shape[0]),
    )


def minifasnet_map(spec: MiniFASNetSpec) -> Dict[str, Tuple]:
    """{flax path: (torch key, kind)} for a MiniFASNet of the given spec
    (the JAX package's minifasnet_map; its bias-free Dense is kind
    ``dense_nobias`` here)."""
    m: Dict[str, Tuple] = {}

    def conv_block(f: str, t: str, prelu: bool = True) -> None:
        m[f"params/{f}/conv/kernel"] = (f"{t}.conv", "conv")
        m[f"params/{f}/bn"] = (f"{t}.bn", "bn")
        if prelu:
            m[f"params/{f}/prelu/alpha"] = (f"{t}.prelu.weight", "raw")

    def dw(f: str, t: str, blk: DWSpec) -> None:
        conv_block(f"{f}/conv", f"{t}.conv")
        conv_block(f"{f}/conv_dw", f"{t}.conv_dw")
        conv_block(f"{f}/project", f"{t}.project", prelu=False)
        if blk.se_reduct:
            m[f"params/{f}/se_module/fc1/kernel"] = (f"{t}.se_module.fc1", "conv")
            m[f"params/{f}/se_module/bn1"] = (f"{t}.se_module.bn1", "bn")
            m[f"params/{f}/se_module/fc2/kernel"] = (f"{t}.se_module.fc2", "conv")
            m[f"params/{f}/se_module/bn2"] = (f"{t}.se_module.bn2", "bn")

    conv_block("conv1", "conv1")
    conv_block("conv2_dw", "conv2_dw")
    dw("conv_23", "conv_23", spec.conv_23)
    for i, blk in enumerate(spec.conv_3):
        dw(f"conv_3_b{i}", f"conv_3.model.{i}", blk)
    dw("conv_34", "conv_34", spec.conv_34)
    for i, blk in enumerate(spec.conv_4):
        dw(f"conv_4_b{i}", f"conv_4.model.{i}", blk)
    dw("conv_45", "conv_45", spec.conv_45)
    for i, blk in enumerate(spec.conv_5):
        dw(f"conv_5_b{i}", f"conv_5.model.{i}", blk)
    conv_block("conv_6_sep", "conv_6_sep")
    conv_block("conv_6_dw", "conv_6_dw", prelu=False)
    m["params/linear/kernel"] = ("linear", "dense_nobias")
    m["params/bn"] = ("bn", "bn")
    m["params/prob/kernel"] = ("prob", "dense_nobias")
    return m
