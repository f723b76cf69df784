"""mmdet-layout SCRFD: the network of public insightface SCRFD checkpoints.

Counterpart of rs_face_detection_tpu/models/scrfd_import.py.  Public SCRFD
weights are trained in an mmdetection fork, and their state_dicts carry the
mmdet module names, which ``SCRFDImportedNet`` keeps, so such a state_dict
loads with ``load_state_dict``:

    backbone.stem.{0,1,3,4,6,7}.*          deep 3-conv stem (ResNetV1e) or
    backbone.conv1 / backbone.bn1          the classic 7x7 stem
    backbone.layer{s}.{b}.conv1/bn1/conv2/bn2[/conv3/bn3][/downsample.{0,1}]
    neck.lateral_convs.{i}.conv.*          PAFPN: 1x1 laterals,
    neck.fpn_convs.{i}.conv.*              3x3 smoothing,
    neck.downsample_convs.{i}.conv.*       bottom-up 3x3/s2,
    neck.pafpn_convs.{i}.conv.*            3x3 outputs
    bbox_head.cls_convs.0.{j}.conv/gn|bn.* one tower shared by the strides
    bbox_head.reg_convs.0.{j}.conv/gn|bn.*
    bbox_head.stride_cls.{s}.*             per-stride 3x3 prediction convs
    bbox_head.stride_reg.{s}.*
    bbox_head.stride_kps.{s}.*
    bbox_head.scales.{i}.scale             per-stride regression scale

Checkpoints key the per-stride convs as "8" or as "(8, 8)";
``load_scrfd_state_dict`` takes both and renames them to the first form.
``scrfd_spec_from_state_dict`` derives the architecture from tensor shapes
alone (a copy of the JAX function), and ``scrfd_map`` gives the flax paths of
the JAX package's ``SCRFDImportedNet``, for the registry's ``.npz`` format.

The forward is mmdet's: BatchNorm and GroupNorm epsilon 1e-5, a 3x3/s2
max-pool after the stem, stage 1 at stride 1 and later stages at stride 2
(the stride on the 3x3 conv), nearest top-down upsampling, bottom-up path
aggregation, and the shared head with per-stride scales on the boxes.
Output per stride, channels last as models/scrfd.py's SCRFD:
``{"score": (B, H, W, A) sigmoid, "bbox": (B, H, W, A*4), "kps": (B, H, W,
A*10)}``, which pipeline/ekyc_pipeline.py::SCRFDDetection consumes as it is.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .checkpoint_maps import match_state_dict, strip_module_prefix
from .layers import upsample_nearest_2x

EPS = 1e-5

# ---------------------------------------------------------------------------
# spec (copies of the JAX package's functions)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SCRFDImportSpec:
    deep_stem: bool
    stem_channels: Tuple[int, ...]  # conv output widths, stem order
    block: str  # "basic" | "bottleneck"
    stage_blocks: Tuple[int, ...]
    stage_planes: Tuple[int, ...]  # block OUTPUT widths per stage
    neck_in_start: int  # first backbone stage feeding the neck (0-based)
    neck_out: int
    num_levels: int
    stacked_convs: int
    head_channels: int
    num_anchors: int
    use_kps: bool
    head_norm: str  # "gn" | "bn"
    gn_groups: int
    strides: Tuple[int, ...] = (8, 16, 32)


def _count(sd: Mapping[str, Any], fmt: str) -> int:
    n = 0
    while fmt.format(n) in sd:
        n += 1
    return n


def _shape(sd: Mapping[str, Any], key: str) -> Tuple[int, ...]:
    return tuple(int(d) for d in np.shape(sd[key]))


def scrfd_spec_from_state_dict(sd: Mapping[str, Any]) -> SCRFDImportSpec:
    """Derive the architecture from tensor shapes."""
    deep_stem = "backbone.stem.0.weight" in sd
    if deep_stem:
        stem = []
        i = 0
        while f"backbone.stem.{i}.weight" in sd:
            stem.append(_shape(sd, f"backbone.stem.{i}.weight")[0])
            i += 3  # Conv at 0, BN at 1, ReLU at 2 (no params)
        stem_channels = tuple(stem)
    elif "backbone.conv1.weight" in sd:
        stem_channels = (_shape(sd, "backbone.conv1.weight")[0],)
    else:
        raise ValueError("no recognizable backbone stem keys")

    block = "bottleneck" if "backbone.layer1.0.conv3.weight" in sd else "basic"
    stage_blocks: List[int] = []
    stage_planes: List[int] = []
    s = 1
    while f"backbone.layer{s}.0.conv1.weight" in sd:
        stage_blocks.append(_count(sd, f"backbone.layer{s}.{{0}}.conv1.weight"))
        last_conv = "conv3" if block == "bottleneck" else "conv2"
        stage_planes.append(_shape(sd, f"backbone.layer{s}.0.{last_conv}.weight")[0])
        s += 1
    if not stage_blocks:
        raise ValueError("no backbone.layer* stages found")

    n_lat = _count(sd, "neck.lateral_convs.{0}.conv.weight")
    if n_lat == 0:
        raise ValueError("no neck.lateral_convs found")
    neck_out = _shape(sd, "neck.lateral_convs.0.conv.weight")[0]
    lat_in = [_shape(sd, f"neck.lateral_convs.{i}.conv.weight")[1] for i in range(n_lat)]
    for start in range(len(stage_planes) - n_lat + 1):
        if list(stage_planes[start : start + n_lat]) == lat_in:
            break
    else:
        raise ValueError(f"neck input widths {lat_in} do not match stage planes {stage_planes}")

    stacked = _count(sd, "bbox_head.cls_convs.0.{0}.conv.weight")
    if stacked == 0:
        raise ValueError("no bbox_head.cls_convs tower found")
    head_ch = _shape(sd, "bbox_head.cls_convs.0.0.conv.weight")[0]
    head_norm = "gn" if "bbox_head.cls_convs.0.0.gn.weight" in sd else "bn"
    cls_keys = _stride_head_keys(sd, "stride_cls")
    if not cls_keys:
        raise ValueError("no bbox_head.stride_cls prediction convs found")
    return SCRFDImportSpec(
        deep_stem=deep_stem,
        stem_channels=stem_channels,
        block=block,
        stage_blocks=tuple(stage_blocks),
        stage_planes=tuple(stage_planes),
        neck_in_start=start,
        neck_out=neck_out,
        num_levels=n_lat,
        stacked_convs=stacked,
        head_channels=head_ch,
        num_anchors=_shape(sd, cls_keys[0] + ".weight")[0],
        use_kps=bool(_stride_head_keys(sd, "stride_kps")),
        head_norm=head_norm,
        gn_groups=_gn_groups(_shape(sd, "bbox_head.cls_convs.0.0.gn.weight")[0]) if head_norm == "gn" else 32,
    )


def _gn_groups(channels: int) -> int:
    """Default GN group count -- not recoverable from tensor shapes.  The
    insightface SCRFD configs use 16 groups; narrower widths fall back to
    smaller powers of two.  load_scrfd_state_dict(gn_groups=...) overrides."""
    for g in (16, 8, 4, 2, 1):
        if channels % g == 0:
            return g
    return 1


def _stride_head_keys(sd: Mapping[str, Any], name: str) -> List[str]:
    """Per-stride prediction conv prefixes, sorted by the first integer of
    their ModuleDict key ("8" or "(8, 8)")."""
    pat = re.compile(rf"^bbox_head\.{name}\.([^.]+)\.weight$")
    prefixes = {f"bbox_head.{name}.{m.group(1)}" for m in map(pat.match, sd) if m}

    def stride_of(prefix: str) -> int:
        nums = re.findall(r"\d+", prefix.rsplit(".", 1)[1])
        return int(nums[0]) if nums else 0

    return sorted(prefixes, key=stride_of)


# ---------------------------------------------------------------------------
# the network, with mmdet's module names
# ---------------------------------------------------------------------------


def _conv_bn(inp: int, out: int, k: int, stride: int = 1) -> List[nn.Module]:
    return [nn.Conv2d(inp, out, k, stride, k // 2, bias=False), nn.BatchNorm2d(out, eps=EPS)]


class BasicBlock(nn.Module):
    def __init__(self, inp: int, planes: int, stride: int = 1) -> None:
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(inp, planes, 3, stride)
        self.conv2, self.bn2 = _conv_bn(planes, planes, 3)
        self.downsample = (
            nn.Sequential(*_conv_bn(inp, planes, 1, stride)) if inp != planes or stride != 1 else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu((x if self.downsample is None else self.downsample(x)) + y)


class Bottleneck(nn.Module):
    """``planes`` is the block's output width (4x its middle width)."""

    def __init__(self, inp: int, planes: int, stride: int = 1) -> None:
        super().__init__()
        mid = planes // 4
        self.conv1, self.bn1 = _conv_bn(inp, mid, 1)
        self.conv2, self.bn2 = _conv_bn(mid, mid, 3, stride)
        self.conv3, self.bn3 = _conv_bn(mid, planes, 1)
        self.downsample = (
            nn.Sequential(*_conv_bn(inp, planes, 1, stride)) if inp != planes or stride != 1 else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn3(self.conv3(F.relu(self.bn2(self.conv2(y)))))
        return F.relu((x if self.downsample is None else self.downsample(x)) + y)


class ConvModule(nn.Module):
    """mmdet ConvModule: conv (with a bias when there is no norm), then
    GroupNorm (``gn``) or BatchNorm (``bn``) if asked, then an optional ReLU."""

    def __init__(
        self, inp: int, out: int, k: int = 3, stride: int = 1,
        norm: Optional[str] = None, gn_groups: int = 32, relu: bool = True,
    ) -> None:
        super().__init__()
        self.conv = nn.Conv2d(inp, out, k, stride, k // 2, bias=norm is None)
        self.norm = norm
        if norm == "gn":
            self.gn = nn.GroupNorm(gn_groups, out, eps=EPS)
        elif norm == "bn":
            self.bn = nn.BatchNorm2d(out, eps=EPS)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = getattr(self, self.norm)(x)
        return F.relu(x) if self.relu else x


class Scale(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(()))


class SCRFDImportedNet(nn.Module):
    """mmdet-layout SCRFD: ResNet (deep or classic stem) + PAFPN + the shared
    SCRFD head.  Input (B, 3, H, W) normalized RGB."""

    def __init__(self, spec: SCRFDImportSpec) -> None:
        super().__init__()
        sp = self.spec = spec
        self.num_anchors = sp.num_anchors
        backbone = nn.Module()
        if sp.deep_stem:
            layers: List[nn.Module] = []
            inp = 3
            for i, ch in enumerate(sp.stem_channels):
                layers += [*_conv_bn(inp, ch, 3, 2 if i == 0 else 1), nn.ReLU()]
                inp = ch
            backbone.stem = nn.Sequential(*layers)
        else:
            inp = sp.stem_channels[0]
            backbone.conv1, backbone.bn1 = _conv_bn(3, inp, 7, 2)
        block = BasicBlock if sp.block == "basic" else Bottleneck
        for s, (blocks, planes) in enumerate(zip(sp.stage_blocks, sp.stage_planes)):
            stage = []
            for b in range(blocks):
                stage.append(block(inp, planes, 2 if (b == 0 and s > 0) else 1))
                inp = planes
            setattr(backbone, f"layer{s + 1}", nn.Sequential(*stage))
        self.backbone = backbone

        levels, out = sp.num_levels, sp.neck_out
        ins = sp.stage_planes[sp.neck_in_start : sp.neck_in_start + levels]
        neck = nn.Module()
        neck.lateral_convs = nn.ModuleList([ConvModule(c, out, 1, relu=False) for c in ins])
        neck.fpn_convs = nn.ModuleList([ConvModule(out, out, 3, relu=False) for _ in ins])
        neck.downsample_convs = nn.ModuleList([ConvModule(out, out, 3, 2, relu=False) for _ in ins[1:]])
        neck.pafpn_convs = nn.ModuleList([ConvModule(out, out, 3, relu=False) for _ in ins[1:]])
        self.neck = neck

        head = nn.Module()
        ch, a = sp.head_channels, sp.num_anchors

        def tower() -> nn.ModuleList:
            return nn.ModuleList([nn.ModuleList([
                ConvModule(out if j == 0 else ch, ch, 3, norm=sp.head_norm, gn_groups=sp.gn_groups)
                for j in range(sp.stacked_convs)
            ])])

        head.cls_convs, head.reg_convs = tower(), tower()
        keys = [str(s) for s in sp.strides[:levels]]
        head.stride_cls = nn.ModuleDict({k: nn.Conv2d(ch, a, 3, 1, 1) for k in keys})
        head.stride_reg = nn.ModuleDict({k: nn.Conv2d(ch, a * 4, 3, 1, 1) for k in keys})
        if sp.use_kps:
            head.stride_kps = nn.ModuleDict({k: nn.Conv2d(ch, a * 10, 3, 1, 1) for k in keys})
        head.scales = nn.ModuleList([Scale() for _ in keys])
        self.bbox_head = head

    def forward(self, x: torch.Tensor, raw: bool = False) -> Dict[int, Dict[str, torch.Tensor]]:
        """Per-stride channels-last maps; ``raw`` leaves the scores as logits."""
        sp, bb = self.spec, self.backbone
        x = bb.stem(x) if sp.deep_stem else F.relu(bb.bn1(bb.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for s in range(len(sp.stage_blocks)):
            x = getattr(bb, f"layer{s + 1}")(x)
            feats.append(x)
        inputs = feats[sp.neck_in_start : sp.neck_in_start + sp.num_levels]

        neck = self.neck
        laterals = [conv(f) for conv, f in zip(neck.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + upsample_nearest_2x(laterals[i], laterals[i - 1].shape[2:])
        inter = [conv(lat) for conv, lat in zip(neck.fpn_convs, laterals)]
        for i in range(len(inter) - 1):
            inter[i + 1] = inter[i + 1] + neck.downsample_convs[i](inter[i])
        outs = [inter[0]] + [conv(t) for conv, t in zip(neck.pafpn_convs, inter[1:])]

        head = self.bbox_head
        result: Dict[int, Dict[str, torch.Tensor]] = {}
        for i, (stride, feat) in enumerate(zip(sp.strides, outs)):
            c = r = feat
            for conv in head.cls_convs[0]:
                c = conv(c)
            for conv in head.reg_convs[0]:
                r = conv(r)
            key = str(stride)
            score = head.stride_cls[key](c).permute(0, 2, 3, 1)
            entry = {
                "score": score if raw else torch.sigmoid(score),
                "bbox": (head.stride_reg[key](r) * head.scales[i].scale).permute(0, 2, 3, 1),
            }
            if sp.use_kps:
                entry["kps"] = head.stride_kps[key](r).permute(0, 2, 3, 1)
            result[stride] = entry
        return result


def init_scrfd_imported(spec: SCRFDImportSpec, seed: int = 0) -> SCRFDImportedNet:
    """The network of ``spec`` in eval mode on seeded weights
    (models/weights.py::seeded_state)."""
    from .weights import seeded_state

    model = SCRFDImportedNet(spec).eval()
    model.load_state_dict(seeded_state(model, seed))
    return model


# ---------------------------------------------------------------------------
# flax paths (the registry's .npz format) and the import
# ---------------------------------------------------------------------------


def scrfd_map(spec: SCRFDImportSpec) -> Dict[str, Tuple]:
    """{flax path: (torch key, kind)} between the JAX package's
    SCRFDImportedNet of ``spec`` and this module (stride keys "8")."""
    m: Dict[str, Tuple] = {}
    model = SCRFDImportedNet(spec)  # which blocks have a downsample
    keys = set(model.state_dict())

    def conv_bn(f: str, t_conv: str, t_bn: str) -> None:
        m[f"params/{f}/conv/kernel"] = (t_conv, "conv")
        m[f"params/{f}/bn"] = (t_bn, "bn")

    if spec.deep_stem:
        for i in range(len(spec.stem_channels)):
            conv_bn(f"stem{i}", f"backbone.stem.{i * 3}", f"backbone.stem.{i * 3 + 1}")
    else:
        conv_bn("stem0", "backbone.conv1", "backbone.bn1")
    n_convs = 3 if spec.block == "bottleneck" else 2
    for s, blocks in enumerate(spec.stage_blocks):
        for b in range(blocks):
            t, f = f"backbone.layer{s + 1}.{b}", f"s{s}b{b}"
            for c in range(1, n_convs + 1):
                conv_bn(f"{f}/cb{c}", f"{t}.conv{c}", f"{t}.bn{c}")
            if f"{t}.downsample.0.weight" in keys:
                conv_bn(f"{f}/down", f"{t}.downsample.0", f"{t}.downsample.1")
    for i in range(spec.num_levels):
        m[f"params/lat{i}/conv"] = (f"neck.lateral_convs.{i}.conv", "conv_bias")
        m[f"params/fpn{i}/conv"] = (f"neck.fpn_convs.{i}.conv", "conv_bias")
    for i in range(spec.num_levels - 1):
        m[f"params/down{i}/conv"] = (f"neck.downsample_convs.{i}.conv", "conv_bias")
        m[f"params/pafpn{i}/conv"] = (f"neck.pafpn_convs.{i}.conv", "conv_bias")
    for j in range(spec.stacked_convs):
        for tower, torch_tower in (("cls_t", "cls_convs"), ("reg_t", "reg_convs")):
            base = f"bbox_head.{torch_tower}.0.{j}"
            m[f"params/{tower}{j}/conv/kernel"] = (f"{base}.conv", "conv")
            if spec.head_norm == "gn":
                m[f"params/{tower}{j}/gn/scale"] = (f"{base}.gn.weight", "raw")
                m[f"params/{tower}{j}/gn/bias"] = (f"{base}.gn.bias", "raw")
            else:
                m[f"params/{tower}{j}/bn"] = (f"{base}.bn", "bn")
    preds = [("stride_cls", "pred_cls"), ("stride_reg", "pred_reg")]
    if spec.use_kps:
        preds.append(("stride_kps", "pred_kps"))
    for i, stride in enumerate(spec.strides[: spec.num_levels]):
        for kind, flax_name in preds:
            m[f"params/{flax_name}{i}"] = (f"bbox_head.{kind}.{stride}", "conv_bias")
        m[f"params/scale{i}"] = (f"bbox_head.scales.{i}.scale", "raw")
    return m


def _normalize_stride_keys(sd: Mapping[str, Any], spec: SCRFDImportSpec) -> Dict[str, Any]:
    """Rename the per-stride prediction convs' keys to the "8" form."""
    out = dict(sd)
    for name in ("stride_cls", "stride_reg", "stride_kps"):
        for prefix, stride in zip(_stride_head_keys(sd, name), spec.strides):
            for suffix in ("weight", "bias"):
                key = f"{prefix}.{suffix}"
                if key in out:
                    out[f"bbox_head.{name}.{stride}.{suffix}"] = out.pop(key)
    return out


def load_scrfd_state_dict(
    state_dict: Mapping[str, Any], strict: bool = True, gn_groups: Optional[int] = None
) -> Tuple[SCRFDImportedNet, SCRFDImportSpec]:
    """Build the SCRFDImportedNet that ``state_dict`` describes and load it:
    (model in eval mode, spec).  ``gn_groups`` overrides the head's
    GroupNorm group count (shapes do not fix it; 16 where it divides).
    Per-stride scales absent from the checkpoint stay 1, as in the JAX
    import."""
    sd = strip_module_prefix(state_dict)
    spec = scrfd_spec_from_state_dict(sd)
    if gn_groups is not None:
        spec = dataclasses.replace(spec, gn_groups=gn_groups)
    model = SCRFDImportedNet(spec).eval()
    sd = _normalize_stride_keys(sd, spec)
    for i in range(spec.num_levels):
        sd.setdefault(f"bbox_head.scales.{i}.scale", np.ones((), np.float32))
    model.load_state_dict(match_state_dict(model, sd, "scrfd", strict))
    return model, spec
