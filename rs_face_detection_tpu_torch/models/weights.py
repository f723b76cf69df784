"""Weights for the port: the bridge from the JAX package, and a seeded init.

The bridge turns the JAX package's parameters (flax ``variables``, or a
registry ``.npz`` of '/'-joined keys such as
``params/body/conv1/Conv_0/kernel``) into the ``state_dict`` of the port's
module.  It is the inverse of the JAX package's import maps
(models/checkpoint_maps.py, models/classifiers.py::resnet18_classifier_map),
whose entries are copied here so that no JAX module is imported:

  - conv kernels HWIO -> OIHW (depthwise (3, 3, 1, C) -> (C, 1, 3, 3));
  - Dense kernels are transposed; IResNet's ``fc`` also has its input
    dimension permuted from flax's NHWC flatten to torch's NCHW flatten;
  - BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var;
  - float16 leaves (``trained_real640.npz`` is stored in float16) become
    float32.

``init_state`` gives a full-width state_dict from ``numpy.random.default_rng``
with the distributions of flax's default initializers (the bits differ), for
machines that hold no checkpoint and no JAX.

``state_dict_from_biubug6`` loads a public biubug6 ``Resnet50_Final.pth``
state_dict into the port's RetinaFace-R50: the keys are already the port's,
and the 7x7/s2 stem converts exactly to the s2d form
(models/resnet.py::stem_to_s2d).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from .arcface import FC_GRID, STAGES, IResNet
from .classifiers import ResNet18Classifier
from .resnet import STAGES as RESNET50_STAGES
from .resnet import stem_to_s2d
from .retinaface import RetinaFace

#: The model families the bridge and the seeded init know.
FAMILIES = (
    "retinaface_mobilenet025",
    "retinaface_resnet50",
    *STAGES,
    "resnet18_classifier",
)
#: RetinaFace families and their backbone.
RETINAFACE = {"retinaface_mobilenet025": "mobilenet025", "retinaface_resnet50": "resnet50"}


def _conv_bn(m: Dict, flax_mod: str, torch_mod: str) -> None:
    m[f"params/{flax_mod}/Conv_0/kernel"] = (f"{torch_mod}.0", "conv")
    m[f"params/{flax_mod}/BatchNorm_0"] = (f"{torch_mod}.1", "bn")


def _conv_dw(m: Dict, flax_mod: str, torch_mod: str) -> None:
    m[f"params/{flax_mod}/dw/Conv_0/kernel"] = (f"{torch_mod}.0", "conv")
    m[f"params/{flax_mod}/dw/BatchNorm_0"] = (f"{torch_mod}.1", "bn")
    m[f"params/{flax_mod}/pw/Conv_0/kernel"] = (f"{torch_mod}.3", "conv")
    m[f"params/{flax_mod}/pw/BatchNorm_0"] = (f"{torch_mod}.4", "bn")


def retinaface_mobilenet025_map() -> Dict[str, Tuple]:
    """{flax path: (torch key, kind)}; checkpoint_maps.retinaface_mobilenet025_map."""
    m: Dict[str, Tuple] = {}
    _conv_bn(m, "body/conv1", "body.stage1.0")
    for i in range(1, 6):
        _conv_dw(m, f"body/ds{i}", f"body.stage1.{i}")
    for i in range(6):
        _conv_dw(m, f"body/ds{6 + i}", f"body.stage2.{i}")
    for i in range(2):
        _conv_dw(m, f"body/ds{12 + i}", f"body.stage3.{i}")
    _neck_and_heads(m)
    return m


def retinaface_resnet50_map() -> Dict[str, Tuple]:
    """{flax path: (torch key, kind)}; the inverse of
    checkpoint_maps.retinaface_resnet50_map with the s2d stem, whose
    (4, 4, 12, 64) kernel maps to body.conv1 as it is (HWIO -> OIHW)."""
    m: Dict[str, Tuple] = {
        "params/body/stem/Conv_0/kernel": ("body.conv1", "conv"),
        "params/body/stem/BatchNorm_0": ("body.bn1", "bn"),
    }
    for s, blocks in enumerate(RESNET50_STAGES):
        for b in range(blocks):
            t, f = f"body.layer{s + 1}.{b}", f"params/body/s{s}b{b}"
            for c in (1, 2, 3):
                m[f"{f}/c{c}/Conv_0/kernel"] = (f"{t}.conv{c}", "conv")
                m[f"{f}/c{c}/BatchNorm_0"] = (f"{t}.bn{c}", "bn")
            if b == 0:
                m[f"{f}/proj/Conv_0/kernel"] = (f"{t}.downsample.0", "conv")
                m[f"{f}/proj/BatchNorm_0"] = (f"{t}.downsample.1", "bn")
    _neck_and_heads(m)
    return m


def _neck_and_heads(m: Dict) -> None:
    """FPN, SSH and heads: the same keys for both backbones."""
    for i, name in enumerate(("output1", "output2", "output3")):
        _conv_bn(m, f"fpn/lateral{i}", f"fpn.{name}")
    _conv_bn(m, "fpn/merge0", "fpn.merge1")
    _conv_bn(m, "fpn/merge1", "fpn.merge2")
    for i in range(3):
        t = f"ssh{i + 1}"
        _conv_bn(m, f"ssh{i}/conv3", f"{t}.conv3X3")
        _conv_bn(m, f"ssh{i}/conv5_1", f"{t}.conv5X5_1")
        _conv_bn(m, f"ssh{i}/conv5_2", f"{t}.conv5X5_2")
        _conv_bn(m, f"ssh{i}/conv7_1", f"{t}.conv7X7_2")
        _conv_bn(m, f"ssh{i}/conv7_2", f"{t}.conv7x7_3")
    for i in range(3):
        m[f"params/cls{i}"] = (f"ClassHead.{i}.conv1x1", "conv_bias")
        m[f"params/box{i}"] = (f"BboxHead.{i}.conv1x1", "conv_bias")
        m[f"params/ldm{i}"] = (f"LandmarkHead.{i}.conv1x1", "conv_bias")


def iresnet_map(depth: str = "iresnet50") -> Dict[str, Tuple]:
    """{flax path: (torch key, kind)}; checkpoint_maps.iresnet_map."""
    m: Dict[str, Tuple] = {
        "params/stem/kernel": ("conv1", "conv"),
        "params/stem_bn": ("bn1", "bn"),
        "params/stem_prelu/alpha": ("prelu.weight", "raw"),
        "params/tail_bn": ("bn2", "bn"),
        "params/fc": ("fc", "dense_nchw", (512, FC_GRID, FC_GRID)),
        "params/feat_bn": ("features", "bn"),
    }
    for s, blocks in enumerate(STAGES[depth]):
        for b in range(blocks):
            t, f = f"layer{s + 1}.{b}", f"params/s{s}b{b}"
            m[f"{f}/bn1"] = (f"{t}.bn1", "bn")
            m[f"{f}/conv1/kernel"] = (f"{t}.conv1", "conv")
            m[f"{f}/bn2"] = (f"{t}.bn2", "bn")
            m[f"{f}/prelu/alpha"] = (f"{t}.prelu.weight", "raw")
            m[f"{f}/conv2/kernel"] = (f"{t}.conv2", "conv")
            m[f"{f}/bn3"] = (f"{t}.bn3", "bn")
            if b == 0:
                m[f"{f}/down_conv/kernel"] = (f"{t}.downsample.0", "conv")
                m[f"{f}/down_bn"] = (f"{t}.downsample.1", "bn")
    return m


def resnet18_classifier_map() -> Dict[str, Tuple]:
    """{flax path: (torch key, kind)}; classifiers.resnet18_classifier_map."""
    m: Dict[str, Tuple] = {
        "params/stem/kernel": ("conv1", "conv"),
        "params/stem_bn": ("bn1", "bn"),
        "params/fc": ("fc", "dense"),
    }
    for s in range(4):
        for b in range(2):
            t, f = f"layer{s + 1}.{b}", f"params/s{s}b{b}"
            m[f"{f}/conv1/kernel"] = (f"{t}.conv1", "conv")
            m[f"{f}/bn1"] = (f"{t}.bn1", "bn")
            m[f"{f}/conv2/kernel"] = (f"{t}.conv2", "conv")
            m[f"{f}/bn2"] = (f"{t}.bn2", "bn")
            if s > 0 and b == 0:
                m[f"{f}/down_conv/kernel"] = (f"{t}.downsample.0", "conv")
                m[f"{f}/down_bn"] = (f"{t}.downsample.1", "bn")
    return m


def mapping_for(family: str) -> Dict[str, Tuple]:
    if family == "retinaface_mobilenet025":
        return retinaface_mobilenet025_map()
    if family == "retinaface_resnet50":
        return retinaface_resnet50_map()
    if family in STAGES:
        return iresnet_map(family)
    if family == "resnet18_classifier":
        return resnet18_classifier_map()
    raise ValueError(f"unknown family {family!r} (one of {FAMILIES})")


def build_model(family: str, num_outputs: int = 4) -> nn.Module:
    """The port's module for a family, in eval mode, on the CPU."""
    if family in RETINAFACE:
        model = RetinaFace(RETINAFACE[family])
    elif family in STAGES:
        model = IResNet(family)
    elif family == "resnet18_classifier":
        model = ResNet18Classifier(num_outputs)
    else:
        raise ValueError(f"unknown family {family!r} (one of {FAMILIES})")
    return model.eval()


def flat_variables(source: Any) -> Dict[str, np.ndarray]:
    """'/'-joined float32 leaves from an .npz path or a (nested) mapping."""
    if isinstance(source, (str, os.PathLike)):
        with np.load(source) as data:
            source = {k: data[k] for k in data.files}
    flat: Dict[str, np.ndarray] = {}

    def walk(node: Any, prefix: str) -> None:
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        else:
            leaf = np.asarray(node)
            flat[prefix.rstrip("/")] = (
                leaf.astype(np.float32) if leaf.dtype == np.float16 else leaf
            )

    walk(source, "")
    return flat


def _tensor(x: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32))


def state_dict_from_jax(family: str, source: Any) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a family from JAX variables or an .npz.

    Raises if a JAX leaf goes unused, so a layout drift cannot pass silently.
    """
    flat = flat_variables(source)
    used = set()

    def take(key: str) -> np.ndarray:
        used.add(key)
        return flat[key]

    sd: Dict[str, torch.Tensor] = {}
    for path, spec in mapping_for(family).items():
        key, kind = spec[0], spec[1]
        if kind == "conv":
            sd[f"{key}.weight"] = _tensor(take(path).transpose(3, 2, 0, 1))
        elif kind == "conv_bias":
            sd[f"{key}.weight"] = _tensor(take(f"{path}/kernel").transpose(3, 2, 0, 1))
            sd[f"{key}.bias"] = _tensor(take(f"{path}/bias"))
        elif kind == "dense":
            sd[f"{key}.weight"] = _tensor(take(f"{path}/kernel").T)
            sd[f"{key}.bias"] = _tensor(take(f"{path}/bias"))
        elif kind == "dense_nchw":
            c, h, w = spec[2]
            kernel = take(f"{path}/kernel")  # (h*w*c, out): rows in NHWC order
            out_f = kernel.shape[1]
            weight = kernel.T.reshape(out_f, h, w, c).transpose(0, 3, 1, 2)
            sd[f"{key}.weight"] = _tensor(weight.reshape(out_f, c * h * w))
            sd[f"{key}.bias"] = _tensor(take(f"{path}/bias"))
        elif kind == "bn":
            mod = path[len("params/"):]
            sd[f"{key}.weight"] = _tensor(take(f"params/{mod}/scale"))
            sd[f"{key}.bias"] = _tensor(take(f"params/{mod}/bias"))
            sd[f"{key}.running_mean"] = _tensor(take(f"batch_stats/{mod}/mean"))
            sd[f"{key}.running_var"] = _tensor(take(f"batch_stats/{mod}/var"))
            sd[f"{key}.num_batches_tracked"] = torch.tensor(0)
        elif kind == "raw":
            sd[key] = _tensor(take(path))
        else:
            raise ValueError(f"unknown kind {kind!r} for {path}")
    unused = sorted(set(flat) - used)
    if unused:
        raise ValueError(f"{family}: JAX leaves not mapped: {unused[:8]}")
    return sd


def init_state(family: str, seed: int, num_outputs: int = 4) -> Dict[str, torch.Tensor]:
    """Seeded full-width state_dict: conv and linear weights N(0, 1/fan_in),
    biases 0, BatchNorm identity (weight 1, bias 0, mean 0, var 1), PReLU
    slopes 0.25 -- flax's default initializers, drawn from numpy."""
    rng = np.random.default_rng(seed)
    model = build_model(family, num_outputs)
    sd: Dict[str, torch.Tensor] = {}
    for name, module in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            shape = tuple(module.weight.shape)
            fan_in = int(np.prod(shape[1:]))
            w = rng.standard_normal(shape, dtype=np.float32) / np.float32(np.sqrt(fan_in))
            sd[f"{prefix}weight"] = _tensor(w)
            if module.bias is not None:
                sd[f"{prefix}bias"] = torch.zeros(shape[0])
        elif isinstance(module, nn.modules.batchnorm._BatchNorm):
            n = module.num_features
            sd[f"{prefix}weight"] = torch.ones(n)
            sd[f"{prefix}bias"] = torch.zeros(n)
            sd[f"{prefix}running_mean"] = torch.zeros(n)
            sd[f"{prefix}running_var"] = torch.ones(n)
            sd[f"{prefix}num_batches_tracked"] = torch.tensor(0)
        elif isinstance(module, nn.PReLU):
            sd[f"{prefix}weight"] = torch.full((module.num_parameters,), 0.25)
    return sd


def load_model(family: str, state_dict: Dict[str, torch.Tensor]) -> nn.Module:
    """Build a family's module and load a complete state_dict into it (a
    classifier takes its number of outputs from ``fc.weight``)."""
    num_outputs = 4
    if family == "resnet18_classifier":
        num_outputs = int(state_dict["fc.weight"].shape[0])
    model = build_model(family, num_outputs)
    model.load_state_dict(state_dict, strict=True)
    return model


def state_dict_from_biubug6(family: str, state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's state_dict from a biubug6 Pytorch_Retinaface checkpoint
    (``Resnet50_Final.pth`` for ``retinaface_resnet50``).

    Keys may carry DataParallel's ``module.`` prefix.  The R50's 7x7/s2
    ``body.conv1`` (64, 3, 7, 7) becomes the s2d (64, 12, 4, 4) kernel; every
    other tensor keeps its key.  Raises on a missing or an extra key.
    """
    if family != "retinaface_resnet50":
        raise ValueError(f"state_dict_from_biubug6 loads retinaface_resnet50, not {family!r}")
    sd = {
        (k[len("module."):] if k.startswith("module.") else k): torch.as_tensor(np.asarray(v))
        for k, v in state_dict.items()
    }
    stem = sd["body.conv1.weight"].numpy()
    if stem.shape[1:] == (3, 7, 7):
        hwio = stem_to_s2d(stem.transpose(2, 3, 1, 0))
        sd["body.conv1.weight"] = _tensor(hwio.transpose(3, 2, 0, 1))
    want = build_model(family).state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise ValueError(f"{family}: missing keys {missing[:8]}, extra keys {extra[:8]}")
    for k, v in want.items():
        if tuple(sd[k].shape) != tuple(v.shape):
            raise ValueError(f"{family}: {k} has shape {tuple(sd[k].shape)}, want {tuple(v.shape)}")
        sd[k] = sd[k].to(v.dtype)
    return sd
