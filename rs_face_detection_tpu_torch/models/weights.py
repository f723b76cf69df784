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
    GroupNorm and LayerNorm scale/bias -> weight/bias;
  - the ViT's attention: flax keeps ``query``, ``key`` and ``value``
    kernels of shape (W, H, D) with (H, D) biases and an ``out`` kernel of
    shape (H, D, W); they pack into ``in_proj_weight`` (3W, W) in the order
    q, k, v and ``out_proj`` (the inverse of models/clip_import.py);
  - float16 leaves (``trained_real640.npz`` is stored in float16) become
    float32.

``init_state`` gives a full-width state_dict from ``numpy.random.default_rng``
with the distributions of flax's default initializers (the bits differ), for
machines that hold no checkpoint and no JAX.

A weight-only int8 tree (``FaceExtraction(quantized=True).variables``,
whose quantized kernels are ``.../kernel/::q`` int8 and ``.../kernel/::s``
leaves) bridges to the int8 modules of models/quantized.py: the same layout
maps move q (HWIO -> OIHW; ``fc``'s NHWC rows to NCHW, kept as (K, N)), s
stays one f32 per output channel, and int8 stays int8.

A calibrated int8-activation RetinaFace tree (JAX ops/quantize.py::
quantize_retinaface: ``params/<mod>/Conv_0/kernel_q`` int8 HWIO,
``.../kernel_scale`` and ``quant_stats/<mod>/amax``) bridges to the
Int8ActConv2d modules of models/quantized.py: ``weight_q`` (OIHW),
``weight_scale`` and ``amax``; ``flax_from_state_dict`` writes it back.

Public PyTorch checkpoints (biubug6 ``Resnet50_Final.pth`` and the other
public layouts) load through models/checkpoint_maps.py and
models/checkpoint_io.py; ``flax_from_state_dict`` is the bridge turned
round, which writes the JAX package's registry ``.npz``
(``save_flax_checkpoint``: the trainer's export).
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from .arcface import FC_GRID, STAGES, IResNet
from .classifiers import ResNet18Classifier
from .minifas import (
    MiniFASNet,
    MiniFASNetSpec,
    default_minifas_spec,
    minifasnet_map,
    minifasnet_spec_from_state_dict,
)
from .quantized import quantize_activations, quantize_module
from .resnet import STAGES as RESNET50_STAGES
from .retinaface import RetinaFace
from .scrfd import SCRFD
from .vit import CONFIGS as VIT_CONFIGS
from .vit import ViT

#: The model families the bridge and the seeded init know.
FAMILIES = (
    "retinaface_mobilenet025",
    "retinaface_resnet50",
    *STAGES,
    "resnet18_classifier",
    "scrfd",
    "minifasnet",
    *VIT_CONFIGS,
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


def scrfd_map() -> Dict[str, Tuple]:
    """{flax path: (torch key, kind)} of models/scrfd.py's SCRFD."""
    m: Dict[str, Tuple] = {}
    _conv_bn(m, "stem1", "stem1")
    _conv_bn(m, "stem2", "stem2")
    for block in ("s3a", "s3b", "s4a", "s4b", "s5a", "s5b"):
        _conv_bn(m, f"{block}/c1", f"{block}.c1")
        _conv_bn(m, f"{block}/c2", f"{block}.c2")
        if block.endswith("a"):  # the stride-2 blocks change width: a projection
            _conv_bn(m, f"{block}/proj", f"{block}.proj")
    for i in range(3):
        _conv_bn(m, f"neck/lat{i}", f"neck.lat{i}")
    for i in range(2):
        _conv_bn(m, f"neck/td{i}", f"neck.td{i}")
        _conv_bn(m, f"neck/bu{i + 1}", f"neck.bu{i + 1}")
        m[f"params/head/tower{i}/kernel"] = (f"head.tower{i}", "conv")
        m[f"params/head/gn{i}"] = (f"head.gn{i}", "norm")
    for name in ("cls", "bbox", "kps"):
        m[f"params/head/{name}"] = (f"head.{name}", "conv_bias")
    return m


def vit_map(config: str) -> Dict[str, Tuple]:
    """{flax path: (torch key, kind)} of models/vit.py's ViT for a config:
    the inverse of the JAX package's models/clip_import.py."""
    cfg = VIT_CONFIGS[config]
    m: Dict[str, Tuple] = {
        "params/cls": ("class_embedding", "flat"),
        "params/pos_embed": ("positional_embedding", "squeeze0"),
        "params/ln_final": ("ln_post", "norm"),
        "params/head": ("head", "dense"),
    }
    if cfg.pre_ln:  # CLIP: ln_pre, and a patchify conv without bias
        m["params/ln_pre"] = ("ln_pre", "norm")
        m["params/patchify/kernel"] = ("conv1", "conv")
    else:
        m["params/patchify"] = ("conv1", "conv_bias")
    if cfg.proj_dim:
        m["params/proj/kernel"] = ("proj", "raw")
    for i in range(cfg.depth):
        t, f = f"transformer.resblocks.{i}", f"params/block{i}"
        m[f"{f}/ln1"] = (f"{t}.ln_1", "norm")
        m[f"{f}/ln2"] = (f"{t}.ln_2", "norm")
        m[f"{f}/attn"] = (f"{t}.attn", "attention", cfg.heads)
        m[f"{f}/fc1"] = (f"{t}.mlp.c_fc", "dense")
        m[f"{f}/fc2"] = (f"{t}.mlp.c_proj", "dense")
    return m


def mapping_for(family: str, spec: MiniFASNetSpec | None = None) -> Dict[str, Tuple]:
    """A family's map; a MiniFASNet's depends on its ``spec``."""
    if family == "minifasnet":
        if spec is None:
            raise ValueError("the minifasnet map needs the network's spec")
        return minifasnet_map(spec)
    if family == "scrfd":
        return scrfd_map()
    if family in VIT_CONFIGS:
        return vit_map(family)
    if family == "retinaface_mobilenet025":
        return retinaface_mobilenet025_map()
    if family == "retinaface_resnet50":
        return retinaface_resnet50_map()
    if family in STAGES:
        return iresnet_map(family)
    if family == "resnet18_classifier":
        return resnet18_classifier_map()
    raise ValueError(f"unknown family {family!r} (one of {FAMILIES})")


def leaves_of(path: str, kind: str) -> Tuple[str, ...]:
    """The flax leaves one map entry reads, in the order state_dict_from_jax
    takes them: the loader reads every leaf through this function, so it
    and the coverage of ``mapped_leaves`` cannot disagree."""
    if kind in ("conv", "raw", "flat", "squeeze0", "dense_nobias"):
        return (path,)
    if kind in ("conv_bias", "dense", "dense_nchw"):
        return (f"{path}/kernel", f"{path}/bias")
    if kind == "norm":
        return (f"{path}/scale", f"{path}/bias")
    if kind == "bn":
        mod = path[len("params/"):]
        return (
            f"params/{mod}/scale", f"params/{mod}/bias",
            f"batch_stats/{mod}/mean", f"batch_stats/{mod}/var",
        )
    if kind == "attention":
        return tuple(
            f"{path}/{proj}/{leaf}"
            for proj in ("query", "key", "value", "out")
            for leaf in ("kernel", "bias")
        )
    raise ValueError(f"unknown kind {kind!r} for {path}")


def mapped_leaves(family: str) -> set:
    """Every flax leaf the family's map reads (shapes are not needed)."""
    return {
        leaf for path, spec in mapping_for(family).items() for leaf in leaves_of(path, spec[1])
    }


def build_model(
    family: str, num_outputs: int = 4, image_size: int = 224, softmax: bool = True
) -> nn.Module:
    """The port's module for a family, in eval mode, on the CPU (a ViT for
    ``image_size`` square inputs; SCRFD at width 32, neck 32; a MiniFASNet of
    ``default_minifas_spec`` at ``image_size``).  ``softmax`` applies to the
    ResNet-18 classifier and the MiniFASNet."""
    if family == "scrfd":
        model = SCRFD()
    elif family == "minifasnet":
        spec = default_minifas_spec((image_size, image_size), num_classes=num_outputs)
        model = MiniFASNet(spec, softmax)
    elif family in VIT_CONFIGS:
        model = ViT(family, num_outputs, image_size)
    elif family in RETINAFACE:
        model = RetinaFace(RETINAFACE[family])
    elif family in STAGES:
        model = IResNet(family)
    elif family == "resnet18_classifier":
        model = ResNet18Classifier(num_outputs, softmax)
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


def _kernel(sd: Dict[str, torch.Tensor], key: str, kernel, to_torch) -> None:
    """A float kernel as ``key.weight`` = to_torch(kernel); a quantized one,
    a (q, s) pair, as ``key.weight_q`` (int8, the same map) and
    ``key.weight_scale`` (f32, one per output channel), and a (q, s, amax)
    triple also with ``key.amax``."""
    if isinstance(kernel, tuple):
        q, s = kernel[:2]
        sd[f"{key}.weight_q"] = torch.from_numpy(np.ascontiguousarray(to_torch(np.asarray(q, np.int8))))
        sd[f"{key}.weight_scale"] = _tensor(s.reshape(-1))
        if len(kernel) == 3:
            sd[f"{key}.amax"] = _tensor(np.asarray(kernel[2]).reshape(()))
    else:
        sd[f"{key}.weight"] = _tensor(to_torch(kernel))


def _hwio_to_oihw(k: np.ndarray) -> np.ndarray:
    return k.transpose(3, 2, 0, 1)


def state_dict_from_jax(
    family: str, source: Any, spec: MiniFASNetSpec | None = None, mapping: Mapping[str, Tuple] | None = None
) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a family from JAX variables or an .npz
    (``spec``: a MiniFASNet's architecture; ``mapping``: an explicit map,
    for the modules whose map depends on more than a family, such as
    models/scrfd_import.py's).  A quantized kernel gives the int8 modules'
    ``weight_q``/``weight_scale``.

    Raises if a JAX leaf goes unused, so a layout drift cannot pass silently.
    """
    flat = flat_variables(source)
    quant = {
        name[: -len("/::q")]: (flat.pop(name), flat.pop(name[: -len("/::q")] + "/::s"))
        for name in [n for n in flat if n.endswith("/::q")]
    }
    for name in [n for n in flat if n.endswith("/Conv_0/kernel_q")]:
        conv = name[: -len("/kernel_q")]  # params/<mod>/Conv_0
        stats = f"quant_stats/{conv[len('params/') : -len('/Conv_0')]}/amax"
        if f"{conv}/kernel_scale" not in flat or stats not in flat:
            raise ValueError(f"{family}: {name} without its kernel_scale or {stats}")
        quant[f"{conv}/kernel"] = (flat.pop(name), flat.pop(f"{conv}/kernel_scale"), flat.pop(stats))
    used = set()
    sd: Dict[str, torch.Tensor] = {}
    for path, entry in (mapping if mapping is not None else mapping_for(family, spec)).items():
        key, kind = entry[0], entry[1]
        names = leaves_of(path, kind)
        used.update(names)
        leaves = [quant[name] if name in quant else flat[name] for name in names]
        if kind == "conv":
            _kernel(sd, key, leaves[0], _hwio_to_oihw)
        elif kind == "conv_bias":
            kernel, bias = leaves
            _kernel(sd, key, kernel, _hwio_to_oihw)
            sd[f"{key}.bias"] = _tensor(bias)
        elif kind == "dense":
            kernel, bias = leaves
            sd[f"{key}.weight"] = _tensor(kernel.T)
            sd[f"{key}.bias"] = _tensor(bias)
        elif kind == "dense_nobias":
            sd[f"{key}.weight"] = _tensor(leaves[0].T)
        elif kind == "dense_nchw":
            c, h, w = entry[2]
            kernel, bias = leaves  # kernel (h*w*c, out): rows in NHWC order
            if isinstance(kernel, tuple):  # int8: (K, N) with the rows in NCHW order
                rows = lambda k: k.reshape(h, w, c, -1).transpose(2, 0, 1, 3).reshape(c * h * w, -1)  # noqa: E731
                _kernel(sd, key, kernel, rows)
            else:
                out_f = kernel.shape[1]
                weight = kernel.T.reshape(out_f, h, w, c).transpose(0, 3, 1, 2)
                sd[f"{key}.weight"] = _tensor(weight.reshape(out_f, c * h * w))
            sd[f"{key}.bias"] = _tensor(bias)
        elif kind == "bn":
            for suffix, leaf in zip(("weight", "bias", "running_mean", "running_var"), leaves):
                sd[f"{key}.{suffix}"] = _tensor(leaf)
            sd[f"{key}.num_batches_tracked"] = torch.tensor(0)
        elif kind == "raw":
            sd[key] = _tensor(leaves[0])
        elif kind == "flat":
            sd[key] = _tensor(leaves[0].reshape(-1))
        elif kind == "squeeze0":
            sd[key] = _tensor(leaves[0][0])
        elif kind == "norm":
            sd[f"{key}.weight"], sd[f"{key}.bias"] = (_tensor(leaf) for leaf in leaves)
        elif kind == "attention":
            # query, key, value: (W, H, D) kernels -> (H*D, W) rows, stacked
            # in that order, and (H, D) biases; out: (H, D, W) kernel.
            qk, qb, kk, kb, vk, vb, out, out_bias = leaves
            width = qk.shape[0]
            sd[f"{key}.in_proj_weight"] = _tensor(
                np.concatenate([kr.reshape(width, -1).T for kr in (qk, kk, vk)])
            )
            sd[f"{key}.in_proj_bias"] = _tensor(np.concatenate([b.reshape(-1) for b in (qb, kb, vb)]))
            sd[f"{key}.out_proj.weight"] = _tensor(out.reshape(-1, out.shape[-1]).T)
            sd[f"{key}.out_proj.bias"] = _tensor(out_bias)
    unused = sorted((set(flat) | set(quant)) - used)
    if unused:
        raise ValueError(f"{family}: JAX leaves not mapped: {unused[:8]}")
    return sd


def flax_from_state_dict(mapping: Mapping[str, Tuple], state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of state_dict_from_jax: '/'-joined float32 flax leaves from
    a float state_dict of the port, by a family's map (``mapping_for``).  An
    int8-activation conv (``weight_q``, ``weight_scale``, ``amax``) gives
    JAX's ``Conv_0/kernel_q`` (int8), ``Conv_0/kernel_scale`` and
    ``quant_stats/<mod>/amax``.  Raises if a tensor goes unused
    (``num_batches_tracked`` aside)."""
    sd = {
        k: v.detach().cpu().numpy() if v.dtype == torch.int8 else v.detach().cpu().float().numpy()
        for k, v in state_dict.items()
    }
    used = set()
    flat: Dict[str, np.ndarray] = {}

    def take(key: str) -> np.ndarray:
        used.add(key)
        return sd[key]

    for path, entry in mapping.items():
        key, kind = entry[0], entry[1]
        names = leaves_of(path, kind)
        if kind == "conv" and f"{key}.amax" in sd:
            conv = path[: -len("/kernel")]  # params/<mod>/Conv_0
            names = (f"{conv}/kernel_q", f"{conv}/kernel_scale",
                     f"quant_stats/{conv[len('params/') : -len('/Conv_0')]}/amax")
            values = [take(f"{key}.weight_q").transpose(2, 3, 1, 0), take(f"{key}.weight_scale"),
                      take(f"{key}.amax")]
        elif kind == "conv":
            values = [take(f"{key}.weight").transpose(2, 3, 1, 0)]
        elif kind == "conv_bias":
            values = [take(f"{key}.weight").transpose(2, 3, 1, 0), take(f"{key}.bias")]
        elif kind == "dense":
            values = [take(f"{key}.weight").T, take(f"{key}.bias")]
        elif kind == "dense_nobias":
            values = [take(f"{key}.weight").T]
        elif kind == "dense_nchw":
            c, h, w = entry[2]
            weight = take(f"{key}.weight")  # (out, c*h*w), NCHW order
            values = [weight.reshape(-1, c, h, w).transpose(0, 2, 3, 1).reshape(weight.shape[0], -1).T,
                      take(f"{key}.bias")]
        elif kind == "bn":
            values = [take(f"{key}.{s}") for s in ("weight", "bias", "running_mean", "running_var")]
        elif kind == "raw":
            values = [take(key)]
        elif kind == "flat":
            values = [take(key).reshape(1, 1, -1)]
        elif kind == "squeeze0":
            values = [take(key)[None]]
        elif kind == "norm":
            values = [take(f"{key}.weight"), take(f"{key}.bias")]
        elif kind == "attention":
            heads = entry[2]
            in_w, in_b = take(f"{key}.in_proj_weight"), take(f"{key}.in_proj_bias")
            out_w = take(f"{key}.out_proj.weight")  # (W, W): out = o @ out_w.T
            width = in_w.shape[1]
            values = []
            for j in range(3):  # query, key, value
                values.append(in_w[j * width : (j + 1) * width].T.reshape(width, heads, -1))
                values.append(in_b[j * width : (j + 1) * width].reshape(heads, -1))
            values += [out_w.T.reshape(heads, -1, width), take(f"{key}.out_proj.bias")]
        else:
            raise ValueError(f"unknown kind {kind!r} for {path}")
        flat.update(zip(names, (np.array(v, dtype=np.int8 if v.dtype == np.int8 else np.float32) for v in values)))
    unused = sorted(k for k in sd if k not in used and not k.endswith("num_batches_tracked"))
    if unused:
        raise ValueError(f"state_dict tensors not mapped: {unused[:8]}")
    return flat


def save_flax_checkpoint(path: str, family: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Write a float state_dict of a family as the JAX package's registry
    .npz (its models/registry.py::save_variables of ``params`` and
    ``batch_stats`` in flax's layout), which JAX's ``RetinaFaceDetection``
    and the port's registry both serve: the trainer's export
    (parallel/train.py::TrainState.export_state_dict)."""
    from .registry import save_variables

    save_variables(path, flax_from_state_dict(mapping_for(family), state_dict))


def init_state(
    family: str, seed: int, num_outputs: int = 4, image_size: int = 224
) -> Dict[str, torch.Tensor]:
    """Seeded full-width state_dict: conv and linear weights N(0, 1/fan_in),
    biases 0, BatchNorm identity (weight 1, bias 0, mean 0, var 1), Group-
    and LayerNorm weight 1 and bias 0, PReLU slopes 0.25, a ViT's packed qkv
    and ``proj`` N(0, 1/fan_in) and its CLS token and position embedding
    N(0, 0.02^2) -- flax's default initializers and the ViT's own, drawn
    from numpy.  ``image_size``: a ViT's or a MiniFASNet's input size."""
    return seeded_state(build_model(family, num_outputs, image_size), seed)


def seeded_state(model: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """``init_state``'s distributions for any module built of these layers
    (models/heads.py's SmallCNN, models/scrfd_import.py's network)."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, torch.Tensor] = {}

    def normal(shape, fan_in: int) -> torch.Tensor:
        return _tensor(rng.standard_normal(shape, dtype=np.float32) / np.float32(np.sqrt(fan_in)))

    for name, module in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            shape = tuple(module.weight.shape)
            sd[f"{prefix}weight"] = normal(shape, int(np.prod(shape[1:])))
            if module.bias is not None:
                sd[f"{prefix}bias"] = torch.zeros(shape[0])
        elif isinstance(module, (nn.GroupNorm, nn.LayerNorm)):
            sd[f"{prefix}weight"] = torch.ones_like(module.weight)
            sd[f"{prefix}bias"] = torch.zeros_like(module.bias)
        elif isinstance(module, nn.modules.batchnorm._BatchNorm):
            n = module.num_features
            sd[f"{prefix}weight"] = torch.ones(n)
            sd[f"{prefix}bias"] = torch.zeros(n)
            sd[f"{prefix}running_mean"] = torch.zeros(n)
            sd[f"{prefix}running_var"] = torch.ones(n)
            sd[f"{prefix}num_batches_tracked"] = torch.tensor(0)
        elif isinstance(module, nn.PReLU):
            sd[f"{prefix}weight"] = torch.full((module.num_parameters,), 0.25)
    for name, param in model.named_parameters():  # the ViT's own parameters
        if name in sd:
            continue
        shape = tuple(param.shape)
        if name.endswith("in_proj_bias"):
            sd[name] = torch.zeros(shape)
        elif name.endswith("in_proj_weight"):
            sd[name] = normal(shape, shape[1])
        elif name == "proj":  # applied as x @ proj
            sd[name] = normal(shape, shape[0])
        elif name in ("class_embedding", "positional_embedding"):
            sd[name] = _tensor(rng.normal(0.0, 0.02, size=shape).astype(np.float32))
        elif name.endswith(".scale"):  # an mmdet Scale: 1, as flax's ones initializer
            sd[name] = torch.ones(shape)
        else:
            raise ValueError(f"{type(model).__name__}: no initializer for {name}")
    return sd


def load_model(family: str, state_dict: Dict[str, torch.Tensor], softmax: bool = True) -> nn.Module:
    """Build a family's module and load a complete state_dict into it.

    A classifier takes its number of outputs from ``fc.weight``, a ViT from
    ``head.weight`` and its input size from ``positional_embedding``, SCRFD
    its backbone and neck widths from its first convs, a MiniFASNet its whole
    architecture from the shapes.  A state_dict with ``weight_q`` leaves (a
    bridged int8 tree) loads into the int8 form of the module: the
    int8-activation form where it has ``amax`` leaves, else the weight-only
    one.  ``softmax``
    applies to the ResNet-18 classifier and the MiniFASNet.
    """
    if family == "minifasnet":
        model = MiniFASNet(minifasnet_spec_from_state_dict(state_dict), softmax).eval()
    elif family == "scrfd":
        width = int(state_dict["stem1.0.weight"].shape[0])
        model = SCRFD(width, int(state_dict["neck.lat0.0.weight"].shape[0])).eval()
    elif family in VIT_CONFIGS:
        grid = math.isqrt(int(state_dict["positional_embedding"].shape[0]) - 1)
        num_classes = int(state_dict["head.weight"].shape[0])
        model = build_model(family, num_classes, grid * VIT_CONFIGS[family].patch)
    else:
        num_outputs = 4
        if family == "resnet18_classifier":
            num_outputs = int(state_dict["fc.weight"].shape[0])
        model = build_model(family, num_outputs, softmax=softmax)
    if any(k.endswith(".amax") for k in state_dict):
        quantize_activations(model)
    elif any(k.endswith(".weight_q") for k in state_dict):
        quantize_module(model)
    model.load_state_dict(state_dict, strict=True)
    return model
