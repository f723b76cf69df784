"""Weights for a configuration: seeded on the device, or read from a file.

Every model's state_dict is made in its published key layout (the
reference's, benchmark/reference/models.py), once per run, and handed
as it is to both sides: the reference loads it, and benchmark/port.py
loads it into the program's modules.

Seeded weights come from one ``torch.Generator`` on the run's device and a
few large calls per model, in the type they are served in (float32): conv
and linear weights N(0, 1/fan_in); linear and conv biases N(0, 0.01^2);
BatchNorm weight and running variance U(0.75, 1.25), bias and running mean
U(-0.1, 0.1), except the weight of a residual branch's last BatchNorm
(``bn3``), U(0.1, 0.3), as a residual initialised near zero (Goyal et al.,
"Accurate, Large Minibatch SGD") keeps a deep random network's output
from hanging on float32 rounding; PReLU slopes U(0.1, 0.4).  BatchNorm is not the identity, so
that a program which folds or skips it wrongly disagrees with the reference.

A seeded network whose BatchNorm statistics are not calibrated sends raw
0-255 pixels through 50 layers at a growing scale: its detector's scores
saturate and its box deltas overflow.  ``{"seeded": {"calibrate": true,
"candidates_per_image": n}}`` makes it behave like a trained network in
eval mode: each BatchNorm's running mean and variance are set, in forward
order, to the statistics of its input over a calibration batch (forward
pre-hooks, float32 on the device), and a detector's class heads get one
bias shift, the same for every anchor, that lets n anchors of the median
calibration image pass the confidence threshold: a prior on the face probability, as
RetinaNet's classification head has one (Lin et al., "Focal Loss for Dense
Object Detection"), set from the data so that every seed's detector finds
about as many candidates.

A file entry reads a RetinaFace MobileNet-0.25 ``.npz`` in the JAX
package's registry layout ('/'-joined flax paths, float16 or float32
leaves) through a frozen copy of its layout map.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from .reference import models as ref_models


def _meta_model(spec: dict) -> nn.Module:
    with torch.device("meta"):
        return ref_models.build(spec)


def seeded_state(spec: dict, gen: torch.Generator, device: torch.device) -> Dict[str, torch.Tensor]:
    """A state_dict for the network ``spec`` names, drawn from ``gen``."""
    model = _meta_model(spec)
    weights: List[Tuple[str, tuple, int]] = []
    biases: List[Tuple[str, tuple]] = []
    norms: List[Tuple[str, int]] = []
    slopes: List[Tuple[str, int]] = []
    for name, mod in model.named_modules():
        p = f"{name}." if name else ""
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            shape = tuple(mod.weight.shape)
            weights.append((f"{p}weight", shape, int(np.prod(shape[1:]))))
            if mod.bias is not None:
                biases.append((f"{p}bias", tuple(mod.bias.shape)))
        elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
            norms.append((p, mod.num_features))
        elif isinstance(mod, nn.PReLU):
            slopes.append((f"{p}weight", mod.num_parameters))
    sd: Dict[str, torch.Tensor] = {}
    flat = torch.randn(sum(int(np.prod(s)) for _, s, _ in weights), generator=gen, device=device)
    off = 0
    for key, shape, fan_in in weights:
        n = int(np.prod(shape))
        sd[key] = (flat[off: off + n] * (1.0 / np.sqrt(fan_in))).reshape(shape)
        off += n
    if biases:
        flat = torch.randn(sum(int(np.prod(s)) for _, s in biases), generator=gen, device=device) * 0.01
        off = 0
        for key, shape in biases:
            n = int(np.prod(shape))
            sd[key] = flat[off: off + n].reshape(shape)
            off += n
    total = sum(n for _, n in norms)
    u = torch.rand((4, total), generator=gen, device=device)
    off = 0
    for p, n in norms:
        # the last BatchNorm of a residual branch starts small, as in a
        # zero-initialised residual, so that the stream stays near identity
        lo, width = (0.1, 0.2) if p.endswith("bn3.") else (0.75, 0.5)
        sd[f"{p}weight"] = lo + width * u[0, off: off + n]
        sd[f"{p}bias"] = 0.2 * u[1, off: off + n] - 0.1
        sd[f"{p}running_mean"] = 0.2 * u[2, off: off + n] - 0.1
        sd[f"{p}running_var"] = 0.75 + 0.5 * u[3, off: off + n]
        sd[f"{p}num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)
        off += n
    if slopes:
        u = torch.rand(sum(n for _, n in slopes), generator=gen, device=device)
        off = 0
        for key, n in slopes:
            sd[key] = 0.1 + 0.3 * u[off: off + n]
            off += n
    return {k: v.contiguous() for k, v in sd.items()}


# -- the JAX package's registry layout of the RetinaFace MobileNet-0.25 ------
# A frozen copy of the layout map (flax module path -> biubug6 torch key).


def _flax_retinaface_mnet_map() -> Dict[str, Tuple[str, str]]:
    m: Dict[str, Tuple[str, str]] = {}

    def conv_bn(flax: str, key: str) -> None:
        m[f"{flax}/Conv_0"] = (f"{key}.0", "conv")
        m[f"{flax}/BatchNorm_0"] = (f"{key}.1", "bn")

    def conv_dw(flax: str, key: str) -> None:
        m[f"{flax}/dw/Conv_0"] = (f"{key}.0", "conv")
        m[f"{flax}/dw/BatchNorm_0"] = (f"{key}.1", "bn")
        m[f"{flax}/pw/Conv_0"] = (f"{key}.3", "conv")
        m[f"{flax}/pw/BatchNorm_0"] = (f"{key}.4", "bn")

    conv_bn("body/conv1", "body.stage1.0")
    for i in range(1, 6):
        conv_dw(f"body/ds{i}", f"body.stage1.{i}")
    for i in range(6):
        conv_dw(f"body/ds{6 + i}", f"body.stage2.{i}")
    for i in range(2):
        conv_dw(f"body/ds{12 + i}", f"body.stage3.{i}")
    for i, name in enumerate(("output1", "output2", "output3")):
        conv_bn(f"fpn/lateral{i}", f"fpn.{name}")
    conv_bn("fpn/merge0", "fpn.merge1")
    conv_bn("fpn/merge1", "fpn.merge2")
    for i in range(3):
        t = f"ssh{i + 1}"
        for flax, key in (("conv3", "conv3X3"), ("conv5_1", "conv5X5_1"), ("conv5_2", "conv5X5_2"),
                          ("conv7_1", "conv7X7_2"), ("conv7_2", "conv7x7_3")):
            conv_bn(f"ssh{i}/{flax}", f"{t}.{key}")
        m[f"cls{i}"] = (f"ClassHead.{i}.conv1x1", "conv_bias")
        m[f"box{i}"] = (f"BboxHead.{i}.conv1x1", "conv_bias")
        m[f"ldm{i}"] = (f"LandmarkHead.{i}.conv1x1", "conv_bias")
    return m


def file_state(path: str, device: torch.device) -> Dict[str, torch.Tensor]:
    """A state_dict from an ``.npz`` of the mnet in the JAX package's layout;
    raises if a leaf of the file is left unused."""
    with np.load(path) as data:
        flat = {k: np.asarray(data[k], np.float32) for k in data.files}
    used = set()

    def take(k: str) -> torch.Tensor:
        used.add(k)
        return torch.from_numpy(flat[k])

    sd: Dict[str, torch.Tensor] = {}
    for flax, (key, kind) in _flax_retinaface_mnet_map().items():
        if kind == "conv":
            sd[f"{key}.weight"] = take(f"params/{flax}/kernel").permute(3, 2, 0, 1)
        elif kind == "conv_bias":
            sd[f"{key}.weight"] = take(f"params/{flax}/kernel").permute(3, 2, 0, 1)
            sd[f"{key}.bias"] = take(f"params/{flax}/bias")
        else:
            sd[f"{key}.weight"] = take(f"params/{flax}/scale")
            sd[f"{key}.bias"] = take(f"params/{flax}/bias")
            sd[f"{key}.running_mean"] = take(f"batch_stats/{flax}/mean")
            sd[f"{key}.running_var"] = take(f"batch_stats/{flax}/var")
            sd[f"{key}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    unused = sorted(set(flat) - used)
    if unused:
        raise ValueError(f"{path}: leaves not mapped: {unused[:6]}")
    return {k: v.contiguous().to(device) for k, v in sd.items()}


def calibrate(spec: dict, sd: Dict[str, torch.Tensor], x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``sd`` with every BatchNorm's running statistics taken from its input
    on the network input ``x`` (NCHW float32), layer after layer."""
    net = ref_models.build(spec).to(x.device).eval()
    net.load_state_dict(sd, strict=True)

    def pre(mod, args):
        dims = (0, 2, 3) if args[0].dim() == 4 else (0,)
        var, mean = torch.var_mean(args[0].float(), dim=dims, unbiased=False)
        mod.running_mean.copy_(mean)
        mod.running_var.copy_(var)

    for mod in net.modules():
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            mod.register_forward_pre_hook(pre)
    with torch.no_grad():
        net(x)
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def candidate_prior(spec: dict, sd: Dict[str, torch.Tensor], x: torch.Tensor, per_image: int) -> None:
    """Shift the face logit of every class head so that the median
    calibration image has ``per_image`` anchors at or above the threshold."""
    net = ref_models.build(spec).to(x.device).eval()
    net.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = net(x)
    logits = torch.cat([out[s][0] for s in out], 1)
    d = logits[..., 1] - logits[..., 0]
    # the median image's per_image-th best anchor lands on the threshold
    q = torch.median(torch.topk(d, per_image, dim=1).values[:, -1]).item()
    thr = spec["confidence_threshold"]
    shift = float(np.log(thr / (1.0 - thr))) - q
    for key in [k for k in sd if k.startswith("ClassHead.") and k.endswith(".bias")]:
        b = sd[key].clone().reshape(-1, 2)
        b[:, 1] += shift
        sd[key] = b.reshape(-1)


def model_state(spec: dict, gen: torch.Generator, device: torch.device, root: str,
                calibration=None) -> Dict[str, torch.Tensor]:
    """A configuration's model entry: ``"weights": "seeded"``,
    ``{"seeded": {"calibrate": bool, "candidates_per_image": n}}`` (``calibration``:
    the network input to calibrate on) or ``{"file": <path under the
    checkout>}``."""
    w = spec["weights"]
    if w == "seeded":
        return seeded_state(spec, gen, device)
    if "seeded" in w:
        sd = seeded_state(spec, gen, device)
        if w["seeded"].get("calibrate"):
            sd = calibrate(spec, sd, calibration)
        if w["seeded"].get("candidates_per_image"):
            candidate_prior(spec, sd, calibration, w["seeded"]["candidates_per_image"])
        return sd
    return file_state(os.path.join(root, w["file"]), device)


def stem_to_s2d(kernel: torch.Tensor) -> torch.Tensor:
    """A (F, C, 7, 7) stride-2 pad-3 kernel as the (F, 4C, 4, 4) kernel of the
    stride-1 conv on the 2x2 space-to-depth input padded (2, 1), channel
    (bi*2 + bj)*C + c: input row 2o - 3 + u is block o + (u - 3)//2, phase
    (u - 3) % 2.  The same function, exactly: each tap is copied once."""
    f, c, k, _ = kernel.shape
    p = k // 2
    lo = -min((u - p) // 2 for u in range(k))
    out = kernel.new_zeros((f, 4 * c, 4, 4))
    for u in range(k):
        a, bi = (u - p) // 2 + lo, (u - p) % 2
        for v in range(k):
            b, bj = (v - p) // 2 + lo, (v - p) % 2
            ch = (bi * 2 + bj) * c
            out[:, ch: ch + c, a, b] = kernel[:, :, u, v]
    return out


def calibration_inputs(cfg: dict, pool, device: torch.device, n: int = 16) -> Dict[str, torch.Tensor]:
    """Each network's calibration batch: the detector's input of the first
    ``n`` pooled images (letterboxed, RGB, the configuration's pixel
    normalization), and each head's input of the face crop resized to its
    size at 8 brightness levels."""
    import cv2

    from .images import face_crop
    from .reference.pipeline import letterbox

    d = cfg["detector"]
    w, h = d["image_size"]
    canv = np.stack([letterbox(cv2.imdecode(np.frombuffer(j, np.uint8), cv2.IMREAD_COLOR), w, h)[0]
                     for j in pool[:n]])
    x = torch.from_numpy(canv).to(device).float().flip(-1)
    mean, std = torch.tensor(d["pixel_means"], device=device), torch.tensor(d["pixel_stds"], device=device)
    out = {"detector": ((x / d["pixel_scale"] - mean) / std).permute(0, 3, 1, 2).contiguous()}
    for part in ("quality", "identification"):
        c = cfg[part]
        face = cv2.resize(face_crop(), tuple(c["image_size"]), interpolation=cv2.INTER_LINEAR).astype(np.float32)
        f = torch.from_numpy(np.stack([np.clip(face * s, 0, 255) for s in np.linspace(0.7, 1.2, 8)]).astype(np.float32))
        f = (f.to(device).flip(-1) - torch.tensor(c["mean"], device=device)) * torch.tensor(c["scale"], device=device)
        out[part] = f.permute(0, 3, 1, 2).contiguous()
    return out


def make_states(cfg: dict, seed: int, device: torch.device, root: str, pool) -> Dict[str, Dict[str, torch.Tensor]]:
    """The three networks' state_dicts of a configuration for ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    calib = calibration_inputs(cfg, pool, device)
    return {part: model_state(cfg[part], gen, device, root, calib[part])
            for part in ("detector", "quality", "identification")}
