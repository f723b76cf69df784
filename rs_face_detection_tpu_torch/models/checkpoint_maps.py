"""Import maps for public PyTorch checkpoints of RetinaFace and ArcFace.

Counterpart of rs_face_detection_tpu/models/checkpoint_maps.py.  The port's
modules carry the public key layouts already, so an import is a key check
and, for one tensor, a conversion:

  - RetinaFace-MobileNet0.25 and RetinaFace-R50 in the biubug6
    ``Pytorch_Retinaface`` layout (``mobilenet0.25_Final.pth``,
    ``Resnet50_Final.pth``): every key as it is, but the R50's 7x7/s2
    ``body.conv1`` (64, 3, 7, 7), which becomes the s2d stem's (64, 12, 4, 4)
    kernel exactly (models/resnet.py::stem_to_s2d);
  - ArcFace IResNet in the insightface ``arcface_torch`` layout
    (``backbone.pth``): every key as it is (the port's ``fc`` flattens NCHW,
    as torch does).

Keys may carry DataParallel's ``module.`` prefix.  A missing key always
raises; ``strict`` also raises on keys the module does not consume, as the
JAX package's maps do.  ``num_batches_tracked`` is neither required nor
reported.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from .arcface import STAGES as IRESNET_STAGES
from .arcface import IResNet
from .resnet import stem_to_s2d
from .retinaface import RetinaFace

#: BatchNorm's step counter: carried by some checkpoints, used by none.
_IGNORED_SUFFIX = "num_batches_tracked"


def strip_module_prefix(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop a leading 'module.' (DataParallel artifact) from every key."""
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in state_dict.items()}


def match_state_dict(
    template: nn.Module, state_dict: Mapping[str, Any], name: str, strict: bool = True
) -> Dict[str, torch.Tensor]:
    """The template module's state_dict filled from ``state_dict`` (numpy or
    torch values): raises on a missing key or a shape that differs, and with
    ``strict`` on a key the module does not consume.  Values take the
    template's dtype."""
    want = template.state_dict()
    missing = sorted(k for k in want if k not in state_dict and not k.endswith(_IGNORED_SUFFIX))
    extra = sorted(k for k in state_dict if k not in want and not k.endswith(_IGNORED_SUFFIX))
    if missing or (strict and extra):
        raise ValueError(f"{name}: missing keys {missing[:8]}, extra keys {extra[:8] if strict else []}")
    out: Dict[str, torch.Tensor] = {}
    for key, ref in want.items():
        if key not in state_dict:  # num_batches_tracked only
            out[key] = ref
            continue
        value = torch.as_tensor(np.asarray(state_dict[key]))
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: {key} has shape {tuple(value.shape)}, want {tuple(ref.shape)}")
        out[key] = value.to(ref.dtype)
    return out


def load_retinaface_state_dict(
    state_dict: Mapping[str, Any], backbone: str, strict: bool = True
) -> Dict[str, torch.Tensor]:
    """A biubug6 RetinaFace state_dict as the port's RetinaFace(backbone)
    state_dict.  The R50's stem may come as the public 7x7 kernel or as the
    s2d kernel already."""
    sd = dict(strip_module_prefix(state_dict))
    if backbone == "resnet50" and "body.conv1.weight" in sd:
        stem = np.asarray(sd["body.conv1.weight"], np.float32)
        if stem.shape[1:] == (3, 7, 7):
            sd["body.conv1.weight"] = stem_to_s2d(stem.transpose(2, 3, 1, 0)).transpose(3, 2, 0, 1)
    return match_state_dict(RetinaFace(backbone), sd, f"retinaface_{backbone}", strict)


def load_iresnet_state_dict(
    state_dict: Mapping[str, Any], depth: str = "iresnet50", strict: bool = True
) -> Dict[str, torch.Tensor]:
    """An insightface arcface_torch ``backbone.pth`` as the port's IResNet
    state_dict (the embedding size read from ``fc.weight``)."""
    if depth not in IRESNET_STAGES:
        raise ValueError(f"unknown IResNet depth {depth!r} (one of {sorted(IRESNET_STAGES)})")
    sd = strip_module_prefix(state_dict)
    dim = int(np.asarray(sd["fc.weight"]).shape[0]) if "fc.weight" in sd else 512
    return match_state_dict(IResNet(depth, dim), sd, depth, strict)
