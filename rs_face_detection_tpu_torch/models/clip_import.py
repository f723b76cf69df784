"""OpenAI CLIP visual towers into the port's ViT.

Counterpart of rs_face_detection_tpu/models/clip_import.py.  Public CLIP
checkpoints carry the visual tower under ``visual.`` (``conv1``,
``class_embedding``, ``positional_embedding``, ``ln_pre``,
``transformer.resblocks.{i}.{ln_1,attn.in_proj_*,attn.out_proj,ln_2,
mlp.c_fc,mlp.c_proj}``, ``ln_post``, ``proj``) beside the text tower, which
a visual-only import ignores.  The port's ViT (models/vit.py) has those
names without the prefix and packs q, k and v as CLIP does, so the import
is a renaming.  A FAS fine-tune adds a classifier ``head.{weight,bias}`` on
the projected embedding; without one the head keeps its seeded init
(models/weights.py::seeded_state), as the JAX import keeps flax's.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .checkpoint_maps import match_state_dict
from .vit import CONFIGS as VIT_CONFIGS
from .vit import ViT


def clip_config_from_state_dict(sd: Mapping[str, Any]) -> str:
    """The ViT ``clip_*`` config matching a CLIP visual state_dict."""
    width, _, patch, _ = np.shape(sd["visual.conv1.weight"])
    depth = 0
    while f"visual.transformer.resblocks.{depth}.ln_1.weight" in sd:
        depth += 1
    proj_dim = int(np.shape(sd["visual.proj"])[1])
    for name, cfg in VIT_CONFIGS.items():
        if (
            name.startswith("clip_")
            and (cfg.patch, cfg.width, cfg.depth, cfg.proj_dim) == (patch, width, depth, proj_dim)
        ):
            return name
    raise ValueError(f"no clip_* config matches patch={patch} width={width} depth={depth} proj_dim={proj_dim}")


def load_clip_visual_state_dict(
    state_dict: Mapping[str, Any], config: str, num_classes: int = 2, strict: bool = True
) -> Dict[str, torch.Tensor]:
    """A CLIP state_dict's visual tower (and optional ``head``) as the state_dict
    of the port's ViT(config).  The input size is read from
    ``positional_embedding``.  ``strict`` requires every ``visual.*`` tensor to
    be consumed; other keys are always ignored."""
    cfg = VIT_CONFIGS[config]
    if not cfg.pre_ln:
        raise ValueError(f"config {config!r} is not CLIP-structured (use a clip_* config)")
    sd = {k[len("visual."):]: v for k, v in state_dict.items() if k.startswith("visual.")}
    tokens = int(np.shape(sd["positional_embedding"])[0]) if "positional_embedding" in sd else 1
    grid = int(round((tokens - 1) ** 0.5))
    template = ViT(config, num_classes, grid * cfg.patch)
    if "head.weight" in state_dict:
        sd["head.weight"], sd["head.bias"] = state_dict["head.weight"], state_dict["head.bias"]
    else:
        from .weights import seeded_state

        seeded = seeded_state(template.head, 0)
        sd["head.weight"], sd["head.bias"] = seeded["weight"], seeded["bias"]
    return match_state_dict(template, sd, config, strict)


def import_clip_visual(
    state_dict: Mapping[str, Any],
    num_classes: int = 2,
    image_size: Tuple[int, int] = (224, 224),
    softmax: bool = True,
    strict: bool = True,
):
    """Build + import: (model in eval mode, meta) for models/checkpoint_io.py."""
    width, height = image_size
    if width != height:
        raise ValueError(f"the ViT takes square inputs, got {image_size}")
    config = clip_config_from_state_dict(state_dict)
    model = ViT(config, num_classes, width, softmax=softmax).eval()
    model.load_state_dict(load_clip_visual_state_dict(state_dict, config, num_classes, strict))
    meta = {
        "family": "clip_vit",
        "config": config,
        "num_classes": num_classes,
        "softmax": bool(softmax),
        "image_size": list(image_size),
    }
    return model, meta
