"""Model FLOPs: 2 per multiply-add of every conv and linear of the plain
reference (the published networks), counted once by forward hooks on the
``meta`` device at the configuration's shapes: per image through the
detector, per selected face through both heads.  Pointwise work, NMS and
the warp are left out, so an ``mfu`` from these counts is a floor."""

from typing import Dict

import torch

from ..reference.models import build


def program_flops(cfg: dict) -> Dict[str, float]:
    """{"per_image": detector FLOPs of one image, "per_face": both heads'
    FLOPs of one face}."""
    counts = {}
    for part in ("detector", "quality", "identification"):
        with torch.device("meta"):
            net = build(cfg[part]).eval()
        total = [0.0]

        def hook(mod, inp, out):
            if isinstance(mod, torch.nn.Conv2d):
                k = mod.weight.shape[1] * mod.weight.shape[2] * mod.weight.shape[3]
                total[0] += 2.0 * out.numel() * k
            elif isinstance(mod, torch.nn.Linear):
                total[0] += 2.0 * out.numel() * mod.in_features

        for mod in net.modules():
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
                mod.register_forward_hook(hook)
        w, h = cfg[part]["image_size"]
        with torch.no_grad(), torch.device("meta"):
            net(torch.empty(1, 3, h, w))
        counts[part] = total[0]
    return {"per_image": counts["detector"], "per_face": counts["quality"] + counts["identification"]}
