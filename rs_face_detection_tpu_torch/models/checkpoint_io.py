"""Public-checkpoint import and registry serving.

Counterpart of rs_face_detection_tpu/models/checkpoint_io.py.  The last
mile from a trained public checkpoint to the pipelines:

    model, meta = import_state_dict(torch.load("backbone.pth"))   # any kind
    save_imported("/ckpt/face_identification.npz", model, meta)
    export RSFD_CHECKPOINT_DIR=/ckpt      # every registry builder serves it

  - ``detect_kind``: which of seven public layouts a state_dict carries
    (biubug6 RetinaFace mnet0.25 / R50, insightface IResNet, Silent-Face
    MiniFASNet, torchvision ResNet-18, OpenAI CLIP visual, mmdet SCRFD);
  - ``import_state_dict``: the port's module for it, loaded, plus ``meta``,
    which says how to rebuild the architecture;
  - ``save_imported`` / ``load_imported``: the registry ``.npz``, in the JAX
    package's format -- flax paths (``params/...``, ``batch_stats/...``) and
    a ``__meta__`` JSON entry -- so a file written by either package loads in
    the other.  The port writes flax paths through the inverse of its weight
    bridge (models/weights.py::flax_from_state_dict);
  - ``load_imported_model`` and ``maybe_serve_checkpoint``: the module a
    file describes; the registry builders call the latter first and serve
    ``$RSFD_CHECKPOINT_DIR/<model_name>.npz`` when it exists.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch.nn as nn

from .checkpoint_maps import load_iresnet_state_dict, load_retinaface_state_dict, match_state_dict, strip_module_prefix
from .registry import _unflatten

#: The directory the registry scans for ``<model_name>.npz`` checkpoints.
CHECKPOINT_DIR_ENV = "RSFD_CHECKPOINT_DIR"

KINDS = (
    "retinaface_mnet025",
    "retinaface_resnet50",
    "iresnet",
    "minifas",
    "resnet18",
    "clip_visual",
    "scrfd",
)

# ---------------------------------------------------------------------------
# layout fingerprinting (copies of the JAX package's functions)
# ---------------------------------------------------------------------------


def detect_kind(state_dict: Mapping[str, Any]) -> str:
    """Identify which supported public layout a state_dict carries (keys
    taken without a 'module.' prefix)."""
    keys = set(strip_module_prefix(state_dict))
    if "visual.conv1.weight" in keys and "visual.proj" in keys:
        return "clip_visual"
    if "bbox_head.cls_convs.0.0.conv.weight" in keys and "neck.lateral_convs.0.conv.weight" in keys:
        return "scrfd"
    if "ssh1.conv3X3.0.weight" in keys:
        if "body.stage1.0.0.weight" in keys:
            return "retinaface_mnet025"
        if "body.layer1.0.conv1.weight" in keys:
            return "retinaface_resnet50"
        raise ValueError("RetinaFace-layout state_dict with unrecognized backbone keys")
    if "conv_6_sep.conv.weight" in keys and "prob.weight" in keys:
        return "minifas"
    if "prelu.weight" in keys and "features.weight" in keys:
        return "iresnet"
    if (
        "conv1.weight" in keys
        and "layer1.0.conv1.weight" in keys
        and "layer1.0.conv3.weight" not in keys
        # resnet34 shares the basic-block layout with 3 blocks in layer1.
        and "layer1.2.conv1.weight" not in keys
        and "fc.weight" in keys
    ):
        return "resnet18"
    sample = sorted(keys)[:6]
    raise ValueError(f"unrecognized state_dict layout (first keys: {sample}); pass an explicit kind from {KINDS}")


def iresnet_depth_from_state_dict(state_dict: Mapping[str, Any]) -> str:
    """iresnet18/34/50/100 from the per-stage block counts."""
    from .arcface import STAGES

    keys = strip_module_prefix(state_dict)
    counts = []
    for s in range(1, 5):
        b = 0
        while f"layer{s}.{b}.bn1.weight" in keys:
            b += 1
        counts.append(b)
    for depth, stages in STAGES.items():
        if tuple(counts) == tuple(stages):
            return depth
    raise ValueError(f"iresnet stage block counts {counts} match no known depth")


# ---------------------------------------------------------------------------
# import
# ---------------------------------------------------------------------------


def _retinaface_stem(backbone: str, stem_s2d: Optional[bool]) -> bool:
    """The port's stem layout: natural for the MobileNet, s2d for the R50."""
    s2d = backbone == "resnet50"
    if stem_s2d is not None and bool(stem_s2d) != s2d:
        raise ValueError(f"the port's {backbone} runs {'the s2d' if s2d else 'the natural'} stem only")
    return s2d


def import_state_dict(
    state_dict: Mapping[str, Any],
    kind: str = "auto",
    image_size: Optional[Tuple[int, int]] = None,
    softmax: bool = True,
    stem_s2d: Optional[bool] = None,
    strict: bool = True,
) -> Tuple[nn.Module, Dict[str, Any]]:
    """A supported public state_dict as (the port's module, loaded and in eval
    mode, meta).  ``image_size`` is (width, height) where it applies; a
    MiniFASNet takes its input size from its conv6 kernel unless given."""
    from .classifiers import ResNet18Classifier
    from .minifas import MiniFASNet, conv6_kernel_for, minifasnet_spec_from_state_dict

    sd = {k: np.asarray(v) for k, v in strip_module_prefix(state_dict).items()}
    if kind == "auto":
        kind = detect_kind(sd)
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of {KINDS}")

    if kind in ("retinaface_mnet025", "retinaface_resnet50"):
        backbone = "mobilenet025" if kind.endswith("mnet025") else "resnet50"
        meta = {
            "family": "retinaface",
            "backbone": backbone,
            "stem_s2d": _retinaface_stem(backbone, stem_s2d),
            "image_size": list(image_size or (640, 640)),
        }
        weights = load_retinaface_state_dict(sd, backbone, strict)
    elif kind == "iresnet":
        depth = iresnet_depth_from_state_dict(sd)
        meta = {
            "family": "iresnet",
            "depth": depth,
            "embedding_dim": int(sd["fc.weight"].shape[0]),
            "image_size": list(image_size or (112, 112)),
        }
        weights = load_iresnet_state_dict(sd, depth, strict)
    elif kind == "minifas":
        spec = minifasnet_spec_from_state_dict(sd)
        if image_size is not None:
            input_hw = (image_size[1], image_size[0])
            if conv6_kernel_for(input_hw) != spec.conv6_kernel:
                raise ValueError(f"--image-size {image_size} incompatible with checkpoint conv6 kernel {spec.conv6_kernel}")
        else:
            input_hw = (spec.conv6_kernel[0] * 16, spec.conv6_kernel[1] * 16)
        meta = {
            "family": "minifas",
            "spec": dataclasses.asdict(spec),
            "input_hw": list(input_hw),
            "softmax": bool(softmax),
        }
        weights = match_state_dict(MiniFASNet(spec, softmax), sd, "minifas", strict)
    elif kind == "resnet18":
        num_outputs = int(sd["fc.weight"].shape[0])
        meta = {
            "family": "resnet18",
            "num_outputs": num_outputs,
            "softmax": bool(softmax),
            "image_size": list(image_size or (112, 112)),
        }
        weights = match_state_dict(ResNet18Classifier(num_outputs, softmax), sd, "resnet18", strict)
    elif kind == "clip_visual":
        from .clip_import import import_clip_visual

        num_classes = int(sd["head.weight"].shape[0]) if "head.weight" in sd else 2
        return import_clip_visual(sd, num_classes, image_size or (224, 224), softmax, strict)
    else:  # scrfd
        from .scrfd_import import load_scrfd_state_dict

        model, spec = load_scrfd_state_dict(sd, strict=strict)
        meta = {"family": "scrfd", "spec": dataclasses.asdict(spec), "image_size": list(image_size or (640, 640))}
        return model, meta
    model = build_from_meta(meta)
    model.load_state_dict(weights)
    return model, meta


# ---------------------------------------------------------------------------
# the self-describing .npz
# ---------------------------------------------------------------------------


def build_from_meta(meta: Mapping[str, Any], **overrides: Any) -> nn.Module:
    """The architecture a checkpoint's meta describes, in eval mode, with its
    template weights.  ``overrides`` replace meta fields first (a serving
    role sets e.g. ``softmax``; the stored weights are the same)."""
    m = {**meta, **overrides}
    family = m["family"]
    if family == "retinaface":
        from .retinaface import RetinaFace

        model = RetinaFace(m["backbone"])
    elif family == "iresnet":
        from .arcface import IResNet

        model = IResNet(m["depth"], m["embedding_dim"])
    elif family == "minifas":
        from .minifas import DWSpec, MiniFASNet, MiniFASNetSpec

        def dw(d):
            return DWSpec(**{**d, "kernel": tuple(d["kernel"])})

        s = dict(m["spec"])
        for key in ("conv_23", "conv_34", "conv_45"):
            s[key] = dw(s[key])
        for key in ("conv_3", "conv_4", "conv_5"):
            s[key] = tuple(dw(d) for d in s[key])
        s["conv6_kernel"] = tuple(s["conv6_kernel"])
        model = MiniFASNet(MiniFASNetSpec(**s), m["softmax"])
    elif family == "resnet18":
        from .classifiers import ResNet18Classifier

        model = ResNet18Classifier(m["num_outputs"], m["softmax"])
    elif family == "scrfd":
        from .scrfd_import import SCRFDImportedNet, SCRFDImportSpec

        s = dict(m["spec"])
        for key in ("stem_channels", "stage_blocks", "stage_planes", "strides"):
            s[key] = tuple(s[key])
        model = SCRFDImportedNet(SCRFDImportSpec(**s))
    elif family == "clip_vit":
        from .vit import ViT

        width, height = m["image_size"]
        if width != height:
            raise ValueError(f"the ViT takes square inputs, got {m['image_size']}")
        model = ViT(m["config"], m["num_classes"], width, softmax=m["softmax"])
    else:
        raise ValueError(f"unknown checkpoint family {family!r}")
    return model.eval()


def flax_map(meta: Mapping[str, Any], model: nn.Module) -> Dict[str, Tuple]:
    """{flax path: (torch key, kind)} of the JAX model a meta describes."""
    from . import weights

    family = meta["family"]
    if family == "retinaface":
        return weights.mapping_for(f"retinaface_{meta['backbone']}")
    if family == "iresnet":
        return weights.iresnet_map(meta["depth"])
    if family == "minifas":
        return weights.mapping_for("minifasnet", model.spec)
    if family == "resnet18":
        return weights.resnet18_classifier_map()
    if family == "clip_vit":
        return weights.vit_map(meta["config"])
    if family == "scrfd":
        from .scrfd_import import scrfd_map

        return scrfd_map(model.spec)
    raise ValueError(f"unknown checkpoint family {family!r}")


def save_imported(path: str, model: nn.Module, meta: Mapping[str, Any]) -> None:
    """Write a float module's weights as flax paths, plus ``meta``, to the
    exact ``path`` (np.savez would append '.npz' to a path without it)."""
    from .weights import flax_from_state_dict

    flat = flax_from_state_dict(flax_map(meta, model), model.state_dict())
    flat["__meta__"] = np.frombuffer(json.dumps(dict(meta)).encode("utf-8"), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_imported(path: str) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]]]:
    """An .npz checkpoint as (nested variables tree, meta or None): takes
    self-describing files (save_imported) and plain registry.save_variables
    files (meta None)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    raw = flat.pop("__meta__", None)
    meta = json.loads(bytes(raw.tobytes()).decode("utf-8")) if raw is not None else None
    return _unflatten(flat), meta


# ---------------------------------------------------------------------------
# registry pickup
# ---------------------------------------------------------------------------


def registry_checkpoint_path(name: str) -> Optional[str]:
    """``$RSFD_CHECKPOINT_DIR/<name>.npz`` if the variable and the file exist."""
    root = os.environ.get(CHECKPOINT_DIR_ENV)
    if not root:
        return None
    path = os.path.join(root, f"{name}.npz")
    return path if os.path.exists(path) else None


def load_imported_model(
    path: str, expect_family: Optional[str] = None, return_meta: bool = False, **overrides: Any
) -> Any:
    """The module (eval mode, on the CPU) that a save_imported file at an
    explicit path describes, with ``meta`` after it when ``return_meta``.
    Files without meta cannot name an architecture and raise."""
    from .weights import state_dict_from_jax

    loaded, meta = load_imported(path)
    if meta is None:
        raise ValueError(
            f"{path} has no __meta__ entry; re-create it with import_state_dict and "
            f"save_imported so the architecture is recoverable"
        )
    if expect_family is not None and meta.get("family") != expect_family:
        raise ValueError(f"{path} holds a {meta.get('family')!r} model but the caller expects {expect_family!r}")
    model = build_from_meta(meta, **overrides)
    try:
        sd = state_dict_from_jax(meta["family"], loaded, mapping=flax_map(meta, model))
        if meta["family"] == "retinaface":  # a natural 7x7 R50 stem becomes the s2d one
            sd = load_retinaface_state_dict(sd, meta["backbone"])
        model.load_state_dict(match_state_dict(model, sd, path))
    except (KeyError, ValueError, RuntimeError) as e:
        raise ValueError(f"checkpoint for {path!r} does not match the model structure: {e}") from e
    return (model, meta) if return_meta else model


def maybe_serve_checkpoint(name: str, expect_family: Optional[str] = None, **overrides: Any) -> Optional[nn.Module]:
    """Registry-builder hook: the module of ``<name>.npz`` in
    RSFD_CHECKPOINT_DIR, or None when there is no such file."""
    path = registry_checkpoint_path(name)
    if path is None:
        return None
    return load_imported_model(path, expect_family=expect_family, **overrides)

