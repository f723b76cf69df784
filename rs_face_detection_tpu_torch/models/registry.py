"""In-process model registry: named modules with a lifecycle and statistics.

Counterpart of rs_face_detection_tpu/models/registry.py, with the same verbs
and the same statistics (the analogs of a model repository's
``model_statistics``):

  - register_builder / load / register / unload / index: the lifecycle; a
    builder runs on first use, and of two concurrent loads of one name the
    first entry is kept (a second would drop its statistics);
  - server_live / server_ready / model_ready: health;
  - spec(name): the ``ModelSpec`` (shapes, output contract);
  - get(name): the ``nn.Module`` the pipelines consume; variables(name): its
    state_dict; memory_usage_bytes(name): its parameter and buffer bytes;
  - statistics(name) / record(...) / infer(...): ``ModelStats`` -- counts
    per call and per batch size, and durations measured on the host.

A builder returns (spec, module); the registry puts the module in eval mode
on its device (the card unless given), and a pipeline serves that module
itself, so a pipeline runs on its registry's device or refuses the registry.
An entry that is not an ``nn.Module`` (a model repository's ensemble,
runtime/repository.py::EnsembleDefinition) is held as it is, as the JAX
registry holds any object; it has no weights, so its memory usage is 0.

``default_registry(device)`` is one registry per process and device with a
builder for every ``model_name`` of configs.py, each as the JAX package's:
it calls models/checkpoint_io.py::maybe_serve_checkpoint first, so
``$RSFD_CHECKPOINT_DIR/<model_name>.npz`` is served when it exists, and else
builds the seeded module the pipelines built before the registry existed
(models/weights.py::init_state, seed 0; the CLIP towers cast to bf16 by
models/vit.py::cast_for_serving).  Configs that shape other modules (an R50
detector, an IResNet-18) have a default registry of their own.

``save_variables`` / ``load_variables`` read and write the JAX package's
checkpoint format: an ``.npz`` of '/'-joined paths.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..utils.device import DeviceLike, resolve_device

#: The detection output contract string of the JAX registry.
DETECTION_OUTPUT_SPEC = "per-stride score/(A) bbox/(4A) landmark/(10A) maps"


@dataclass
class ModelSpec:
    """Static model metadata (the model_config analog)."""

    name: str
    input_shape: Tuple[int, ...]  # (H, W, C) of a single example
    output_spec: str  # human-readable output contract
    max_batch_size: int = 1
    preprocessing: str = ""
    dynamic_batching: bool = False
    max_queue_delay_us: int = 0


@dataclass
class ModelStats:
    """Per-model inference counters (the model_statistics analog)."""

    inference_count: int = 0
    execution_count: int = 0
    cumulative_duration_s: float = 0.0
    last_duration_s: float = 0.0
    #: executions per batch size
    batch_size_counts: Dict[int, int] = field(default_factory=dict)


@dataclass
class _Entry:
    spec: ModelSpec
    module: Any  # an nn.Module, or an object without weights (an ensemble)
    stats: ModelStats = field(default_factory=ModelStats)


Builder = Callable[[], Tuple[ModelSpec, nn.Module]]


class ModelRegistry:
    """Thread-safe named module store with lifecycle and statistics."""

    def __init__(self, device: DeviceLike = "cuda") -> None:
        self.device = resolve_device(device)
        self._models: Dict[str, _Entry] = {}
        self._lock = threading.Lock()
        self._builders: Dict[str, Builder] = {}

    # -- lifecycle ---------------------------------------------------------

    def register_builder(self, name: str, builder: Builder) -> None:
        """Register a lazy constructor returning (spec, module)."""
        with self._lock:
            self._builders[name] = builder

    def load(self, name: str) -> None:
        """Build a registered name; the first of concurrent loads is kept."""
        with self._lock:
            if name in self._models:
                return
            if name not in self._builders:
                raise KeyError(f"model {name!r} has no registered builder")
            builder = self._builders[name]
        spec, module = builder()
        if spec.name != name:
            raise ValueError(f"builder registered as {name!r} returned spec.name={spec.name!r}")
        module = self._placed(module)
        with self._lock:
            if name not in self._models:
                self._models[name] = _Entry(spec, module)

    def register(self, spec: ModelSpec, module: Any) -> None:
        module = self._placed(module)
        with self._lock:
            self._models[spec.name] = _Entry(spec, module)

    def _placed(self, module: Any) -> Any:
        """An ``nn.Module`` in eval mode on the registry's device; any other
        object as it is."""
        return module.to(self.device).eval() if isinstance(module, nn.Module) else module

    def unload(self, name: str) -> None:
        with self._lock:
            self._models.pop(name, None)

    def index(self) -> List[Dict[str, str]]:
        """Known models and their state."""
        with self._lock:
            loaded = set(self._models)
            return [
                {"name": n, "state": "READY" if n in loaded else "UNAVAILABLE"}
                for n in sorted(loaded | set(self._builders))
            ]

    # -- health --------------------------------------------------------------

    def server_live(self) -> bool:
        return True

    def server_ready(self) -> bool:
        return True

    def model_ready(self, name: str) -> bool:
        with self._lock:
            return name in self._models

    # -- access --------------------------------------------------------------

    def spec(self, name: str) -> ModelSpec:
        return self._entry(name).spec

    def get(self, name: str) -> Any:
        """The module, loading it on first use."""
        return self._entry(name).module

    def variables(self, name: str) -> Dict[str, torch.Tensor]:
        module = self._entry(name).module
        return module.state_dict() if isinstance(module, nn.Module) else {}

    def memory_usage_bytes(self, name: str) -> int:
        """Bytes of the module's parameters and buffers, each tensor once;
        BatchNorm's ``num_batches_tracked`` counters are left out, as the
        JAX variables have no such leaf.  An entry without weights (an
        ensemble) answers 0."""
        module = self._entry(name).module
        if not isinstance(module, nn.Module):
            return 0
        tensors = dict(module.named_parameters())
        tensors.update((k, b) for k, b in module.named_buffers() if not k.endswith("num_batches_tracked"))
        seen = {id(t): t.numel() * t.element_size() for t in tensors.values()}
        return int(sum(seen.values()))

    def statistics(self, name: str) -> ModelStats:
        stats = self._entry(name).stats
        with self._lock:  # a snapshot: the counts dict mutates under the lock
            return dataclasses.replace(stats, batch_size_counts=dict(stats.batch_size_counts))

    def _entry(self, name: str) -> _Entry:
        with self._lock:
            if name in self._models:
                return self._models[name]
            if name not in self._builders:
                raise KeyError(f"model {name!r} is not loaded")
        self.load(name)
        with self._lock:
            return self._models[name]

    def record(self, name: str, batch_size: int, duration_s: float) -> None:
        """Account a forward pass timed by its caller (a pipeline runs the
        modules itself); a name that is not loaded is ignored."""
        with self._lock:
            entry = self._models.get(name)
            if entry is not None:
                _account(entry.stats, int(batch_size), duration_s)

    def infer(self, name: str, batch: Any, **kwargs) -> Any:
        """A timed forward pass of the module on ``batch`` (moved to the
        registry's device), synchronized before the clock stops."""
        e = self._entry(name)
        x = torch.as_tensor(batch).to(self.device)
        start = time.perf_counter()
        with torch.no_grad():
            out = e.module(x, **kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dur = time.perf_counter() - start
        with self._lock:
            _account(e.stats, int(x.shape[0]) if x.ndim else 1, dur)
        return out


def record(registry: Optional[ModelRegistry], name: str, batch_size: int, start: float) -> None:
    """``registry.record`` of a call that began at ``start`` (perf_counter),
    when there is a registry."""
    if registry is not None:
        registry.record(name, batch_size, time.perf_counter() - start)


def _account(stats: ModelStats, batch_size: int, duration_s: float) -> None:
    stats.inference_count += batch_size
    stats.execution_count += 1
    stats.cumulative_duration_s += duration_s
    stats.last_duration_s = duration_s
    stats.batch_size_counts[batch_size] = stats.batch_size_counts.get(batch_size, 0) + 1


# -- checkpoint (de)serialization ------------------------------------------


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}/"))
    else:
        flat[prefix.rstrip("/")] = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
    return flat


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def save_variables(path: str, variables: Mapping[str, Any]) -> None:
    """Write a nested mapping of arrays (or tensors) to an .npz of '/'-joined
    paths."""
    np.savez(path, **_flatten(variables))


def load_variables(path: str) -> Dict[str, Any]:
    """Read an .npz checkpoint back into a nested dict."""
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


# -- the standard builders ---------------------------------------------------

_default_registries: Dict[Tuple, ModelRegistry] = {}
_default_lock = threading.Lock()


def default_registry(device: DeviceLike = "cuda", **configs: Any) -> ModelRegistry:
    """The process-wide registry with the standard builders on ``device``:
    one for each device and each way ``configs`` shape the modules (see
    ``standard_registry``), made on first use."""
    key = (resolve_device(device), _shaping(configs))
    with _default_lock:
        if key not in _default_registries:
            _default_registries[key] = standard_registry(key[0], **configs)
        return _default_registries[key]


def standard_registry(device: DeviceLike = "cuda", **configs: Any) -> ModelRegistry:
    """A new registry with the standard builders; ``configs`` (keywords
    ``detection``, ``quality``, ``identification``, ``quality_assessment``,
    ``antispoofing``) replace the default configs the face-ID builders read."""
    registry = ModelRegistry(device)
    _attach_standard_builders(registry, **configs)
    return registry


def _shaping(configs: Mapping[str, Any]) -> Tuple:
    """The config fields that decide which modules the face-ID builders make."""
    from ..configs import (
        FaceAntiSpoofingConfig,
        FaceDetectionConfig,
        FaceIdentificationConfig,
        FaceQualityAssessmentConfig,
        FaceQualityConfig,
    )

    d = configs.get("detection") or FaceDetectionConfig()
    q = configs.get("quality") or FaceQualityConfig()
    i = configs.get("identification") or FaceIdentificationConfig()
    a = configs.get("quality_assessment") or FaceQualityAssessmentConfig()
    f = configs.get("antispoofing") or FaceAntiSpoofingConfig()
    return (
        d.model_name, d.backbone, q.model_name, q.num_classes, i.model_name, i.backbone,
        a.model_name, tuple(f.model_names), tuple(map(tuple, f.image_sizes)),
    )


def registry_on(registry: Optional[ModelRegistry], device: torch.device, **configs: Any) -> ModelRegistry:
    """The registry a pipeline on ``device`` serves from: the caller's, which
    must keep its modules on that device (a pipeline moving them would move
    them for every other user), else ``default_registry(device, **configs)``."""
    if registry is None:
        return default_registry(device, **configs)
    if registry.device != device:
        raise ValueError(f"the registry keeps its modules on {registry.device}, the pipeline runs on {device}")
    return registry


def from_registry(
    model: Optional[nn.Module], registry: Optional[ModelRegistry], name: str, device: torch.device, **configs: Any
) -> Tuple[nn.Module, Optional[ModelRegistry]]:
    """What a single-model entry point on ``device`` serves, and the registry
    whose statistics count its calls: the caller's ``model`` (and no
    registry), else ``name`` from ``registry_on(registry, device,
    **configs)``.  A model and a registry together are refused, as the JAX
    package refuses half a (model, variables) pair: one of them would be
    silently dropped."""
    if model is not None:
        if registry is not None:
            raise ValueError("pass a model or a registry, not both (or neither, to take the default registry's)")
        return model, None
    registry = registry_on(registry, device, **configs)
    return registry.get(name), registry


def _attach_standard_builders(
    registry: ModelRegistry,
    detection=None,
    quality=None,
    identification=None,
    quality_assessment=None,
    antispoofing=None,
) -> None:
    """A builder for every model the face-ID pipelines name (the JAX
    registry's), then the eKYC family."""
    from ..configs import (
        FaceAntiSpoofingConfig,
        FaceDetectionConfig,
        FaceIdentificationConfig,
        FaceQualityAssessmentConfig,
        FaceQualityConfig,
    )
    from .checkpoint_io import maybe_serve_checkpoint
    from .weights import init_state, load_model

    det_cfg = detection or FaceDetectionConfig()
    q_cfg = quality or FaceQualityConfig()
    id_cfg = identification or FaceIdentificationConfig()
    fqa_cfg = quality_assessment or FaceQualityAssessmentConfig()
    fas_cfg = antispoofing or FaceAntiSpoofingConfig()

    def detection_builder():
        model = maybe_serve_checkpoint(det_cfg.model_name, expect_family="retinaface")
        if model is None:
            family = f"retinaface_{det_cfg.backbone}"
            model = load_model(family, init_state(family, 0))
        w, h = det_cfg.image_size
        return ModelSpec(
            det_cfg.model_name, (h, w, 3), DETECTION_OUTPUT_SPEC, det_cfg.max_batch_size,
            "letterbox 640, BGR->RGB, raw 0-255",
        ), model

    def identification_builder():
        model = maybe_serve_checkpoint(id_cfg.model_name, expect_family="iresnet")
        if model is None:
            model = load_model(id_cfg.backbone, init_state(id_cfg.backbone, 0))
        w, h = id_cfg.image_size
        return ModelSpec(
            id_cfg.model_name, (h, w, 3), f"(B, {id_cfg.embedding_dim}) embedding", id_cfg.batch_size,
            "BGR->RGB, (px-127.5)*0.0078125",
        ), model

    def quality_builder():
        model = maybe_serve_checkpoint(q_cfg.model_name, expect_family="resnet18", softmax=True)
        if model is None:
            model = load_model("resnet18_classifier", init_state("resnet18_classifier", 0, q_cfg.num_classes))
        w, h = q_cfg.image_size
        return ModelSpec(
            q_cfg.model_name, (h, w, 3), f"(B, {q_cfg.num_classes}) class probabilities", q_cfg.batch_size,
            "BGR->RGB, ImageNet mean/std",
        ), model

    def fqa_builder():
        model = maybe_serve_checkpoint(fqa_cfg.model_name, expect_family="resnet18", softmax=False)
        if model is None:
            model = load_model("resnet18_classifier", init_state("resnet18_classifier", 0, 1), softmax=False)
        w, h = fqa_cfg.image_size
        return ModelSpec(
            fqa_cfg.model_name, (h, w, 3), "(B, 1) quality score (0-100 scale)", fqa_cfg.batch_size,
            "BGR->RGB, (px-127.5)*0.00784313725",
        ), model

    def fas_builder(name, size):
        from .minifas import conv6_kernel_for

        w, h = size
        model = maybe_serve_checkpoint(name, expect_family="minifas", softmax=True)
        if model is not None:
            if model.spec.conv6_kernel != conv6_kernel_for((h, w)):
                raise ValueError(
                    f"checkpoint for {name!r} has conv6 kernel {model.spec.conv6_kernel}, "
                    f"incompatible with the configured input {(h, w)}"
                )
        else:
            if w != h:
                raise ValueError(f"the seeded MiniFASNet is square, got {w}x{h}")
            model = load_model("minifasnet", init_state("minifasnet", 0, 3, image_size=h))
        return ModelSpec(
            name, (h, w, 3), "(B, 3) probabilities, col 1 = live", fas_cfg.batch_size, "raw 0-255 BGR",
        ), model

    registry.register_builder(det_cfg.model_name, detection_builder)
    registry.register_builder(id_cfg.model_name, identification_builder)
    registry.register_builder(q_cfg.model_name, quality_builder)
    registry.register_builder(fqa_cfg.model_name, fqa_builder)
    for name, size in zip(fas_cfg.model_names, fas_cfg.image_sizes):
        registry.register_builder(name, lambda name=name, size=size: fas_builder(name, size))
    _attach_ekyc_builders(registry)


#: eKYC registry name -> family of the seeded model its builder makes.
EKYC_FAMILIES = {
    "scrfd": "scrfd",
    "face_id": "iresnet50",
    "face_attribute": "resnet18_classifier",
    "face_quality_vp": "resnet18_classifier",
    "face_anti_spoofing_crop_l14": "clip_l14",
    "face_anti_spoofing_fi_l14": "clip_l14",
}


def _attach_ekyc_builders(registry: ModelRegistry) -> None:
    """Builders for the eKYC model family."""
    from ..configs import (
        EkycFaceAttributeConfig,
        EkycFaceDetectionConfig,
        EkycFaceIDConfig,
        EkycFaceQualityConfig,
        EkycFASCropConfig,
        EkycFASFullConfig,
    )
    from .checkpoint_io import maybe_serve_checkpoint
    from .vit import cast_for_serving
    from .weights import init_state, load_model

    def scrfd_builder():
        name = EkycFaceDetectionConfig().model_name
        model = maybe_serve_checkpoint(name, expect_family="scrfd")
        if model is not None:
            if model.num_anchors != 2:
                raise ValueError(
                    f"imported SCRFD has {model.num_anchors} anchors/cell; the eKYC decode expects 2"
                )
        else:
            model = load_model(EKYC_FAMILIES[name], init_state(EKYC_FAMILIES[name], 0, 2))
        return ModelSpec(
            name, (640, 640, 3), "per-stride sigmoid score / distance bbox / kps maps",
            preprocessing="letterbox 640, BGR->RGB, (px-127.5)*0.00784",
        ), model

    def face_id_builder():
        cfg = EkycFaceIDConfig()
        model = maybe_serve_checkpoint(cfg.model_name, expect_family="iresnet")
        if model is None:
            family = EKYC_FAMILIES[cfg.model_name]
            model = load_model(family, init_state(family, 0, 2))
        return ModelSpec(cfg.model_name, (cfg.imsize, cfg.imsize, 3), "(B, 512) embedding"), model

    def classifier_builder(cfg, output_spec):
        model = maybe_serve_checkpoint(cfg.model_name, expect_family="resnet18", softmax=True)
        if model is None:
            family = EKYC_FAMILIES[cfg.model_name]
            model = load_model(family, init_state(family, 0, 2))
        return ModelSpec(cfg.model_name, (cfg.imsize, cfg.imsize, 3), output_spec), model

    def fas_vit_builder(cfg):
        # CLIP-structured ViT-L/14, served in bf16 with f32 LayerNorms; the
        # checkpoint on disk stays f32.
        model = maybe_serve_checkpoint(cfg.model_name, expect_family="clip_vit", softmax=True)
        if model is None:
            family = EKYC_FAMILIES[cfg.model_name]
            model = load_model(family, init_state(family, 0, 2, image_size=cfg.imsize))
        return ModelSpec(
            cfg.model_name, (cfg.imsize, cfg.imsize, 3), "(B, 2) probabilities, col 1 = live",
            preprocessing="ImageNet mean/std RGB",
        ), cast_for_serving(model)

    attr, quality = EkycFaceAttributeConfig(), EkycFaceQualityConfig()
    registry.register_builder(EkycFaceDetectionConfig().model_name, scrfd_builder)
    registry.register_builder(EkycFaceIDConfig().model_name, face_id_builder)
    registry.register_builder(
        attr.model_name, lambda: classifier_builder(attr, "(B, 2) probabilities, col 1 = mask")
    )
    registry.register_builder(
        quality.model_name, lambda: classifier_builder(quality, "(B, 2) probabilities, col 1 = covered")
    )
    for cfg in (EkycFASCropConfig(), EkycFASFullConfig()):
        registry.register_builder(cfg.model_name, lambda cfg=cfg: fas_vit_builder(cfg))
