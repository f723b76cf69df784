"""Ahead-of-time serving artifacts: the detect graph and the heads through torch.export.

The port of rs_face_detection_tpu/runtime/aot.py (``export_detector`` /
``load_detector``, ``export_model`` / ``load_model``).  A deployment keeps
compiled programs apart from their weights, as a Triton model repository
does: ``export_detector`` serialises the whole batched detect graph --
letterboxed uint8 canvases and their scales in; the network, the stable
top-k, the decode, NMS, the compaction and the descale; ``det``, ``kps``
and ``count`` out -- and ``load_detector`` brings it back without the
model's Python: no module classes and no detector object, only the port's
custom-op registrations, so the loading process must ``import
rs_face_detection_tpu_torch`` first.  The kernels are single nodes of the
graph (``rsfd::nms_mask``, ``rsfd::fused_stem``, ``rsfd::attention``,
``rsfd::int8_matmul``, ops/*.py): on the card each launches its kernel, on
the CPU it runs its plain version.

Artifact: the bytes of ``torch.export.save`` with one extra file,
``rsfd_meta.json`` (format ``rsfd-aot-v1`` for a detector,
``rsfd-aot-model-v1`` for a model; the batch shape, the device it was
exported on, the torch version, and every state leaf's name, shape and
dtype).  Weights stay OUTSIDE: the program takes the state dict as its
first input (the export runs over ``torch.func.functional_call``), so one
loaded program serves any checkpoint of the architecture and the artifact
carries no parameter bytes.  The loaded object checks each leaf's shape
(naming the leaf), casts it to the traced dtype and moves it to the
program's device once per state dict (a one-entry cache keyed by the state
dict's identity), as JAX's ``prepare_variables`` does.

Shapes are static: one artifact per batch size.  The detector's layout is
the natural (B, H, W, 3) uint8 one (meta ``layout`` "none"); its stem is
the fused stem K2 for a float s2d ResNet-50 (``stem`` "fused") and the
module's own otherwise ("module").  JAX's s4d layouts, its bf16 pre-cast
export and its sharded ViT artifacts are not ported.  An artifact exported
on one device loads onto another (``torch.export.passes.
move_to_device_pass``): loading takes the card unless given ``device="cpu"``,
so an artifact exported on the CPU serves on the card.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from .. import __version__
from ..utils.device import DeviceLike, resolve_device

DETECTOR_FORMAT = "rsfd-aot-v1"
MODEL_FORMAT = "rsfd-aot-model-v1"
META_FILE = "rsfd_meta.json"


class _Program(nn.Module):
    """The exported root: ``fn(state, *inputs)``, holding no parameters or
    buffers itself, so that the exported program takes every weight as an
    input."""

    def __init__(self, fn) -> None:
        super().__init__()
        self._fn = fn

    def forward(self, state: Dict[str, torch.Tensor], *inputs: torch.Tensor):
        return self._fn(state, *inputs)


class _Detect(nn.Module):
    """``detect_batch`` of a detector over its network as the one submodule,
    so that ``functional_call`` swaps the network's state for the one given.
    A fused stem folds its constants from that state inside the graph."""

    def __init__(self, detector) -> None:
        super().__init__()
        self.model = detector.model
        self._detector = [detector]  # not a submodule: its state is self.model's

    def forward(self, imgs: torch.Tensor, scales: torch.Tensor):
        from ..pipeline.detection import descale, fold_model_stem, nms_and_compact

        det = self._detector[0]
        if getattr(det, "stem_consts", None) is None:
            out = det.detect_batch(imgs, scales)
        else:
            cand = det.candidates(imgs, stem_consts=fold_model_stem(self.model, det.cfg))
            out = descale(nms_and_compact(cand, det.cfg), 1.0 / scales.float())
        return out.det, out.kps, out.count


def _state_of(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's parameters and buffers by state-dict name, detached."""
    return {k: v.detach() for k, v in module.state_dict(keep_vars=True).items()}


def _leaves(state: Dict[str, torch.Tensor]):
    return [[k, list(v.shape), str(v.dtype).replace("torch.", "")] for k, v in state.items()]


def _export(fn, state, inputs, meta) -> bytes:
    program = _Program(fn)
    with torch.no_grad():
        ep = torch.export.export(program, (state, *inputs))
    ep.example_inputs = None  # they hold the weights, which stay outside the artifact
    meta = dict(meta, framework_version=__version__, torch_version=torch.__version__,
                device=str(inputs[0].device), state=_leaves(state))
    buf = io.BytesIO()
    torch.export.save(ep, buf, extra_files={META_FILE: json.dumps(meta)})
    return buf.getvalue()


def _image_size(detector) -> Tuple[int, int]:
    size = getattr(detector, "image_size", None) or detector.cfg.image_size
    return int(size[0]), int(size[1])


def export_detector(detector, batch_size: int = 8) -> bytes:
    """Serialise the batched detect graph of a detector; returns the bytes.

    Any detector with ``detect_batch(imgs_u8, scales)``, a ``model``, a
    ``device`` and an ``image_size`` (or ``cfg.image_size``) exports:
    ``RetinaFaceDetection`` (mnet, and the R50 with the fused stem) and
    ``SCRFDDetection``.  The program's inputs are the network's state dict,
    (batch_size, H, W, 3) uint8 canvases and (batch_size,) float32 scales on
    the detector's device; it runs what ``detect_batch`` runs, and the meta
    says which stem (JAX's s4d layouts and ``stem=`` options are not
    ported)."""
    width, height = _image_size(detector)
    device = detector.device
    graph = _Detect(detector).eval()
    state = _state_of(graph.model)
    imgs = torch.zeros((batch_size, height, width, 3), dtype=torch.uint8, device=device)
    scales = torch.ones((batch_size,), dtype=torch.float32, device=device)

    def detect(state, imgs, scales):
        return torch.func.functional_call(graph, {f"model.{k}": v for k, v in state.items()}, (imgs, scales))

    meta = {
        "format": DETECTOR_FORMAT,
        "batch_size": batch_size,
        "image_size": [width, height],
        "layout": "none",
        "stem": "module" if getattr(detector, "stem_consts", None) is None else "fused",
        "detector": type(detector).__name__,
        "backbone": getattr(getattr(detector, "cfg", None), "backbone", None),
    }
    return _export(detect, state, (imgs, scales), meta)


def export_model(
    module: nn.Module,
    batch_shape: Sequence[int],
    name: str = "",
    dtype=torch.float32,
) -> bytes:
    """Serialise ``module(batch)`` at one static batch shape: the artifact
    of a head (quality, embedding, anti-spoofing, a ViT tower) whose
    weights ride separately.  The batch is ``dtype`` (a torch dtype or a
    numpy one) on the module's device; the module runs in eval mode."""
    if not isinstance(dtype, torch.dtype):
        dtype = getattr(torch, np.dtype(dtype).name)
    device = next(module.parameters()).device
    was_training = module.training
    module.eval()
    try:
        state = _state_of(module)
        batch = torch.zeros(tuple(batch_shape), dtype=dtype, device=device)
        meta = {
            "format": MODEL_FORMAT,
            "name": name or type(module).__name__,
            "batch_shape": list(batch_shape),
            "dtype": str(dtype).replace("torch.", ""),
        }
        return _export(lambda state, x: torch.func.functional_call(module, state, (x,)), state, (batch,), meta)
    finally:
        module.train(was_training)


def _read_meta(blob: bytes, fmt: str) -> Dict[str, Any]:
    """The artifact's meta block; ValueError for anything but ``fmt``."""
    try:
        with zipfile.ZipFile(io.BytesIO(blob)) as z:
            names = [n for n in z.namelist() if n.rsplit("/", 1)[-1] == META_FILE]
            meta = json.loads(z.read(names[0])) if names else {}
    except (zipfile.BadZipFile, ValueError, KeyError) as e:
        raise ValueError(f"not an rsfd AOT artifact: {e}") from None
    if not isinstance(meta, dict) or meta.get("format") != fmt:
        raise ValueError(f"not an rsfd {fmt} artifact: {meta}")
    return meta


class _Loaded:
    """A deserialised artifact; call with (state_dict, *inputs)."""

    def __init__(self, blob: bytes, fmt: str, device: DeviceLike) -> None:
        self.device = resolve_device(device)
        self.meta = _read_meta(blob, fmt)
        program = torch.export.load(io.BytesIO(blob))
        if self.device != resolve_device(self.meta["device"]):
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(program, self.device)
        self.program = program
        self._fn = program.module()
        self._leaves = {k: (tuple(shape), getattr(torch, dtype)) for k, shape, dtype in self.meta["state"]}
        self._prepared_cache: list = []

    def prepare_state(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Check a state dict against the artifact's leaves (a wrong shape
        names its leaf), then cast each leaf to the traced dtype on the
        program's device."""
        missing = [k for k in self._leaves if k not in state]
        extra = [k for k in state if k not in self._leaves]
        if missing or extra:
            raise ValueError(f"state dict does not match the artifact: missing {missing[:5]}, "
                             f"unexpected {extra[:5]} ({len(missing)} and {len(extra)} in all)")
        prepared = {}
        for k, (shape, dtype) in self._leaves.items():
            v = torch.as_tensor(state[k])
            if tuple(v.shape) != shape:
                raise ValueError(f"state leaf {k!r} has shape {tuple(v.shape)}; artifact expects {shape}"
                                 " -- wrong checkpoint for this artifact?")
            prepared[k] = v.detach().to(self.device, dtype).contiguous()
        return prepared

    def _prepared(self, state):
        for s, prepared in self._prepared_cache:
            if s is state:
                return prepared
        prepared = self.prepare_state(state)
        self._prepared_cache.append((state, prepared))
        # ONE entry: weights are swapped (a checkpoint reload), not
        # alternated, and a deeper cache pins the old weights on the device.
        del self._prepared_cache[:-1]
        return prepared

    def _call(self, state, *inputs):
        with torch.inference_mode():
            return self._fn(self._prepared(state), *(torch.as_tensor(x).to(self.device) for x in inputs))


class LoadedDetector(_Loaded):
    """A deserialised ``export_detector`` artifact: call with
    ``(state_dict, imgs, scales)``, imgs (B, H, W, 3) uint8 canvases and
    scales (B,) float32 at the artifact's batch size; returns (det (B,
    max_det, 5), kps (B, max_det, 5, 2), count (B,)) on its device."""

    def __init__(self, blob: bytes, device: DeviceLike = "cuda") -> None:
        super().__init__(blob, DETECTOR_FORMAT, device)

    def __call__(self, state_dict, imgs, scales) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self._call(state_dict, imgs, torch.as_tensor(scales, dtype=torch.float32))


class LoadedModel(_Loaded):
    """A deserialised ``export_model`` artifact: call with
    ``(state_dict, batch)``."""

    def __init__(self, blob: bytes, device: DeviceLike = "cuda") -> None:
        super().__init__(blob, MODEL_FORMAT, device)

    def __call__(self, state_dict, batch) -> torch.Tensor:
        return self._call(state_dict, batch)


def load_detector(blob: bytes, device: DeviceLike = "cuda") -> LoadedDetector:
    """Re-hydrate an ``export_detector`` artifact (no model Python involved)
    on ``device``: the card unless the caller asks for the CPU; a program
    exported on another device is moved there."""
    return LoadedDetector(blob, device)


def load_model(blob: bytes, device: DeviceLike = "cuda") -> LoadedModel:
    """Re-hydrate an ``export_model`` artifact on ``device`` (the card by
    default)."""
    return LoadedModel(blob, device)
