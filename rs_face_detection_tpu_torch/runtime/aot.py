"""Ahead-of-time serving artifacts: the detect graph, the heads and the
tensor-parallel ViT through torch.export.

The port of rs_face_detection_tpu/runtime/aot.py (``export_detector`` /
``load_detector``, ``export_model`` / ``load_model``, ``export_tp_vit`` /
``load_tp_vit``).  A deployment keeps
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
module's own otherwise ("module").  JAX's s4d layouts and its bf16 pre-cast
export are not ported.

The tensor-parallel ViT (parallel/tp.py) exports one program per rank of a
("data", "model") mesh, each with its collectives as ``_c10d_functional``
nodes that name their process group by string, gathered into one artifact
(format ``rsfd-aot-tp-vit-v1``); ``load_tp_vit`` binds a rank's program to
a live mesh only where the shape, the axes and the group names agree with
the exporting ranks' (JAX refuses another mesh shape).  An artifact exported
on one device loads onto another (``torch.export.passes.
move_to_device_pass``): loading takes the card unless given ``device="cpu"``,
so an artifact exported on the CPU serves on the card.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from .. import __version__
from ..utils.device import DeviceLike, resolve_device

DETECTOR_FORMAT = "rsfd-aot-v1"
MODEL_FORMAT = "rsfd-aot-model-v1"
TP_VIT_FORMAT = "rsfd-aot-tp-vit-v1"
TP_VIT_RANK_FORMAT = "rsfd-aot-tp-vit-rank-v1"
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


def _export(fn, state, inputs, meta) -> Tuple[bytes, Dict[str, Any]]:
    """The saved program of ``fn(state, *inputs)`` and its meta."""
    program = _Program(fn)
    with torch.no_grad():
        ep = torch.export.export(program, (state, *inputs))
    ep.example_inputs = None  # they hold the weights, which stay outside the artifact
    meta = dict(meta, framework_version=__version__, torch_version=torch.__version__,
                device=str(inputs[0].device), state=_leaves(state))
    buf = io.BytesIO()
    torch.export.save(ep, buf, extra_files={META_FILE: json.dumps(meta)})
    return buf.getvalue(), meta


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
    return _export(detect, state, (imgs, scales), meta)[0]


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
        return _export(lambda state, x: torch.func.functional_call(module, state, (x,)), state, (batch,), meta)[0]
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
    """A deserialised artifact; call with (state_dict, *inputs).  ``meta``
    is given where ``blob`` is one program of a larger artifact (a rank's
    program of the TP ViT) and read from ``blob`` otherwise."""

    def __init__(self, blob: bytes, fmt: str, device: DeviceLike, meta: Optional[Dict[str, Any]] = None) -> None:
        self.device = resolve_device(device)
        self.meta = _read_meta(blob, fmt) if meta is None else meta
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


# -- the tensor-parallel ViT: one artifact for a mesh, one program per rank --


def _program_file(coordinate: Sequence[int]) -> str:
    return "program_" + "_".join(str(int(c)) for c in coordinate) + ".pt2"


def _mesh_groups(mesh) -> Dict[str, Dict[str, Any]]:
    """This rank's process group on each axis of the mesh: its name (the
    string an exported collective binds to at run time) and its ranks."""
    groups = {}
    for axis in mesh.mesh_dim_names:
        group = mesh.get_group(axis)
        groups[axis] = {"name": group.group_name, "ranks": dist.get_process_group_ranks(group)}
    return groups


def _gather_over_mesh(item, mesh) -> list:
    """Every mesh rank's ``item`` on every rank of the mesh: gathered over
    each axis in turn, innermost first."""
    items = [item]
    for axis in reversed(mesh.mesh_dim_names):
        group = mesh.get_group(axis)
        parts = [None] * dist.get_world_size(group)
        dist.all_gather_object(parts, items, group=group)
        items = [x for part in parts for x in part]
    return items


def export_tp_vit(
    model: nn.Module,
    mesh,
    batch_size: int,
    image_size: Sequence[int] = (224, 224),
    device: DeviceLike = "cuda",
) -> bytes:
    """Serialise the tensor-parallel ViT forward of a ("data", "model") mesh;
    a collective: every rank of the mesh calls it, and each gets the same
    bytes.

    Each rank exports the program ``make_tp_vit_fn`` runs on it
    (parallel/tp.py::TPViTForward): its data index's rows of the whole
    batch, its shards with the two all-reduces over "model" per block, K4
    as one ``rsfd::attention`` node per block, the gather over "data".  The
    program takes the rank's local shards as its first input, so no weight
    is inside the artifact, and its coordinate is a constant of it, so the
    programs differ per rank: they are gathered into one artifact (a zip of
    ``rsfd_meta.json`` and one ``torch.export`` program per coordinate).
    The meta holds JAX's fields (config, classes, batch, image size, mesh
    shape and axes, device count), the image layout ("nchw": (B, 3, S, S)
    float32, where JAX's images are (B, S, S, 3)) and per rank its
    coordinate, its device, its state leaves and the names of its process
    groups, which the exported collectives bind to.  The zip's entries carry
    a fixed date, so the bytes depend only on the programs and the meta.
    ``device``: this rank's (the card unless the caller asks for the CPU)."""
    from ..parallel.mesh import axis_size
    from ..parallel.tp import TPViTForward

    dev = resolve_device(device)
    data = axis_size(mesh, "data")
    if batch_size % data:
        raise ValueError(f"batch {batch_size} not divisible by data axis {data}")
    coordinate = mesh.get_coordinate()
    if coordinate is None:
        raise ValueError("this rank is not in the mesh")
    forward = TPViTForward(model, mesh, dev).eval()
    state = _state_of(forward.model)
    width, height = image_size
    images = torch.zeros((batch_size, 3, height, width), dtype=torch.float32, device=dev)

    def program(state, images):
        return torch.func.functional_call(forward, {f"model.{k}": v for k, v in state.items()}, (images,))

    rank_meta = {"format": TP_VIT_RANK_FORMAT, "coordinate": [int(c) for c in coordinate],
                 "groups": _mesh_groups(mesh)}
    program_bytes, rank_meta = _export(program, state, (images,), rank_meta)
    gathered = sorted(_gather_over_mesh((rank_meta, program_bytes), mesh), key=lambda x: x[0]["coordinate"])
    meta = {
        "format": TP_VIT_FORMAT,
        "framework_version": __version__,
        "torch_version": torch.__version__,
        "config": model.config,
        "num_classes": model.head.out_features,
        "batch_size": batch_size,
        "image_size": [width, height],
        "layout": "nchw",
        "dtype": "float32",
        "mesh_shape": {axis: axis_size(mesh, axis) for axis in mesh.mesh_dim_names},
        "mesh_axes": list(mesh.mesh_dim_names),
        "nr_devices": mesh.size(),
        "ranks": [{k: m[k] for k in ("coordinate", "device", "state", "groups")} for m, _ in gathered],
    }
    files = [(META_FILE, json.dumps(meta).encode())]
    files += [(_program_file(m["coordinate"]), program_bytes) for m, program_bytes in gathered]
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
        for name, data in files:
            info = zipfile.ZipInfo(name, date_time=(1980, 1, 1, 0, 0, 0))
            info.external_attr = 0o644 << 16
            z.writestr(info, data)
    return buf.getvalue()


class LoadedTPViT(_Loaded):
    """This rank's program of an ``export_tp_vit`` artifact, bound to a live
    mesh of the same shape, axes and process groups.

    Call with ``(state_dict, images)``: the UNSHARDED state dict of the
    tower (``prepare_state`` takes the rank's shards of it under the
    Megatron rule, checks them against the artifact and moves them to the
    device, once per state dict) and the whole (B, 3, S, S) batch on every
    rank; returns the whole (B, classes) output on every rank, as JAX's
    ``LoadedTPViT`` does.  Every rank of the mesh calls it together."""

    def __init__(self, blob: bytes, mesh, device: DeviceLike = "cuda") -> None:
        from ..parallel.mesh import axis_size

        device = resolve_device(device)
        meta = _read_meta(blob, TP_VIT_FORMAT)
        shape = {axis: axis_size(mesh, axis) for axis in mesh.mesh_dim_names}
        if shape != meta["mesh_shape"]:
            raise ValueError(f"artifact was exported for mesh {meta['mesh_shape']}, got {shape}")
        if list(mesh.mesh_dim_names) != meta["mesh_axes"]:
            raise ValueError(f"artifact was exported for mesh axes {meta['mesh_axes']}, "
                             f"got {list(mesh.mesh_dim_names)}")
        if mesh.device_type != device.type:
            raise ValueError(f"a mesh of {mesh.device_type} devices for a program on {device}")
        coordinate = mesh.get_coordinate()
        if coordinate is None:
            raise ValueError("this rank is not in the mesh")
        coordinate = [int(c) for c in coordinate]
        entry = next(m for m in meta["ranks"] if m["coordinate"] == coordinate)
        groups = _mesh_groups(mesh)
        for axis, want in entry["groups"].items():
            got = groups[axis]
            if got != want:
                raise ValueError(
                    f"the {axis!r} process group of this rank is {got['name']!r} (ranks {got['ranks']}), the "
                    f"program was exported against {want['name']!r} (ranks {want['ranks']}): build the meshes "
                    "in the order the exporting processes built them")
        with zipfile.ZipFile(io.BytesIO(blob)) as z:
            program_bytes = z.read(_program_file(coordinate))
        super().__init__(program_bytes, TP_VIT_FORMAT, device, dict(meta, device=entry["device"], state=entry["state"]))
        self.mesh = mesh
        self.coordinate = coordinate

    def prepare_state(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The rank's shards of an unsharded state dict
        (parallel/tp.py::tp_shard_view), checked against the artifact's
        leaves (a wrong shape names its leaf) and cast to the traced dtype on
        the program's device: JAX's ``prepare_variables``."""
        from ..parallel.tp import tp_shard_view

        return super().prepare_state(tp_shard_view({k: torch.as_tensor(v) for k, v in state.items()}, self.mesh))

    def __call__(self, state_dict, images) -> torch.Tensor:
        return self._call(state_dict, images)


def load_tp_vit(blob: bytes, mesh, device: DeviceLike = "cuda") -> LoadedTPViT:
    """Re-hydrate this rank's program of an ``export_tp_vit`` artifact onto a
    mesh of the same shape and axes whose process groups were built in the
    same order as the exporting processes built theirs (``make_mesh``, the
    meshes in the same order); ValueError otherwise.  On ``device``: the
    card unless the caller asks for the CPU."""
    return LoadedTPViT(blob, mesh, device)
