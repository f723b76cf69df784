"""Tensor parallelism for the ViT eKYC towers (Megatron's layout).

Counterpart of rs_face_detection_tpu/parallel/tp.py.  The JAX package
annotates the parameters' shardings and lets GSPMD insert the collectives;
the port shards the weights itself, one process per rank of a ("data",
"model") mesh (parallel/mesh.py::make_mesh), and writes the two
all-reduces of each block out:

  - ``attn.in_proj_weight`` / ``in_proj_bias``: column-parallel by heads
    within each of q, k and v.  The packed rows are [q | k | v], each
    (heads, head_dim) head-major, so the tensor is read as (3, H, D, W) and
    split along H: rank r holds rows r W/tp .. (r + 1) W/tp of each third.
    Each rank computes its own heads end to end, and K4 (ops/attention.py)
    runs on the local (B, N, H/tp, D) q, k and v, plain tensors;
  - ``attn.out_proj``: row-parallel (the columns of its weight that meet
    the rank's heads), then one all-reduce over "model", then the bias,
    added once;
  - ``mlp.c_fc``: column-parallel (rows of its weight and bias); the GELU
    runs on the rank's share of the hidden width;
  - ``mlp.c_proj``: row-parallel, one all-reduce, the bias once;
  - everything else (LayerNorms, embeddings, the patchify conv, the head)
    replicated, so the residual stream is the single-device one up to the
    order of the sums.

The batch is split over "data": each rank runs its data index's rows and
the results are gathered over "data", so ``fn`` returns the whole batch's
rows on every rank, as the JAX function returns the global array.

JAX refuses ``fused_attention=True`` under TP (GSPMD cannot partition the
Pallas call); the port's ViT always calls K4, which takes the local heads
as they are, so it has no such switch to refuse.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..models.vit import CONFIGS, ViT
from ..utils.device import DeviceLike, resolve_device, to_device
from .mesh import Spec, axis_index, axis_size, data_rows

#: The packed q/k/v tensors: "model" on their dim 0 shards each third apart.
_PACKED = ("attn.in_proj_weight", "attn.in_proj_bias")


def vit_tp_param_spec(name: str, shape: Sequence[int], mesh: DeviceMesh) -> Spec:
    """Megatron sharding rule for one ViT parameter, by its CLIP name (such
    as ``transformer.resblocks.3.attn.in_proj_weight``): "model" on the dim
    that is split, () where the parameter is replicated.  A packed
    ``in_proj_*`` is split along dim 0 within each of q, k and v."""
    if axis_size(mesh, "model") == 1:
        return ()
    leaf = name.rsplit(".", 1)[-1]
    if name.endswith(_PACKED):
        return ("model", None) if leaf == "in_proj_weight" else ("model",)
    if ".attn.out_proj." in name or ".mlp.c_proj." in name:
        # (out, in) weight: contraction over the sharded input; bias whole.
        return (None, "model") if leaf == "weight" else ()
    if ".mlp.c_fc." in name:
        return ("model", None) if leaf == "weight" else ("model",)
    return ()


def vit_tp_shardings(model: nn.Module, mesh: DeviceMesh) -> Dict[str, Spec]:
    """The rule for every parameter of a ViT: {name: spec}."""
    return {name: vit_tp_param_spec(name, p.shape, mesh) for name, p in model.named_parameters()}


def check_tp_compatible(heads: int, hidden: int, mesh: DeviceMesh) -> None:
    model = axis_size(mesh, "model")
    if heads % model:
        raise ValueError(f"{heads} attention heads not divisible by model axis {model}")
    if hidden % model:
        raise ValueError(f"MLP hidden {hidden} not divisible by model axis {model}")


def tp_local(name: str, tensor: torch.Tensor, spec: Spec, parts: int, index: int) -> torch.Tensor:
    """Part ``index`` of ``parts`` of one parameter under its spec."""
    if "model" not in spec:
        return tensor
    dim = spec.index("model")
    if name.endswith(_PACKED):
        return torch.cat([third.chunk(parts, 0)[index] for third in tensor.chunk(3, 0)], 0)
    return tensor.chunk(parts, dim)[index]


def tp_shard_view(state_dict: Dict[str, torch.Tensor], mesh: DeviceMesh) -> Dict[str, torch.Tensor]:
    """This rank's local tensors of a whole ViT ``state_dict`` (e.g.
    models/weights.py::state_dict_from_jax of a JAX tree) under
    ``vit_tp_param_spec``, at its "model" index: what ``shard_vit`` holds."""
    parts, index = axis_size(mesh, "model"), axis_index(mesh, "model")
    return {k: tp_local(k, v, vit_tp_param_spec(k, v.shape, mesh), parts, index) for k, v in state_dict.items()}


class RowParallelLinear(nn.Module):
    """The rank's columns of a linear layer's weight: the partial product,
    summed over ``group`` by an all-reduce (in float32), then the whole bias
    once.  Its parameters keep ``nn.Linear``'s names.  Inference only: the
    all-reduce carries no gradient."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor, group) -> None:
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = nn.Parameter(bias, requires_grad=False)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight).float()
        dist.all_reduce(y, group=self.group)
        return (y + self.bias.float()).to(x.dtype)


def shard_vit(model: ViT, mesh: DeviceMesh, device: DeviceLike = "cuda") -> ViT:
    """A copy of ``model`` holding this rank's shards under the rule, on
    ``device``: its blocks compute the rank's heads and MLP columns, with
    the two all-reduces over "model"."""
    tp, index = axis_size(mesh, "model"), axis_index(mesh, "model")
    dev = resolve_device(device)
    local = {
        name: tp_local(name, p.detach(), vit_tp_param_spec(name, p.shape, mesh), tp, index)
        for name, p in model.named_parameters()
    }
    sharded = copy.deepcopy(model)
    if tp > 1:
        group = mesh.get_group("model")
        for i, block in enumerate(sharded.transformer.resblocks):
            prefix = f"transformer.resblocks.{i}"
            block.attn.heads //= tp
            block.attn.out_proj = RowParallelLinear(
                local[f"{prefix}.attn.out_proj.weight"], local[f"{prefix}.attn.out_proj.bias"], group)
            width = block.mlp.c_fc.in_features
            block.mlp.c_fc = nn.Linear(width, local[f"{prefix}.mlp.c_fc.bias"].shape[0])
            block.mlp.c_proj = RowParallelLinear(
                local[f"{prefix}.mlp.c_proj.weight"], local[f"{prefix}.mlp.c_proj.bias"], group)
    for name, p in sharded.named_parameters():
        p.data = local[name].to(dev).clone()
        p.requires_grad_(False)
    return sharded.to(dev).eval()


class TPViTForward(nn.Module):
    """One rank's program of the tensor-parallel forward: its data index's
    rows of the whole batch (``data_rows``), the rank's shards of the tower
    (``model``, from ``shard_vit`` on ``device``), then the gather over
    "data".  The live function of ``make_tp_vit_fn`` and the exported
    program of runtime/aot.py::export_tp_vit both run it."""

    def __init__(self, model: ViT, mesh: DeviceMesh, device: DeviceLike = "cuda") -> None:
        super().__init__()
        dev = resolve_device(device)
        if mesh.device_type != dev.type:
            raise ValueError(f"a mesh of {mesh.device_type} devices for a ViT on {dev}")
        cfg = CONFIGS[model.config]
        check_tp_compatible(cfg.heads, cfg.width * 4, mesh)
        self.model = shard_vit(model, mesh, dev)
        self.mesh = mesh
        self.data = axis_size(mesh, "data")
        self.data_group = mesh.get_group("data") if self.data > 1 else None

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        out = self.model(images[data_rows(self.mesh, images.shape[0])]).contiguous()
        if self.data_group is None:
            return out
        parts = [torch.empty_like(out) for _ in range(self.data)]
        dist.all_gather(parts, out, group=self.data_group)
        return torch.cat(parts)


def make_tp_vit_fn(
    model: ViT, mesh: DeviceMesh, device: DeviceLike = "cuda"
) -> Tuple[Callable[[torch.Tensor], torch.Tensor], ViT]:
    """A ViT forward with the batch split over "data" and the weights over
    "model", on this rank's ``device`` (the card by default).

    Returns (fn, sharded_model): ``fn(images)`` takes the whole (B, 3, S,
    S) batch on every rank (B divisible by the "data" axis), runs the data
    index's rows through the rank's shards (one all-reduce after
    ``out_proj`` and one after ``c_proj`` in each block: 2 per block, the
    Megatron schedule) and returns the whole batch's (B, classes) output on
    every rank, gathered over "data" (``TPViTForward``).
    """
    dev = resolve_device(device)
    forward = TPViTForward(model, mesh, dev)

    def fn(images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return forward(to_device(images, dev))

    return fn, forward.model
