"""Process groups, device meshes and the FSDP sharding rule.

Counterpart of rs_face_detection_tpu/parallel/mesh.py.  The JAX package runs
one controller over a ``jax.sharding.Mesh`` of ("data", "model") and lets
GSPMD insert the collectives; the port runs one process per card under
``torch.distributed`` and builds a 2-D ``DeviceMesh`` of the same axes over
the ranks:

  - "data": the batch is split over it (data parallelism); ranks that share
    a data index hold the same rows;
  - "model": parameters are sharded over it (FSDP, ZeRO-style), by the JAX
    package's rule (``fsdp_param_spec``), handed to FSDP2's ``fully_shard``
    as its ``shard_placement_fn`` (``shard_pytree_fsdp``).  FSDP2 then
    all-gathers the parameters over "model" for the forward and backward
    and reduce-scatters the gradients, and averages them over "data".

The ViT's tensor parallelism over the same mesh is parallel/tp.py.

The rule is JAX's on the flax shape of each parameter: the port's tensors
hold the same numbers in PyTorch's layout (conv kernels OIHW where flax
keeps HWIO, linear weights (out, in) where flax keeps (in, out):
models/weights.py), so the rule is applied to the flax shape and its axis
mapped back to the port's dimension.  The port therefore shards the very
axis JAX shards, with JAX's tie-break: on a square kernel JAX shards the
output features, and so does the port.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..utils.device import DeviceLike, resolve_device

#: A parameter's sharding in the JAX package's PartitionSpec notation: one
#: entry per axis, "model" on the sharded axis, () when replicated.
Spec = Tuple[Optional[str], ...]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = "cuda",
) -> None:
    """Join this process to the job's default process group.

    ``coordinator_address``: "host:port" (a TCP rendezvous) or a full
    ``init_method`` URL such as "file:///path/store"; ``num_processes`` and
    ``process_id``: the world size and this rank.  Each one not given comes
    from ``torchrun``'s environment (MASTER_ADDR and MASTER_PORT, WORLD_SIZE,
    RANK).  On the card the backend is NCCL and the process takes card
    LOCAL_RANK modulo the cards present; with ``device="cpu"`` it is gloo.
    Asking for the card on a host without CUDA raises, as
    utils/device.py::resolve_device does.
    """
    dev = resolve_device(device)
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method, world_size=num_processes, rank=process_id,
    )


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    axis_names: Sequence[str] = ("data", "model"),
    device: DeviceLike = "cuda",
) -> DeviceMesh:
    """A (n / model_parallel, model_parallel) ``DeviceMesh`` of the first n
    ranks of the default process group (all of them by default), with the
    rank's card, or the CPU with ``device="cpu"``.  Rank r sits at (r //
    model_parallel, r % model_parallel), as JAX's device r does."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed first")
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    grid = torch.arange(n).reshape(n // model_parallel, model_parallel)
    return DeviceMesh(dev.type, grid, mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The size of one named axis of the mesh (JAX's ``mesh.shape[name]``)."""
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def axis_index(mesh: DeviceMesh, name: str) -> int:
    """This rank's coordinate on one named axis of the mesh."""
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(name)]


def data_rows(mesh: Optional[DeviceMesh], batch_size: int) -> slice:
    """This rank's rows of a global batch of ``batch_size``: its data
    index's equal share (all of it without a mesh).  Ranks that share a
    data index share the rows."""
    if mesh is None:
        return slice(0, batch_size)
    data = axis_size(mesh, "data")
    if batch_size % data:
        raise ValueError(f"batch {batch_size} not divisible by the data axis {data}")
    per = batch_size // data
    index = axis_index(mesh, "data")
    return slice(index * per, (index + 1) * per)


def data_sharding(mesh: DeviceMesh) -> Tuple:
    """Placements of a batch: its leading dim split over "data",
    replicated over "model".  Kept under the JAX package's name; the port's
    Trainer and loader take a rank's rows with ``data_rows`` and hold them
    as plain tensors."""
    return tuple(Shard(0) if name == "data" else Replicate() for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> Tuple:
    """Placements of a tensor whole on every rank (JAX's ``replicated``)."""
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def fsdp_param_spec(shape: Sequence[int], mesh: DeviceMesh) -> Spec:
    """ZeRO-style rule, the JAX package's: shard the largest axis divisible
    by the "model" axis size (the last of equal ones); replicate parameters
    too small to shard, and everything when "model" is 1."""
    model = axis_size(mesh, "model")
    if model == 1:
        return ()
    candidates = [(dim, axis) for axis, dim in enumerate(shape) if dim % model == 0 and dim >= model]
    if not candidates:
        return ()
    _, axis = max(candidates)
    spec = [None] * len(shape)
    spec[axis] = "model"
    return tuple(spec)


def flax_shape(shape: Sequence[int]) -> Tuple[int, ...]:
    """The flax shape of a port tensor: OIHW -> HWIO, (out, in) -> (in, out)."""
    shape = tuple(shape)
    if len(shape) == 4:
        o, i, h, w = shape
        return (h, w, i, o)
    if len(shape) == 2:
        return shape[::-1]
    return shape


#: The port's dim of each flax axis, by rank: HWIO -> OIHW, (in, out) -> (out, in).
_PORT_DIM = {4: (2, 3, 1, 0), 2: (1, 0)}


def fsdp_port_dim(shape: Sequence[int], mesh: DeviceMesh) -> Optional[int]:
    """The port tensor's dim that ``fsdp_param_spec`` shards on its flax
    shape, or None where JAX replicates it."""
    spec = fsdp_param_spec(flax_shape(shape), mesh)
    if "model" not in spec:
        return None
    axis = spec.index("model")
    return _PORT_DIM.get(len(spec), tuple(range(len(spec))))[axis]


def fsdp_placement(shape: Sequence[int], mesh: DeviceMesh) -> Shard:
    """The ``fully_shard`` placement of one parameter over the "model" axis.
    Where JAX replicates (a "model" axis of 1, or no axis divisible by it),
    FSDP2, which has no replicated parameter inside a sharded group, takes
    dim 0: over an axis of 1 that holds the whole tensor on every rank, and
    otherwise it is a padded split of a tensor with fewer rows than ranks
    (the numbers are the same; the memory per rank differs from JAX's)."""
    dim = fsdp_port_dim(shape, mesh)
    return Shard(0 if dim is None else dim)


def fsdp_shard_view(module: nn.Module, state_dict: Dict[str, torch.Tensor], mesh: DeviceMesh) -> Dict[str, torch.Tensor]:
    """This rank's local tensors of a whole ``state_dict`` of ``module``
    (e.g. models/weights.py::state_dict_from_jax of a JAX tree) as
    ``shard_pytree_fsdp`` leaves them: each parameter's chunk at the rank's
    "model" index on the dim ``fsdp_placement`` names (empty past the last
    chunk, as FSDP2's padded split holds it), the buffers whole."""
    parts, index = axis_size(mesh, "model"), axis_index(mesh, "model")
    params = {name for name, _ in module.named_parameters()}
    out = {}
    for k, v in state_dict.items():
        if k in params:
            chunks = v.chunk(parts, fsdp_placement(v.shape, mesh).dim)
            v = chunks[index] if index < len(chunks) else v.new_empty((0, *v.shape[1:]))
        out[k] = v
    return out


def shard_pytree_fsdp(module: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Shard a module's parameters over the mesh under the FSDP rule (in
    place): FSDP2's ``fully_shard`` over the ("data", "model") mesh, which
    replicates over "data" and shards over "model", each parameter on the
    dim ``fsdp_placement`` names.  Returns the module, whose parameters are
    then DTensors."""
    from torch.distributed.fsdp import fully_shard

    fully_shard(module, mesh=mesh, shard_placement_fn=lambda p: fsdp_placement(p.shape, mesh))
    return module


def pytree_shardings(module: nn.Module, mesh: DeviceMesh) -> Dict[str, Tuple]:
    """The placements ``shard_pytree_fsdp`` gives each parameter of a module:
    {name: (Replicate() over "data", fsdp_placement over "model")}."""
    return {
        name: tuple(fsdp_placement(p.shape, mesh) if axis == "model" else Replicate() for axis in mesh.mesh_dim_names)
        for name, p in module.named_parameters()
    }
