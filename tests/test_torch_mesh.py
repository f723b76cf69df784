"""The port's device meshes and FSDP rule (parallel/mesh.py) against the JAX
package's on its 8-device virtual CPU mesh.

The port runs 4 gloo ranks on the CPU as child processes (``run_ranks``,
which the other multi-rank test files import): each child imports torch and
the port only, joins a process group through a FileStore under the test's
tmp_path, and writes its results as an .npz.  Every child has a deadline.

Checked: ``make_mesh`` at world 4 gives JAX's (4, 1) and (2, 2) shapes,
with rank r at (r // mp, r % mp), and raises JAX's ValueErrors (more
devices than ranks, n not divisible by model_parallel); ``fsdp_param_spec``
on JAX's cases; on every leaf of the mnet and of the R50 the dim the port
shards is the one JAX's rule shards on the bridged flax leaf, with the same
shard size, and the port replicates where JAX does; FSDP2's local shards
under ``shard_pytree_fsdp`` are ``fsdp_shard_view`` of the bridged JAX
tree, equal (the same numbers); ``data_sharding`` and ``replicated`` are
JAX's P("data") and P().
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from rs_face_detection_tpu.models.retinaface import init_retinaface
from rs_face_detection_tpu.parallel.mesh import data_sharding as jax_data_sharding
from rs_face_detection_tpu.parallel.mesh import fsdp_param_spec as jax_fsdp_param_spec
from rs_face_detection_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rs_face_detection_tpu.parallel.mesh import replicated as jax_replicated
from rs_face_detection_tpu_torch.models import weights
from deadlines import communicate_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = """
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
RANK, WORLD, WORK = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from rs_face_detection_tpu_torch.parallel.mesh import initialize_distributed
initialize_distributed("file://" + os.path.join(WORK, "store"), WORLD, RANK, device="cpu")
INPUTS = dict(np.load(os.path.join(WORK, "inputs.npz"), allow_pickle=False)) if os.path.exists(
    os.path.join(WORK, "inputs.npz")) else {}
OUT = {}
"""

_EPILOGUE = """
torch.distributed.destroy_process_group()
np.savez(os.path.join(WORK, f"rank{RANK}.npz"), **OUT)
"""


def run_ranks(work, world, body, inputs=None, timeout=150.0, extra_args=()):
    """Run ``body`` (Python source) in ``world`` gloo ranks, children of this
    process, with the prelude above (RANK, WORLD, WORK, INPUTS; results go
    into the dict OUT).  Returns each rank's OUT.  Every rank must exit 0
    within ``timeout`` seconds, or all are killed and the test fails."""
    work = str(work)
    os.makedirs(work, exist_ok=True)
    if inputs is not None:
        np.savez(os.path.join(work, "inputs.npz"), **inputs)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    src = _PRELUDE + body + _EPILOGUE
    procs = [
        subprocess.Popen([sys.executable, "-c", src, str(r), str(world), work, *extra_args], cwd=REPO, env=env,
                         stdin=subprocess.DEVNULL, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)
    ]
    for r, (rc, out, err) in enumerate(communicate_all(procs, timeout)):
        assert rc == 0, f"rank {r} exited {rc}:\n{out[-2000:]}\n{err[-4000:]}"
    results = []
    for r in range(world):
        with np.load(os.path.join(work, f"rank{r}.npz"), allow_pickle=False) as data:
            results.append({k: data[k] for k in data.files})
    return results


def flat_leaves(tree):
    """'/'-joined leaves of a flax tree (the bridge's names)."""
    return weights.flat_variables(jax.tree.map(np.asarray, jax.device_get(tree)))


_MESH_BODY = """
from rs_face_detection_tpu_torch.configs import FaceDetectionConfig
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.parallel.mesh import (
    axis_size, data_sharding, fsdp_param_spec, fsdp_port_dim, fsdp_shard_view, make_mesh, pytree_shardings,
    replicated, shard_pytree_fsdp)
from rs_face_detection_tpu_torch.parallel.train import Trainer
report = {}
for mp in (1, 2):
    mesh = make_mesh(4, model_parallel=mp, device="cpu")
    report[f"shape{mp}"] = [axis_size(mesh, "data"), axis_size(mesh, "model")]
    report[f"coord{mp}"] = list(mesh.get_coordinate())
for args in ((4, 3), (5, 1)):
    try:
        make_mesh(args[0], model_parallel=args[1], device="cpu")
        report[f"error{args}"] = None
    except ValueError as e:
        report[f"error{args}"] = str(e)
mesh = make_mesh(4, model_parallel=2, device="cpu")
report["cases"] = [list(fsdp_param_spec(s, mesh)) for s in ((3, 3, 8, 16), (7,), (), (4, 6))]
report["cases1"] = [list(fsdp_param_spec((3, 3, 8, 16), make_mesh(4, device="cpu")))]
report["data_sharding"] = [[p.is_shard(0), p.is_replicate()] for p in data_sharding(mesh)]
report["replicated"] = [[p.is_shard(0), p.is_replicate()] for p in replicated(mesh)]
for backbone in ("mobilenet025", "resnet50"):
    family = f"retinaface_{backbone}"
    variables = {k[len(backbone) + 1:]: v for k, v in INPUTS.items() if k.startswith(backbone + "/")}
    full = weights.state_dict_from_jax(family, variables)
    view = fsdp_shard_view(weights.build_model(family), full, mesh)
    trainer = Trainer(FaceDetectionConfig(image_size=(64, 64), backbone=backbone), mesh=mesh, device="cpu")
    state = trainer.init_state(variables=variables)
    placements = pytree_shardings(state.model, mesh)
    dims, same = {}, True
    for name, p in state.model.named_parameters():
        d = fsdp_port_dim(p.shape, mesh)
        local = int(p.to_local().shape[d]) if d is not None else -1
        dims[name] = [d, local, str(placements[name][1]) == str(p.placements[1])]
        same = same and torch.equal(p.to_local(), view[name])
    report[family] = {"dims": dims, "local_equal_view": bool(same),
                      "full_shapes": {k: list(v.shape) for k, v in full.items()}}
OUT["report"] = np.asarray(json.dumps(report))
"""


@pytest.fixture(scope="module")
def mesh_report(tmp_path_factory):
    inputs = {}
    for backbone in ("mobilenet025", "resnet50"):
        _, variables = init_retinaface(backbone, (64, 64), seed=0)
        for k, v in flat_leaves(variables).items():
            inputs[f"{backbone}/{k}"] = v
    ranks = run_ranks(tmp_path_factory.mktemp("mesh"), 4, _MESH_BODY, inputs)
    return [json.loads(str(r["report"])) for r in ranks], inputs


def test_make_mesh_matches_jax(mesh_report):
    reports, _ = mesh_report
    for mp in (1, 2):
        jmesh = jax_make_mesh(4, model_parallel=mp)
        for rank, report in enumerate(reports):
            assert report[f"shape{mp}"] == [jmesh.shape["data"], jmesh.shape["model"]]
            assert report[f"coord{mp}"] == [rank // mp, rank % mp]
    with pytest.raises(ValueError) as jax_err:
        jax_make_mesh(4, model_parallel=3)
    for report in reports:
        assert report["error(4, 3)"] == str(jax_err.value)
        assert report["error(5, 1)"] == "requested 5 devices, have 4"


def test_fsdp_param_spec_rules_match_jax(mesh_report):
    reports, _ = mesh_report
    jmesh = jax_make_mesh(8, model_parallel=2)
    want = [list(jax_fsdp_param_spec(s, jmesh)) for s in ((3, 3, 8, 16), (7,), (), (4, 6))]
    assert want == [[None, None, None, "model"], [], [], [None, "model"]]
    for report in reports:
        assert report["cases"] == want
        assert report["cases1"] == [[]]


def test_placements_match_jax(mesh_report):
    """data_sharding splits the batch over "data" and leaves "model"
    replicated (JAX's P("data")); replicated leaves every axis whole (P())."""
    reports, _ = mesh_report
    jmesh = jax_make_mesh(4, model_parallel=2)
    assert tuple(jax_data_sharding(jmesh).spec) == ("data",) and tuple(jax_replicated(jmesh).spec) == ()
    for report in reports:
        assert report["data_sharding"] == [[True, False], [False, True]]  # Shard(0) on "data", Replicate() on "model"
        assert report["replicated"] == [[False, True], [False, True]]


@pytest.mark.parametrize("backbone", ["mobilenet025", "resnet50"])
def test_fsdp_shards_the_axis_jax_shards(mesh_report, backbone):
    """Every parameter of the port's module is sharded on the dim that holds
    the flax axis JAX's rule shards (found by the bridge: a tree that marks
    the sharded axis with its index, bridged), with half the rows on each of
    the 2 "model" ranks; where JAX replicates, so does the rule.  FSDP2's
    local shards are ``fsdp_shard_view`` of the bridged JAX tree."""
    reports, inputs = mesh_report
    family = f"retinaface_{backbone}"
    jmesh = jax_make_mesh(4, model_parallel=2)
    variables = {k[len(backbone) + 1:]: v for k, v in inputs.items() if k.startswith(backbone + "/")}
    # Mark each leaf with the index along the axis JAX shards (0 where it
    # replicates), bridge the marks, and read the port's dim from them.
    marks, sharded = {}, {}
    for name, leaf in variables.items():
        spec = tuple(jax_fsdp_param_spec(leaf.shape, jmesh))
        if "model" in spec:
            axis = spec.index("model")
            shape = [1] * leaf.ndim
            shape[axis] = leaf.shape[axis]
            marks[name] = np.broadcast_to(np.arange(leaf.shape[axis], dtype=np.float32).reshape(shape), leaf.shape)
            sharded[name] = leaf.shape[axis]
        else:
            marks[name] = np.zeros(leaf.shape, np.float32)
    bridged = weights.state_dict_from_jax(family, marks)
    n_sharded = 0
    for report in reports:
        dims = report[family]["dims"]
        assert report[family]["local_equal_view"]
        for name, (dim, local, same_placement) in dims.items():
            assert same_placement, name
            t = bridged[name].numpy()
            if not t.any():  # JAX replicates this leaf
                assert dim is None, name
                continue
            n_sharded += 1
            varying = [d for d in range(t.ndim) if t.shape[d] > 1 and np.ptp(t, axis=d).any()]
            assert varying == [dim], (name, varying, dim)
            assert local * 2 == t.shape[dim], name
    assert n_sharded == 4 * sum(1 for n in sharded if n.startswith("params/"))
