"""The port's sharded RetinaFace train step (parallel/train.py with a mesh,
models/layers.py's global BatchNorm statistics) against the JAX package's
``Trainer(make_mesh(4, model_parallel=mp))`` on its 8-device virtual CPU
mesh, at mp 1 and 2: the port as 4 gloo ranks, a (4, 1) and a (2, 2) mesh.

The mnet at 64x64, global batch 4 (one image per data index at (4, 1), two
at (2, 2)), max_faces 4, from JAX's own init, bridged by models/weights.py;
each rank builds its sharded module through the bridge and FSDP2 and reads
its rows of the batch from ``Trainer.make_batch``.  Two steps, each from
JAX's state before it (tests/test_torch_train.py's method: run free, float32
rounding parts the runs through the signs Adam's first steps take).

Tolerances (those of tests/test_torch_train.py):
- loss rtol 1e-5, the metrics' parts rtol 1e-4, ``num_pos`` equal, the
  metrics the same on every rank;
- the first step's gradients (JAX's read from its Adam moment): at (2, 2),
  two images per data index, per leaf within 1e-4 x max|g| over every leaf;
  at (4, 1), one image per rank, the stem's gradient (raw 0-255 pixels
  times BatchNorm input gradients that sum to 0 only over the global
  batch) cancels across the ranks in both packages: JAX's sharded float32
  gradient is 1.9e-3 x max|g| from float64 and the port's 1.2e-3, where
  the port's one-device step is 1.7e-5 (measured), so there the port's
  gradient must be no farther from the float64 gradient (L2 over every
  leaf) than JAX's, tests/test_torch_train.py's bound for the R50;
- BatchNorm ``running_var`` and ``running_mean`` rtol 1e-5 with atol 1e-5;
- against the port's one-device Trainer on the same global batch: loss rtol
  1e-5, parameters after one step within Adam's 2 x lr;
- per-rank statistics (the global all-reduce switched off) miss JAX's
  running variances by more than 1e-3 at (4, 1);
- ``remat=True`` under the (2, 2) mesh: loss rtol 1e-5 and parameters rtol
  1e-4 / atol 1e-6 of the plain step (JAX's test_remat_train_step_matches).
"""

import jax
import numpy as np
import pytest
import torch

from rs_face_detection_tpu.configs import FaceDetectionConfig as JaxDetectionConfig
from rs_face_detection_tpu.parallel import train as jtrain
from rs_face_detection_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rs_face_detection_tpu_torch.configs import FaceDetectionConfig
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.parallel import train as ptrain
from test_torch_mesh import flat_leaves, run_ranks

FAMILY = "retinaface_mobilenet025"
SIZE = (64, 64)
BATCH = 4
LR = 1e-3


def _jax_run(mp):
    """JAX's Trainer on make_mesh(4, mp) from seed 0, two steps on
    make_batch(seed=i): init variables, batches, and after each step the
    metrics, params, batch_stats and Adam state, as flat leaves."""
    trainer = jtrain.Trainer(jax_make_mesh(4, model_parallel=mp), JaxDetectionConfig(image_size=SIZE),
                             learning_rate=LR)
    state = trainer.init_state(seed=0)
    out = {"init": flat_leaves({"params": state.params, "batch_stats": state.batch_stats})}
    step = trainer.make_train_step()
    for i in range(2):
        batch = trainer.make_batch(BATCH, max_faces=4, seed=i)
        out[f"batch{i}"] = [np.asarray(t) for t in batch[:4]]
        state, metrics = step(state, batch)
        adam = jax.device_get(state.opt_state[0])
        out[f"after{i}"] = {
            "metrics": {k: float(v) for k, v in jax.device_get(metrics).items()},
            "vars": flat_leaves({"params": state.params, "batch_stats": state.batch_stats}),
            "mu": flat_leaves({"params": adam.mu, "batch_stats": state.batch_stats}),
            "nu": flat_leaves({"params": adam.nu, "batch_stats": state.batch_stats}),
            "count": int(adam.count),
        }
    return out


_BODY = """
from torch.distributed.tensor import DTensor, distribute_tensor
from rs_face_detection_tpu_torch.configs import FaceDetectionConfig
from rs_face_detection_tpu_torch.models import layers, weights
from rs_face_detection_tpu_torch.parallel.mesh import data_rows, make_mesh
from rs_face_detection_tpu_torch.parallel.train import Trainer, TrainBatch

FAMILY = "retinaface_mobilenet025"


def tree(prefix):
    return {k[len(prefix) + 1:]: v for k, v in INPUTS.items() if k.startswith(prefix + "/")}


def full(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


def record(tag, state, metrics, grads=True):
    for k, v in metrics.items():
        OUT[f"{tag}/metric/{k}"] = np.asarray(float(v))
    for name, buf in state.model.named_buffers():
        if "running" in name:
            OUT[f"{tag}/buf/{name}"] = buf.detach().numpy()
    for name, p in state.model.named_parameters():
        OUT[f"{tag}/param/{name}"] = full(p).numpy()
        if grads:
            OUT[f"{tag}/grad/{name}"] = full(p.grad).numpy()


def from_jax(trainer, step):
    snap = tree(f"m{MP}/after{step}/vars")
    state = trainer.init_state(variables=snap)
    mu = weights.state_dict_from_jax(FAMILY, tree(f"m{MP}/after{step}/mu"))
    nu = weights.state_dict_from_jax(FAMILY, tree(f"m{MP}/after{step}/nu"))
    count = float(INPUTS[f"m{MP}/after{step}/count"])
    for name, p in state.model.named_parameters():
        state.optimizer.state[p] = {
            "step": torch.tensor(count),
            "exp_avg": distribute_tensor(mu[name].clone(), p.device_mesh, p.placements),
            "exp_avg_sq": distribute_tensor(nu[name].clone(), p.device_mesh, p.placements),
        }
    state.step = int(count)
    return state


cfg = FaceDetectionConfig(image_size=(64, 64))
for MP in (1, 2):
    mesh = make_mesh(4, model_parallel=MP, device="cpu")
    trainer = Trainer(cfg, learning_rate=1e-3, mesh=mesh, device="cpu")
    step = trainer.make_train_step()
    for i in range(2):
        batch = trainer.make_batch(4, max_faces=4, seed=i)
        jb = [INPUTS[f"m{MP}/batch{i}/{j}"][data_rows(mesh, 4)] for j in range(4)]
        OUT[f"m{MP}/rows_equal{i}"] = np.asarray(all(np.array_equal(a.numpy(), b) for a, b in zip(batch, jb)))
        state = trainer.init_state(variables=tree(f"m{MP}/init")) if i == 0 else from_jax(trainer, i - 1)
        state, metrics = step(state, TrainBatch(*batch))
        record(f"m{MP}/step{i}", state, metrics, grads=i == 0)
    if MP == 1:
        # The trap: each rank's own statistics.
        state = trainer.init_state(variables=tree("m1/init"))
        layers.sync_batch_stats(state.model, None)
        state, metrics = step(state, trainer.make_batch(4, max_faces=4, seed=0))
        record("local_stats", state, metrics, grads=False)
    else:
        remat = Trainer(cfg, learning_rate=1e-3, remat=True, mesh=mesh, device="cpu")
        state, metrics = remat.make_train_step()(remat.init_state(variables=tree("m2/init")),
                                                 remat.make_batch(4, max_faces=4, seed=0))
        record("remat", state, metrics, grads=False)
if RANK:  # the gathered parameters are the same on every rank: keep rank 0's
    OUT = {k: v for k, v in OUT.items() if "/metric/" in k or "rows_equal" in k}
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_runs = {mp: _jax_run(mp) for mp in (1, 2)}
    inputs = {}
    for mp, run in jax_runs.items():
        for k, v in run["init"].items():
            inputs[f"m{mp}/init/{k}"] = v
        for i in range(2):
            for j, a in enumerate(run[f"batch{i}"]):
                inputs[f"m{mp}/batch{i}/{j}"] = a
            after = run[f"after{i}"]
            for part in ("vars", "mu", "nu"):
                for k, v in after[part].items():
                    inputs[f"m{mp}/after{i}/{part}/{k}"] = v
            inputs[f"m{mp}/after{i}/count"] = np.asarray(after["count"])
    ranks = run_ranks(tmp_path_factory.mktemp("ptrain"), 4, _BODY, inputs, timeout=240)
    return jax_runs, ranks


def _bridged(flat):
    return weights.state_dict_from_jax(FAMILY, flat)


def _grads_from_mu(after):
    """JAX's first-step gradients: mu / (1 - b1) from a zero moment."""
    flat = {k: (v / np.float32(0.1) if k.startswith("params/") else v) for k, v in after["mu"].items()}
    return _bridged(flat)


def _grads_f64(run):
    """The gradient of the first step's mean loss in float64 (the port's
    one-device loss on the global batch): the exact value both float32 runs
    are held against."""
    trainer = ptrain.Trainer(FaceDetectionConfig(image_size=SIZE), learning_rate=LR, device="cpu")
    model = trainer.init_state(variables=run["init"]).model.double()
    b = trainer.prepare(ptrain.TrainBatch(*run["batch0"]))
    b = ptrain.TrainBatch(*(t.double() if t.is_floating_point() else t for t in b))
    trainer.loss(trainer.forward(model, b.images), b)[0].mean().backward()
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


def _l2(grads, exact):
    return float(np.sqrt(sum(((grads[n].astype(np.float64) - g) ** 2).sum() for n, g in exact.items())))


def _port(rank, tag, kind):
    prefix = f"{tag}/{kind}/"
    return {k[len(prefix):]: v for k, v in rank.items() if k.startswith(prefix)}


def _bn_close(bufs, ref):
    for name, buf in bufs.items():
        np.testing.assert_allclose(buf, ref[name].numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("mp", [1, 2], ids=["mesh4x1", "mesh2x2"])
@pytest.mark.parametrize("step", [0, 1])
def test_sharded_step_matches_jax(runs, mp, step):
    """Each step from JAX's state before it: the loss, the metrics (the same
    on every rank: global means), the BatchNorm buffers; at the first step
    the gradients.  Every rank's rows are its data index's rows of JAX's
    global batch."""
    jax_runs, ranks = runs
    after = jax_runs[mp][f"after{step}"]
    tag = f"m{mp}/step{step}"
    for rank in ranks:
        assert bool(rank[f"m{mp}/rows_equal{step}"])
        metrics = _port(rank, tag, "metric")
        np.testing.assert_allclose(metrics["loss"], after["metrics"]["loss"], rtol=1e-5)
        for k in ("cls_loss", "box_loss", "lm_loss"):
            np.testing.assert_allclose(metrics[k], after["metrics"][k], rtol=1e-4, err_msg=k)
        assert float(metrics["num_pos"]) == after["metrics"]["num_pos"]
        assert metrics == _port(ranks[0], tag, "metric")
    _bn_close(_port(ranks[0], tag, "buf"), _bridged(after["vars"]))
    if step == 0:
        jax_grads = {n: g.numpy() for n, g in _grads_from_mu(after).items()}
        grads = _port(ranks[0], tag, "grad")
        if mp == 2:
            scale = max(float(np.abs(g).max()) for g in jax_grads.values())
            err = max(float(np.abs(g - jax_grads[n]).max()) for n, g in grads.items())
            assert err <= 1e-4 * scale, err / scale
        else:
            exact = _grads_f64(jax_runs[mp])
            mine, theirs = (_l2(g, exact) for g in (grads, jax_grads))
            assert mine <= theirs, (mine, theirs)


@pytest.mark.parametrize("mp", [1, 2], ids=["mesh4x1", "mesh2x2"])
def test_sharded_step_matches_one_device(runs, mp):
    """The same global batch through the port's one-device Trainer: the loss
    within rtol 1e-5 and the parameters after one step within 2 x lr (Adam
    moves each by at most ~lr, and the runs may part by a sign)."""
    jax_runs, ranks = runs
    trainer = ptrain.Trainer(FaceDetectionConfig(image_size=SIZE), learning_rate=LR, device="cpu")
    state = trainer.init_state(variables=jax_runs[mp]["init"])
    state, metrics = trainer.make_train_step()(state, ptrain.TrainBatch(*jax_runs[mp]["batch0"]))
    port = _port(ranks[0], f"m{mp}/step0", "metric")
    np.testing.assert_allclose(port["loss"], float(metrics["loss"]), rtol=1e-5)
    params = _port(ranks[0], f"m{mp}/step0", "param")
    err = max(float(np.abs(params[n] - p.detach().numpy()).max()) for n, p in state.model.named_parameters())
    assert err <= 2 * LR, err


def test_per_rank_batch_stats_miss_jax(runs):
    """Without the global statistics each rank normalizes its own image: the
    running variances miss JAX's (global batch) by more than 1e-3, where the
    global ones meet 1e-5 (test_sharded_step_matches_jax)."""
    jax_runs, ranks = runs
    ref = _bridged(jax_runs[1]["after0"]["vars"])
    bufs = _port(ranks[0], "local_stats", "buf")
    err = max(float((np.abs(b - ref[n].numpy()) / np.abs(ref[n].numpy())).max())
              for n, b in bufs.items() if n.endswith("running_var"))
    assert err > 1e-3, err


def test_remat_step_matches_under_the_mesh(runs):
    _, ranks = runs
    plain, remat = _port(ranks[0], "m2/step0", "metric"), _port(ranks[0], "remat", "metric")
    np.testing.assert_allclose(remat["loss"], plain["loss"], rtol=1e-5)
    p_plain, p_remat = _port(ranks[0], "m2/step0", "param"), _port(ranks[0], "remat", "param")
    for name, p in p_plain.items():
        np.testing.assert_allclose(p_remat[name], p, rtol=1e-4, atol=1e-6, err_msg=name)
    _bn_close(_port(ranks[0], "remat", "buf"),
              {k: torch.from_numpy(v) for k, v in _port(ranks[0], "m2/step0", "buf").items()})
