"""Sharded train-state checkpoints (parallel/checkpoint.py over a Trainer
with a mesh), 4 gloo ranks on the CPU.

JAX's tests/test_checkpoint.py cases, on the port's sharded state:
- at (2, 2), a step, ``save_train_state`` by every rank, ``latest_step``,
  then the next step resumed from a fresh template's restore and continued
  in memory: the loss and every parameter, buffer and Adam moment
  ``torch.equal`` (tests/test_torch_train_checkpoint.py's bound on one
  device; JAX's is rtol 1e-5);
- the (2, 2) checkpoint restored onto a (4, 1) mesh and onto one device (a
  Trainer without a mesh, in this process): every parameter, buffer and
  Adam moment equal to the saved state's;
- a restore from a directory with no checkpoint raises FileNotFoundError,
  sharded and on one device, and ``latest_step`` of a missing directory is
  None.
"""

import os

import numpy as np
import pytest
import torch

from rs_face_detection_tpu_torch.configs import FaceDetectionConfig
from rs_face_detection_tpu_torch.parallel.checkpoint import latest_step, restore_train_state
from rs_face_detection_tpu_torch.parallel.train import Trainer
from test_torch_mesh import run_ranks

_BODY = """
from torch.distributed.tensor import DTensor
from rs_face_detection_tpu_torch.configs import FaceDetectionConfig
from rs_face_detection_tpu_torch.parallel.checkpoint import latest_step, restore_train_state, save_train_state
from rs_face_detection_tpu_torch.parallel.mesh import make_mesh
from rs_face_detection_tpu_torch.parallel.train import Trainer

ckpt = os.path.join(WORK, "ckpt")
cfg = FaceDetectionConfig(image_size=(64, 64))


def full(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()


def snapshot(state):
    out = {f"model/{k}": full(v) for k, v in state.model.state_dict().items()}
    params = dict(state.model.named_parameters())
    for name, p in params.items():
        for k, v in state.optimizer.state[p].items():
            out[f"optim/{name}/{k}"] = full(v)
    return out


def same(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


mesh = make_mesh(4, model_parallel=2, device="cpu")
trainer = Trainer(cfg, learning_rate=1e-3, mesh=mesh, device="cpu")
step = trainer.make_train_step()
batch = trainer.make_batch(4, max_faces=4, seed=0)
state, _ = step(trainer.init_state(seed=0), batch)
save_train_state(ckpt, state)
OUT["latest"] = np.asarray(latest_step(ckpt))
saved = snapshot(state)

restored = restore_train_state(ckpt, trainer.init_state(seed=1))
OUT["restored_step"] = np.asarray(restored.step)
OUT["restored_equal"] = np.asarray(same(snapshot(restored), saved))
cont_mem, m_mem = step(state, batch)
cont_ckpt, m_ckpt = step(restored, trainer.make_batch(4, max_faces=4, seed=0))
OUT["resume_loss_equal"] = np.asarray(torch.equal(m_mem["loss"], m_ckpt["loss"]))
OUT["resume_equal"] = np.asarray(same(snapshot(cont_mem), snapshot(cont_ckpt)))

other = Trainer(cfg, learning_rate=1e-3, mesh=make_mesh(4, device="cpu"), device="cpu")
onto = restore_train_state(ckpt, other.init_state(seed=2))
OUT["onto_4x1_equal"] = np.asarray(same(snapshot(onto), saved))
try:
    restore_train_state(os.path.join(WORK, "empty"), trainer.init_state(seed=0))
    OUT["missing_raises"] = np.asarray(False)
except FileNotFoundError:
    OUT["missing_raises"] = np.asarray(True)
if RANK == 0:
    for k, v in saved.items():
        OUT["saved/" + k] = v.numpy()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("pckpt")
    os.makedirs(work / "empty")
    return work, run_ranks(work, 4, _BODY, timeout=180)


def test_sharded_checkpoint_resumes_training(ranks):
    _, results = ranks
    for r in results:
        assert int(r["latest"]) == 1 and int(r["restored_step"]) == 1
        assert bool(r["restored_equal"])
        assert bool(r["resume_loss_equal"]) and bool(r["resume_equal"])


def test_sharded_checkpoint_restores_onto_another_mesh(ranks):
    _, results = ranks
    assert all(bool(r["onto_4x1_equal"]) for r in results)


def test_sharded_checkpoint_restores_onto_one_device(ranks):
    work, results = ranks
    saved = {k[len("saved/"):]: v for k, v in results[0].items() if k.startswith("saved/")}
    trainer = Trainer(FaceDetectionConfig(image_size=(64, 64)), learning_rate=1e-3, device="cpu")
    state = restore_train_state(str(work / "ckpt"), trainer.init_state(seed=3))
    assert state.step == 1
    got = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for name, p in state.model.named_parameters():
        for k, v in state.optimizer.state[p].items():
            got[f"optim/{name}/{k}"] = v
    assert got.keys() == saved.keys()
    for k, v in got.items():
        assert np.array_equal(v.numpy(), saved[k]), k


def test_restore_missing_raises(ranks, tmp_path):
    _, results = ranks
    assert all(bool(r["missing_raises"]) for r in results)
    template = Trainer(FaceDetectionConfig(image_size=(64, 64)), device="cpu").init_state(seed=0)
    with pytest.raises(FileNotFoundError):
        restore_train_state(str(tmp_path), template)
    assert latest_step(str(tmp_path / "nope")) is None
