"""Train-state checkpoints (parallel/checkpoint.py): the tests of
tests/test_checkpoint.py on the port.  A resume equals continuing in
memory bit for bit on the CPU (``torch.equal``): parameters, BatchNorm
buffers, Adam moments and step counts, and the EMA."""

import numpy as np
import pytest
import torch

from rs_face_detection_tpu_torch.configs import FaceDetectionConfig
from rs_face_detection_tpu_torch.parallel.checkpoint import latest_step, restore_train_state, save_train_state
from rs_face_detection_tpu_torch.parallel.train import Trainer

torch.set_num_threads(2)


def _trainer():
    return Trainer(FaceDetectionConfig(image_size=(64, 64)), learning_rate=1e-3, warmup_steps=1, total_steps=6,
                   ema_decay=0.9, device="cpu")


def _assert_same_state(a, b):
    assert a.step == b.step
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    for ka, va in a.ema_params.items():
        assert torch.equal(va, b.ema_params[ka]), ka
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


@pytest.mark.parametrize("saved_at", [0, 2])
def test_checkpoint_roundtrip_resumes_training(tmp_path, saved_at):
    """Save after ``saved_at`` steps (0: before any update, when the
    optimizer has no state yet), restore into a fresh Trainer's state, and
    take two more steps: the same losses and state as continuing in memory."""
    trainer = _trainer()
    state = trainer.init_state(seed=0)
    step = trainer.make_train_step()
    batches = [trainer.make_batch(2, max_faces=4, seed=s) for s in range(saved_at + 2)]
    for b in batches[:saved_at]:
        state, _ = step(state, b)
    path = save_train_state(str(tmp_path), state)
    assert path.endswith(str(saved_at)) and latest_step(str(tmp_path)) == saved_at
    assert (not state.optimizer.state) is (saved_at == 0)

    fresh = _trainer()
    restored = restore_train_state(str(tmp_path), fresh.init_state(seed=1))
    assert restored.step == saved_at
    _assert_same_state(state, restored)
    fresh_step = fresh.make_train_step()
    for b in batches[saved_at:]:
        state, mm = step(state, b)
        restored, mc = fresh_step(restored, b)
        assert torch.equal(mm["loss"], mc["loss"])
    _assert_same_state(state, restored)


def test_restore_missing_raises(tmp_path):
    template = _trainer().init_state(seed=0)
    with pytest.raises(FileNotFoundError):
        restore_train_state(str(tmp_path), template)
    with pytest.raises(FileNotFoundError):
        restore_train_state(str(tmp_path), template, step=3)
    assert latest_step(str(tmp_path / "nope")) is None


def test_restore_picks_the_latest_or_the_named_step(tmp_path):
    trainer = _trainer()
    state = trainer.init_state(seed=0)
    step = trainer.make_train_step()
    saved = {}
    for s in (1, 2, 3):
        state, m = step(state, trainer.make_batch(2, max_faces=4, seed=s))
        save_train_state(str(tmp_path), state)
        saved[s] = {k: v.clone() for k, v in state.model.state_dict().items()}
    assert latest_step(str(tmp_path)) == 3
    for want in (None, 1):
        got = restore_train_state(str(tmp_path), trainer.init_state(seed=0), step=want)
        assert got.step == (want or 3)
        assert all(torch.equal(v, saved[got.step][k]) for k, v in got.model.state_dict().items())
    assert np.isfinite(float(m["loss"]))
