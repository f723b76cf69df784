"""The training entry point under torchrun: ``python -m
torch.distributed.run --standalone --nproc-per-node 2 -m
rs_face_detection_tpu_torch.tools.train_detector ... --device cpu`` (gloo),
2 steps at 64x64 on a labels file the test writes, against the same flags
in one process.

- the .npz, written once: its parameters within Adam's bound of the
  one-process run's (2 runs x 2 steps x 1.01 lr: each step moves a
  parameter by at most ~lr, and float32 rounding may sign a near-zero
  gradient differently), its BatchNorm running statistics within rtol 1e-3
  / atol 1e-3 of them (the second step's statistics are taken at weights
  that differ by that bound), the same keys;
- the first step's logged loss equal to the one-process run's to the 4
  decimals the log prints (within 1e-4), each log line printed once (rank
  0 only);
- both ranks saved their shards of the train state under ``<dir>/2``;
- ``--batch`` not divisible by the 2 processes exits non-zero with the
  JAX tool's message.
Every launch has a deadline of 150 s.
"""

import os
import re
import subprocess
import sys

import cv2
import numpy as np
import pytest

from rs_face_detection_tpu_torch.tools import train_detector
from deadlines import communicate_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3


def _dataset(tmp_path, n=8):
    root = tmp_path / "data"
    (root / "s").mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = []
    for i in range(n):
        rel = f"s/im{i}.jpg"
        cv2.imwrite(str(root / rel), rng.integers(0, 255, (96, 96, 3), dtype=np.uint8))
        lines += [f"# {rel}", f"{10 + i} 20 40 40 30.0 30.0 0.0 50.0 30.0 0.0 40.0 45.0 0.0 32.0 52.0 0.0 48.0 52.0 0.0 1.0"]
    labels = tmp_path / "label.txt"
    labels.write_text("\n".join(lines) + "\n")
    return root, labels


def _flags(root, labels, out, ckpt, batch=2):
    return ["--labels", str(labels), "--images", str(root), "--out", str(out), "--size", "64x64", "--batch",
            str(batch), "--steps", "2", "--log-every", "1", "--checkpoint-dir", str(ckpt), "--save-every", "1",
            "--device", "cpu"]


def _torchrun(flags):
    """torchrun and its ranks in a session of their own, all killed if the
    launch passes its deadline (a rank must not outlive the test)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "rs_face_detection_tpu_torch.tools.train_detector", *flags]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    ((rc, out, err),) = communicate_all([proc], 150, what="torchrun")
    return subprocess.CompletedProcess(cmd, rc, out, err)


def _losses(text):
    return [float(m) for m in re.findall(r"^step \d+: loss=([0-9.]+)", text, re.M)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_cli")
    root, labels = _dataset(tmp)
    dist = _torchrun(_flags(root, labels, tmp / "dist.npz", tmp / "dist_ckpt"))
    assert dist.returncode == 0, dist.stdout[-3000:] + dist.stderr[-3000:]
    return tmp, root, labels, dist


def test_torchrun_matches_one_process(runs, capsys):
    tmp, root, labels, dist = runs
    assert train_detector.main(_flags(root, labels, tmp / "one.npz", tmp / "one_ckpt")) == 0
    one_log = capsys.readouterr().out
    assert dist.stdout.count("wrote ") == 1 and one_log.count("wrote ") == 1
    assert len(_losses(dist.stdout)) == 2 and len(_losses(one_log)) == 2
    assert abs(_losses(dist.stdout)[0] - _losses(one_log)[0]) <= 1e-4
    with np.load(tmp / "dist.npz") as d, np.load(tmp / "one.npz") as o:
        assert sorted(d.files) == sorted(o.files)
        bound = 2 * 2 * 1.01 * LR
        for k in o.files:
            if k.startswith("params/"):
                assert float(np.abs(d[k] - o[k]).max()) <= bound, k
            else:
                np.testing.assert_allclose(d[k], o[k], rtol=1e-3, atol=1e-3, err_msg=k)


def test_every_rank_saves_its_shards(runs):
    tmp, _, _, _ = runs
    files = os.listdir(tmp / "dist_ckpt" / "2")
    assert {"__0_0.distcp", "__1_0.distcp"} <= set(files), files


def test_batch_not_divisible_by_processes_exits(runs):
    tmp, root, labels, _ = runs
    proc = _torchrun(_flags(root, labels, tmp / "bad.npz", tmp / "bad_ckpt", batch=3))
    assert proc.returncode != 0
    assert "--batch 3 not divisible by 2 processes" in proc.stdout + proc.stderr
    assert not (tmp / "bad.npz").exists()
