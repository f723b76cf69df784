"""The accuracy gate of the port's detector: the port's WIDER entry point
(``python -m rs_face_detection_tpu_torch.tools.eval_wider --device cpu
--split all``) on the real-pixel collage trees of
tools/make_collage_set.build_collage_set, scored by the port's own
ops/wider_split.py, with the gates of tests/test_real_collage.py:

  - the 64-px fixture (``trained_real64.npz``, 20 collages at seed 0):
    single-scale >= 0.90/0.90/0.80 easy/medium/hard, one by one and through
    the batched DetectionServer; 64+96 without flip: hard >= single - 0.02,
    easy >= 0.85, medium >= 0.90; full TTA (64+96 with flip) >=
    0.65/0.80/0.85; the vote merge hard >= 0.85, easy >= 0.70;
  - the 640 production shape (``trained_real640.npz``, 12 collages at seed
    7): >= 0.90/0.90/0.85, flip TTA >= single - 0.03 on every split.

The port's per-image predictions on the first 4 collages are held against
the JAX detector's within 1e-3 px and 1e-5 in score.  The batched entry
point (the DetectionServer with its default native JPEG loader) scores the
JAX entry point's batched AP to the printed digit.  ``--candidate-selection
approx`` runs the exact top-k (what ``jax.lax.approx_max_k`` returns off the
TPU) and holds JAX's approx gate: within 0.02 AP of exact at a 64-candidate
cap, below the 168 anchors, and equal to the JAX entry point's approx AP.
The entry point defaults to the card.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("scipy.io")
cv2 = pytest.importorskip("cv2")

from rs_face_detection_tpu_torch.tools import eval_wider

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
CKPT = os.path.join(FIXTURES, "trained_real64.npz")
CKPT640 = os.path.join(FIXTURES, "trained_real640.npz")


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def collage_tree(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("collage_wider"))
    _load_tool("make_collage_set").build_collage_set(out, FIXTURES, seed=0, n_images=20)
    return out


def _run(root, *extra, capsys, ckpt=CKPT, size=64):
    argv = ["--root", root, "--backbone", "mobilenet025", "--checkpoint", ckpt, "--size", str(size),
            "--split", "all", "--device", "cpu", *extra]
    assert eval_wider.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _run_jax(root, *extra, capsys, ckpt=CKPT, size=64):
    """The JAX package's entry point (tools/eval_wider.py) on the same tree."""
    argv = ["eval_wider.py", "--root", root, "--backbone", "mobilenet025", "--checkpoint", ckpt,
            "--size", str(size), "--split", "all", *extra]
    tool = _load_tool("eval_wider")
    saved, sys.argv = sys.argv, argv
    try:
        assert tool.main() == 0
    finally:
        sys.argv = saved
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _printed(res):
    return {split: f"{res[split]['ap']:.4f}" for split in ("easy", "medium", "hard")}


def _gate(res, easy, medium, hard):
    assert set(res) == {"easy", "medium", "hard"}
    assert res["easy"]["ap"] >= easy, res
    assert res["medium"]["ap"] >= medium, res
    assert res["hard"]["ap"] >= hard, res


@pytest.mark.parametrize("path", ["--no-batched", "--batch-size=8"])
def test_single_scale_gate(collage_tree, capsys, path):
    res = _run(collage_tree, path, capsys=capsys)
    _gate(res, 0.90, 0.90, 0.80)
    total_faces = sum(1 + i % 4 for i in range(20))
    assert res["hard"]["num_kept_faces"] == total_faces
    assert 0 < res["easy"]["num_kept_faces"] < total_faces


def test_tta_gates(collage_tree, capsys):
    single = _run(collage_tree, "--no-batched", capsys=capsys)
    ms = _run(collage_tree, "--tta", "--tta-sizes", "64,96", "--tta-no-flip", capsys=capsys)
    assert ms["hard"]["ap"] >= single["hard"]["ap"] - 0.02, (ms, single)
    _gate(ms, 0.85, 0.90, 0.0)
    _gate(_run(collage_tree, "--tta", "--tta-sizes", "64,96", capsys=capsys), 0.65, 0.80, 0.85)
    _gate(_run(collage_tree, "--tta", "--tta-sizes", "64,96", "--tta-merge", "vote", capsys=capsys), 0.70, 0.0, 0.85)


def test_predictions_equal_the_jax_detector(collage_tree):
    """Per image on the first 4 collages, single-scale at the eval protocol's
    settings (0.02, 256 candidates): counts equal, boxes and landmarks within
    1e-3 px, scores within 1e-5."""
    from rs_face_detection_tpu.configs import FaceDetectionConfig as JFaceDetectionConfig
    from rs_face_detection_tpu.utils.fixtures import load_trained_detector as jload
    from rs_face_detection_tpu_torch.configs import FaceDetectionConfig
    from rs_face_detection_tpu_torch.ops.wider import read_image
    from rs_face_detection_tpu_torch.utils.fixtures import load_trained_detector
    from test_torch_detection import _assert_same

    fields = dict(image_size=(64, 64), confidence_threshold=0.02, max_candidates=256)
    port = load_trained_detector(CKPT, FaceDetectionConfig(**fields), device="cpu")
    ref = jload(CKPT, JFaceDetectionConfig(**fields))
    found = 0
    for i in range(4):
        path = os.path.join(collage_tree, "WIDER_val", "images", "0--Collage", f"collage_{i:02d}.jpg")
        img = read_image(path)
        np.testing.assert_array_equal(img, cv2.imread(path))
        got, want = port(img), ref(img)
        _assert_same(*got, *want)
        found += len(got[0])
    assert found >= 4


def test_production_shape_gate(tmp_path_factory, capsys):
    make640 = _load_tool("make_fixture_640")
    out = str(tmp_path_factory.mktemp("collage640"))
    _load_tool("make_collage_set").build_collage_set(
        out, FIXTURES, seed=7, n_images=12, canvas=640, face_px=make640.COLLAGE_FACE_PX,
        easy_min=make640.COLLAGE_EASY_MIN, medium_min=make640.COLLAGE_MEDIUM_MIN,
    )
    res = _run(out, "--no-batched", capsys=capsys, ckpt=CKPT640, size=640)
    _gate(res, 0.90, 0.90, 0.85)
    total_faces = sum(1 + i % 4 for i in range(12))
    assert res["hard"]["num_kept_faces"] == total_faces
    assert 0 < res["easy"]["num_kept_faces"] < total_faces
    flip = _run(out, "--tta", "--tta-sizes", "640", capsys=capsys, ckpt=CKPT640, size=640)
    for split in ("easy", "medium", "hard"):
        assert flip[split]["ap"] >= res[split]["ap"] - 0.03, (flip, res)


def test_batched_ap_equals_the_jax_entry_point(collage_tree, capsys):
    """Both entry points batched through their DetectionServer, whose
    default loader is the native one (the JAX package printed
    0.9860/0.9924/0.9265 for this tree)."""
    from rs_face_detection_tpu_torch.runtime import native

    assert native.available(), native.unavailable_reason()
    port = _run(collage_tree, "--batch-size=8", capsys=capsys)
    ref = _run_jax(collage_tree, "--batch-size=8", capsys=capsys)
    assert _printed(port) == _printed(ref), (port, ref)
    assert _printed(port)["hard"] == "0.9265", port


def test_approx_topk_ap_parity_on_real_collages(collage_tree, capsys):
    """tests/test_real_collage.py's approx gate on the port's entry point: at
    a cap of 64 candidates, below the 168 anchors of mnet025 at 64x64, approx
    is within 0.02 AP of exact on every split, and equal to the JAX entry
    point's approx run to the printed digit."""
    from rs_face_detection_tpu_torch.configs import RPN_ANCHOR_CFG
    from rs_face_detection_tpu_torch.ops.anchors import full_anchor_table

    n_anchors = full_anchor_table((64, 64), RPN_ANCHOR_CFG)[0].shape[0]
    cap = "64"
    assert int(cap) < n_anchors == 168
    exact = _run(collage_tree, "--no-batched", "--max-candidates", cap, capsys=capsys)
    approx = _run(collage_tree, "--no-batched", "--max-candidates", cap, "--candidate-selection", "approx",
                  capsys=capsys)
    assert exact["hard"]["ap"] >= 0.35, exact
    for split in ("easy", "medium", "hard"):
        assert abs(approx[split]["ap"] - exact[split]["ap"]) <= 0.02, (split, exact, approx)
    ref = _run_jax(collage_tree, "--no-batched", "--max-candidates", cap, "--candidate-selection", "approx",
                   capsys=capsys)
    assert _printed(approx) == _printed(ref), (approx, ref)


def test_approx_selection_raises_and_the_card_is_the_default(collage_tree):
    """Without --device the entry point takes the card, with either
    candidate selection: here, without one, both raise."""
    argv = ["--root", collage_tree, "--checkpoint", CKPT, "--size", "64", "--backbone", "mobilenet025"]
    if not torch.cuda.is_available():
        for extra in ([], ["--candidate-selection", "approx"]):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                eval_wider.main([*argv, *extra])
