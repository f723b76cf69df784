"""The port's detection AP (ops/eval.py) and synthetic scenes
(utils/synthetic.py) against the JAX package's.

Both are host numpy copies, so the tolerance is none: the same floats, the
same matches and the same tie order, on seeded inputs that cover no GT, no
detections, tied scores, tied overlaps, zero-union and NaN boxes.  The
port's RetinaFaceDetection on ``trained_mnet64.npz`` through
``evaluate_detector`` also meets JAX's golden gate on ``ap_eval_set.npz``
(AP >= recorded - 0.02, tests/test_golden_regression.py) and gives JAX's AP
within 1e-6.
"""

import os

import numpy as np
import pytest
import torch

from rs_face_detection_tpu.ops import eval as jeval
from rs_face_detection_tpu.utils import fixtures as jfixtures
from rs_face_detection_tpu.utils import synthetic as jsynth
from rs_face_detection_tpu_torch.ops import eval as peval
from rs_face_detection_tpu_torch.utils import fixtures as pfixtures
from rs_face_detection_tpu_torch.utils import synthetic as psynth

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _boxes(rng, n, grid=True):
    """(n, 4) boxes on a coarse grid, so that overlaps tie exactly."""
    xy = rng.integers(0, 6, size=(n, 2)) * 8.0 if grid else rng.uniform(0, 48, size=(n, 2))
    wh = rng.integers(1, 4, size=(n, 2)) * 8.0 if grid else rng.uniform(4, 24, size=(n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _cases():
    rng = np.random.default_rng(0)
    cases = []
    for i in range(12):
        g, d = int(rng.integers(0, 5)), int(rng.integers(0, 9))
        gt = _boxes(rng, g, grid=i % 2 == 0)
        det = _boxes(rng, d, grid=i % 2 == 0)
        scores = (rng.integers(0, 3, size=d) / 2).astype(np.float32)  # ties
        cases.append((det, scores, gt))
    degenerate = np.array(
        [[10, 10, 8, 8], [np.nan, 0, 5, 5], [3, 3, 1, 40], [0, 0, 9, 9]], np.float32
    )  # zero-union (the "+1" width is -1), NaN, negative width, a real box
    gt = np.array([[0, 0, 9, 9], [10, 10, 8, 8]], np.float32)
    cases.append((degenerate, np.array([0.9, 0.9, 0.8, 0.7], np.float32), gt))
    cases.append((np.zeros((0, 4), np.float32), np.zeros(0, np.float32), gt))
    cases.append((degenerate, np.full(4, 0.5, np.float32), np.zeros((0, 4), np.float32)))
    return cases


@pytest.mark.parametrize("case", range(len(_cases())))
def test_match_detections_equals_jax(case):
    det, scores, gt = _cases()[case]
    for thr in (0.3, 0.5):
        want = jeval.match_detections(det, scores, gt, thr)
        got = peval.match_detections(det, scores, gt, thr)
        assert got.num_gt == want.num_gt
        np.testing.assert_array_equal(got.scores, want.scores)
        np.testing.assert_array_equal(got.matched, want.matched)


def test_iou_matrix_equals_jax():
    from rs_face_detection_tpu.pipeline.tracking import iou_matrix_np as jiou
    from rs_face_detection_tpu_torch.pipeline.tracking import iou_matrix_np as piou

    for det, _, gt in _cases():
        np.testing.assert_array_equal(piou(det, gt), jiou(det, gt))
        np.testing.assert_array_equal(piou(det, det), jiou(det, det))


def test_average_precision_equals_jax():
    cases = _cases()
    for thr in (0.3, 0.5):
        jev = [jeval.match_detections(d, s, g, thr) for d, s, g in cases]
        pev = [peval.match_detections(d, s, g, thr) for d, s, g in cases]
        assert peval.average_precision(pev) == jeval.average_precision(jev)
        assert peval.average_precision(pev[:3]) == jeval.average_precision(jev[:3])
    empty = [peval.match_detections(np.zeros((0, 4)), np.zeros(0), np.zeros((0, 4)))]
    assert peval.average_precision(empty) == jeval.average_precision(empty)
    assert peval.average_precision([]) == jeval.average_precision([])


def test_evaluate_detector_equals_jax_on_a_scripted_detector():
    dataset = [(np.zeros((8, 8, 3), np.uint8), g) for _, _, g in _cases()]
    outputs = iter([np.concatenate([d, s[:, None]], 1) for d, s, _ in _cases()] * 2)
    lists = [o.tolist() for o in [np.concatenate([d, s[:, None]], 1) for d, s, _ in _cases()]]

    def scripted(_img):
        return next(outputs), None

    want = jeval.evaluate_detector(scripted, dataset)
    got = peval.evaluate_detector(scripted, dataset)
    assert got == want
    plain = iter(lists)  # plain-list returns are taken too
    assert peval.evaluate_detector(lambda _img: (next(plain), None), dataset) == want


def test_synthetic_scenes_equal_jax():
    for seed in (0, 7):
        a, b = jsynth.synth_scene(np.random.default_rng(seed), 48, 56, 3), psynth.synth_scene(
            np.random.default_rng(seed), 48, 56, 3
        )
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        a = jsynth.synth_batch_arrays(np.random.default_rng(seed), 3)
        b = psynth.synth_batch_arrays(np.random.default_rng(seed), 3)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        a = jsynth.synth_eval_set(np.random.default_rng(seed), 4)
        b = psynth.synth_eval_set(np.random.default_rng(seed), 4)
        for (xi, xg), (yi, yg) in zip(a, b):
            np.testing.assert_array_equal(xi, yi)
            np.testing.assert_array_equal(xg, yg)
    np.testing.assert_array_equal(psynth.LANDMARK_TEMPLATE, jsynth.LANDMARK_TEMPLATE)


def test_ap_eval_set_loads_as_jax_does():
    path = os.path.join(FIXTURES, "ap_eval_set.npz")
    got, got_rec = pfixtures.load_ap_eval_set(path)
    want, want_rec = jfixtures.load_ap_eval_set(path)
    assert got_rec == want_rec and len(got) == len(want)
    for (gi, gb), (wi, wb) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gb, wb)


def test_trained_detector_meets_the_golden_gate_and_jax_ap():
    """The port's fixture detector through evaluate_detector: AP >= recorded
    - 0.02 (JAX's gate) and JAX's AP within 1e-6 on the same eval set."""
    ckpt = os.path.join(FIXTURES, "trained_mnet64.npz")
    dataset, recorded = pfixtures.load_ap_eval_set(os.path.join(FIXTURES, "ap_eval_set.npz"))
    det = pfixtures.load_trained_detector(ckpt, device="cpu")
    got = peval.evaluate_detector(det, dataset)
    assert got["ap"] >= recorded["ap"] - 0.02, (got, recorded)
    want = jeval.evaluate_detector(jfixtures.load_trained_detector(ckpt), dataset)
    assert got["num_gt"] == want["num_gt"]
    for key in ("ap", "precision", "recall"):
        assert abs(got[key] - want[key]) <= 1e-6, (key, got, want)
