"""pipeline/quality.py (FaceQuality) and pipeline/quality_assessment.py
(FaceQualityAssessment) against the JAX package's modules on the same
ResNet-18 weights.

Tolerances: quality probabilities within 1e-5 with equal classes and
scores; assessment scores within 1e-4 (an unbounded regression output of
magnitude ~10 here) with equal pass flags.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_face_detection_tpu.models.classifiers import init_resnet18_classifier
from rs_face_detection_tpu.pipeline.quality import FaceQuality as JFaceQuality
from rs_face_detection_tpu.pipeline.quality import demote_quality as j_demote
from rs_face_detection_tpu.pipeline.quality_assessment import (
    FaceQualityAssessment as JFaceQualityAssessment,
)
from rs_face_detection_tpu_torch.configs import FaceQualityAssessmentConfig
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.pipeline.quality import FaceQuality, demote_quality
from rs_face_detection_tpu_torch.pipeline.quality_assessment import FaceQualityAssessment

torch.set_num_threads(2)


def _moved(variables, seed):
    """Variables with BatchNorm statistics and biases off identity."""
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("mean", "bias"):
            return a + rng.normal(0, 0.1, a.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, jax.device_get(variables))


def _crops(n, h, w, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8) for _ in range(n)]


@pytest.mark.parametrize("size", [(112, 112), (90, 100)], ids=str)
def test_face_quality_matches_jax(size):
    model, variables = init_resnet18_classifier(4, (112, 112), seed=0)
    variables = _moved(variables, 1)
    port = weights.load_model("resnet18_classifier", weights.state_dict_from_jax("resnet18_classifier", variables))
    crops = _crops(4, *size, seed=2)
    ref = JFaceQuality(model=model, variables=variables)
    fq = FaceQuality(model=port, device="cpu")
    np.testing.assert_allclose(fq.probabilities(crops), ref.probabilities(crops), atol=1e-5, rtol=0)
    (scores, classes), (want_scores, want_classes) = fq(crops), ref(crops)
    assert classes == want_classes
    np.testing.assert_allclose(scores, want_scores, atol=1e-5)
    assert fq([]) == ([], []) and fq.probabilities([]).shape == (0, 4)


def test_demotion_rule_matches_jax():
    rows = np.array(
        [
            [0.35, 0.4, 0.15, 0.1],  # class 1 below 0.5: demoted to class 0's probability
            [0.1, 0.6, 0.2, 0.1],
            [0.2, 0.3, 0.45, 0.05],
            [0.25, 0.25, 0.25, 0.25],  # a tie: the first index
            [0.3, 0.5, 0.1, 0.1],  # exactly at the threshold: kept
        ],
        np.float32,
    )
    for row in rows:
        assert demote_quality(row, 0.5) == j_demote(row, 0.5)
    assert demote_quality(rows[0], 0.5) == (0, pytest.approx(0.35))

    class Fixed(torch.nn.Module):
        def forward(self, x):
            return torch.from_numpy(rows[:1]).repeat(x.shape[0], 1)

    scores, classes = FaceQuality(model=Fixed(), device="cpu")(_crops(2, 112, 112, 0))
    assert classes == [0, 0] and scores == [pytest.approx(0.35)] * 2


@pytest.mark.parametrize("size", [(112, 112), (120, 96)], ids=str)
def test_face_quality_assessment_matches_jax(size):
    model, variables = init_resnet18_classifier(1, (112, 112), softmax=False, seed=3)
    variables = _moved(variables, 4)
    sd = weights.state_dict_from_jax("resnet18_classifier", variables)
    port = weights.load_model("resnet18_classifier", sd, softmax=False)
    crops = _crops(4, *size, seed=5)
    want_scores, want_flags = JFaceQualityAssessment(model=model, variables=variables)(crops)
    scores, flags = FaceQualityAssessment(model=port, device="cpu")(crops)
    np.testing.assert_allclose(scores, want_scores, atol=1e-4, rtol=0)
    assert flags == want_flags
    # The threshold rule on both sides of 55, with a fixed score.
    thr = FaceQualityAssessmentConfig().threshold

    class Fixed(torch.nn.Module):
        def __init__(self, value):
            super().__init__()
            self.value = value

        def forward(self, x):
            return torch.full((x.shape[0], 1), self.value)

    for value, flag in ((thr + 0.5, 1), (thr, 0), (thr - 0.5, 0)):
        assert FaceQualityAssessment(model=Fixed(value), device="cpu")(crops[:1]) == ([value], [flag])
    assert FaceQualityAssessment(model=port, device="cpu")([]) == ([], [])
    # No softmax: the flag keeps the raw regression output.
    with torch.no_grad():
        raw = port(torch.zeros(1, 3, 112, 112))
    assert raw.shape == (1, 1)
    assert np.asarray(
        model.apply(variables, jnp.zeros((1, 112, 112, 3)), train=False)
    ).shape == (1, 1)
