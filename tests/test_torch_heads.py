"""SmallCNN, the registry's fast test double, against the JAX SmallCNN on
the same bridged weights: outputs within 1e-5 of max|output| (f32 sums in
another order through five convolutions)."""

import jax
import numpy as np
import pytest
import torch

from rs_face_detection_tpu.models.heads import init_small_cnn as j_init_small_cnn
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.models.heads import SmallCNN, init_small_cnn, small_cnn_map


def bridged(num_outputs, size, softmax, widths, seed):
    """(JAX model, variables, the port's SmallCNN on the same weights)."""
    model, variables = j_init_small_cnn(num_outputs, size, softmax=softmax, widths=widths, seed=seed)
    variables = jax.tree.map(np.asarray, variables)
    port = SmallCNN(num_outputs, widths, softmax).eval()
    port.load_state_dict(weights.state_dict_from_jax("small_cnn", variables, mapping=small_cnn_map(widths)))
    return model, variables, port


@pytest.mark.parametrize(
    "num_outputs,size,softmax,widths",
    [(4, (112, 112), True, (8, 16)), (1, (96, 80), False, (8, 16)), (3, (64, 64), True, (8, 16, 32, 64))],
)
def test_small_cnn_matches_jax(num_outputs, size, softmax, widths):
    model, variables, port = bridged(num_outputs, size, softmax, widths, seed=num_outputs)
    w, h = size
    x = np.random.default_rng(0).normal(size=(2, h, w, 3)).astype(np.float32)
    want = np.asarray(model.apply(variables, x, train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    assert got.shape == want.shape == (2, num_outputs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


def test_seeded_small_cnn_is_deterministic():
    a, b = init_small_cnn(4, widths=(8, 16), seed=3), init_small_cnn(4, widths=(8, 16), seed=3)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert not torch.equal(a.fc.weight, init_small_cnn(4, widths=(8, 16), seed=4).fc.weight)
    with torch.no_grad():
        assert float(a(torch.zeros(1, 3, 40, 30)).sum()) == pytest.approx(1.0)
