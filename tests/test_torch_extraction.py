"""pipeline/extraction.py (the staged FaceExtraction, float and weight-only
int8) against the JAX package's FaceExtraction on the same IResNet-18.

Tolerances: embeddings within 1e-4 of JAX's (unit rows; the precedent of
tests/test_torch_models.py's IResNet-18 at 1e-4); int8 against float
cosine > 0.99 (JAX's own bar, tests/test_quantize.py).
"""

import jax
import numpy as np
import pytest
import torch

from rs_face_detection_tpu.models.arcface import init_arcface
from rs_face_detection_tpu.pipeline.extraction import FaceExtraction as JFaceExtraction
from rs_face_detection_tpu_torch.kernels import int8_matmul as k3
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.models.quantized import Int8Linear
from rs_face_detection_tpu_torch.pipeline.extraction import FaceExtraction

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def arcface():
    """IResNet-18 on seeded weights with BatchNorm moved off identity."""
    model, variables = init_arcface("iresnet18", 512, (112, 112), seed=0)
    rng = np.random.default_rng(1)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if name.endswith("mean") or name.endswith("bias"):
            return a + rng.normal(0, 0.1, a.shape).astype(np.float32)
        if name.endswith("var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a

    variables = jax.tree_util.tree_map_with_path(perturb, jax.device_get(variables))
    port = weights.load_model("iresnet18", weights.state_dict_from_jax("iresnet18", variables))
    return model, variables, port


def _crops(n, h, w, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8) for _ in range(n)]


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("size", [(112, 112), (96, 80)], ids=str)
def test_matches_jax(arcface, quantized, size):
    model, variables, port = arcface
    crops = _crops(3, *size, seed=2)
    want = JFaceExtraction(model=model, variables=variables, quantized=quantized)(crops)
    fe = FaceExtraction(model=port, device="cpu", quantized=quantized)
    got = fe(crops)
    assert got.shape == (3, 512) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert isinstance(fe.model.fc, Int8Linear) == quantized
    assert not any(isinstance(m, Int8Linear) for m in port.modules())  # the caller's model is left float


def test_int8_against_float_and_contract(arcface):
    _, _, port = arcface
    crops = _crops(4, 112, 112, seed=3)
    fe = FaceExtraction(model=port, device="cpu")
    fq = FaceExtraction(model=port, device="cpu", quantized=True)
    before = k3.launches
    cos = np.sum(fe(crops) * fq(crops), axis=1)
    assert (cos > 0.99).all(), cos
    assert k3.launches == before  # the CPU path uses the plain version only
    assert fq.model.fc.weight_q.dtype == torch.int8 and tuple(fq.model.fc.weight_q.shape) == (25088, 512)
    assert fe([]).shape == (0, 512) and fq([]).shape == (0, 512)
    # An already-int8 model is taken as it is.
    again = FaceExtraction(model=fq.model, device="cpu", quantized=True)
    assert again.model is fq.model
    np.testing.assert_array_equal(again(crops), fq(crops))
