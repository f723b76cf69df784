"""models/minifas.py and pipeline/antispoofing.py against the JAX package's
MiniFASNet and FaceAntiSpoofing on the same weights.

Tolerances: MiniFASNet probabilities within 1e-5 and logits within 1e-5 of
their magnitude (f32 sums in another order through ~60 convolutions); the
crop geometry exactly equal; live scores within 1e-5 with equal liveness.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_face_detection_tpu.configs import FaceAntiSpoofingConfig as JFaceAntiSpoofingConfig
from rs_face_detection_tpu.models import minifas as jmf
from rs_face_detection_tpu.models.registry import ModelRegistry, ModelSpec
from rs_face_detection_tpu.pipeline import antispoofing as jas
from rs_face_detection_tpu_torch.configs import FaceAntiSpoofingConfig
from rs_face_detection_tpu_torch.models import minifas, weights
from rs_face_detection_tpu_torch.pipeline import antispoofing

torch.set_num_threads(2)


def _flax_minifas(hw, se, seed):
    """A flax MiniFASNet with BatchNorm statistics and PReLU slopes moved off
    their init, and the port's module on the same weights."""
    spec = jmf.default_minifas_spec(hw, se=se)
    model, variables = jmf.init_minifasnet(spec, hw, seed=seed)
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("mean", "bias"):
            return a + rng.normal(0, 0.1, a.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("scale", "alpha"):
            return a * rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        return a

    variables = jax.tree_util.tree_map_with_path(perturb, jax.device_get(variables))
    port_spec = minifas.default_minifas_spec(hw, se=se)
    sd = weights.state_dict_from_jax("minifasnet", variables, spec=port_spec)
    return model, variables, weights.load_model("minifasnet", sd), port_spec


def test_spec_copies_match_jax():
    for hw in ((80, 80), (128, 128), (256, 256), (80, 96)):
        assert minifas.conv6_kernel_for(hw) == jmf.conv6_kernel_for(hw)
        for se in (False, True):
            mine, ref = minifas.default_minifas_spec(hw, se=se), jmf.default_minifas_spec(hw, se=se)
            assert repr(mine).replace("rs_face_detection_tpu_torch", "") == repr(ref).replace(
                "rs_face_detection_tpu", ""
            )


@pytest.mark.parametrize("se", [False, True], ids=["plain", "se"])
@pytest.mark.parametrize("size", [80, 128, 256])
def test_minifasnet_matches_flax(size, se):
    hw = (size, size)
    model, variables, port, spec = _flax_minifas(hw, se, seed=size + se)
    x = np.random.default_rng(size).uniform(0, 255, size=(2, size, size, 3)).astype(np.float32)
    logits = model.clone(softmax=False).apply(variables, jnp.asarray(x), train=False)
    want = np.asarray(jax.nn.softmax(logits, axis=-1))  # MiniFASNet's own last step
    logits = np.asarray(logits)
    nchw = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        got = port(nchw).numpy()
        port.softmax = False
        got_logits = port(nchw).numpy()
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_logits, logits, atol=1e-5 * max(1.0, float(np.abs(logits).max())), rtol=0)
    # The architecture comes back from the state_dict's shapes, and the
    # bridge's keys are the whole module.
    assert minifas.minifasnet_spec_from_state_dict(port.state_dict()) == spec
    assert set(port.state_dict()) == set(weights.state_dict_from_jax("minifasnet", variables, spec=spec))


def test_bridge_rejects_a_missing_spec_and_unmapped_leaves():
    _, variables, _, spec = _flax_minifas((80, 80), False, seed=0)
    with pytest.raises(ValueError, match="spec"):
        weights.state_dict_from_jax("minifasnet", variables)
    flat = weights.flat_variables(variables)
    flat["params/extra/kernel"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="not mapped"):
        weights.state_dict_from_jax("minifasnet", flat, spec=spec)


GEOMETRY_CASES = [
    (1000, 1000, (400.0, 400.0, 100.0, 100.0), 2.0),
    (300, 300, (100.0, 100.0, 100.0, 100.0), 4.0),
    (320, 240, (5.0, 3.0, 80.0, 90.0), 2.7),
    (320, 240, (250.0, 160.0, 60.0, 70.0), 1.0),
]


def test_crop_geometry_equals_jax():
    box = np.array([100, 50, 200, 250, 0.9])
    assert antispoofing.detection_to_crop_box(box) == jas.detection_to_crop_box(box)
    for case in GEOMETRY_CASES:
        assert antispoofing.get_new_box(*case) == jas.get_new_box(*case)
    rng = np.random.default_rng(7)
    for _ in range(500):
        w, h = int(rng.integers(40, 700)), int(rng.integers(40, 700))
        x1, y1 = rng.uniform(-20, w), rng.uniform(-20, h)
        det = np.array([x1, y1, x1 + rng.uniform(2, w), y1 + rng.uniform(2, h), 0.9], np.float32)
        xywh = antispoofing.detection_to_crop_box(det)
        assert xywh == jas.detection_to_crop_box(det)
        for scale in (4.0, 2.7, 2.0, 1.0):
            assert antispoofing.get_new_box(w, h, xywh, scale) == jas.get_new_box(w, h, xywh, scale)


def _registry(cfg, models):
    reg = ModelRegistry()
    for name, size, (model, variables) in zip(cfg.model_names, cfg.image_sizes, models):
        reg.register(ModelSpec(name=name, input_shape=(size[1], size[0], 3), output_spec="probs"), model, variables)
    return reg


def test_face_antispoofing_matches_jax():
    sizes = ((80, 80), (80, 80), (96, 96), (64, 64))  # the 256 and 128 models shrunk for the CPU
    cfg = FaceAntiSpoofingConfig(image_sizes=sizes)
    nets = [_flax_minifas((s[1], s[0]), i == 2, seed=10 + i) for i, s in enumerate(sizes)]
    ref = jas.FaceAntiSpoofing(
        JFaceAntiSpoofingConfig(image_sizes=sizes), registry=_registry(cfg, [(m, v) for m, v, _, _ in nets])
    )
    port = antispoofing.FaceAntiSpoofing(cfg, models=[p for _, _, p, _ in nets], device="cpu")
    rng = np.random.default_rng(8)
    imgs = [rng.integers(0, 256, size=(240, 320, 3), dtype=np.uint8) for _ in range(3)]
    boxes = [
        np.array([100, 60, 200, 180, 0.9], np.float32),
        np.array([5.5, 3.25, 90.75, 120.5, 0.8], np.float32),  # clamped at the corner
        np.array([250.2, 150.7, 318.9, 238.1, 0.7], np.float32),
    ]
    want_live, want_score = ref(imgs, boxes)
    live, score = port(imgs, boxes)
    assert live.dtype == np.int32 and score.dtype == np.float32 and score.shape == (3,)
    np.testing.assert_allclose(score, want_score, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(live, want_live)
    # Liveness is the 0.55 rule on the score, here on both sides of it.
    for thr in (float(score.min()) - 1e-3, float(score.max()) + 1e-3):
        live_t, _ = antispoofing.FaceAntiSpoofing(
            FaceAntiSpoofingConfig(image_sizes=sizes, threshold=thr), models=port.models, device="cpu"
        )(imgs, boxes)
        np.testing.assert_array_equal(live_t, (score > thr).astype(np.int32))
    empty = port([], [])
    assert empty[0].shape == (0,) and empty[1].shape == (0,)
    with pytest.raises(ValueError):
        antispoofing.FaceAntiSpoofing(cfg, models=port.models[:3], device="cpu")
