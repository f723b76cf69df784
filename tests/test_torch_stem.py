"""The fused ResNet-50 stem (K2): plain PyTorch against the JAX package.

ops/stem.py::fused_stem_plain is the CUDA kernel's reference and the CPU
path.  Required, in f32 on the CPU:

  - ``fold_stem_params`` gives the JAX fold's constants: the weights and
    the normalize constants bit for bit, the BatchNorm scale within 1e-6
    relative (XLA may compute a / sqrt(v) as a * rsqrt(v));
  - ``fused_stem_plain`` equals the Pallas kernel ``fused_stem_s2d`` in
    interpret mode on tests/test_stem_pallas.py's shapes, and the XLA chain
    on a shape the Pallas kernel refuses, within that file's rtol 1e-5,
    atol 1e-4 (the conv sums 192 products in another order);
  - the s2d helpers equal their JAX counterparts exactly.

The kernel itself is held against the plain version on the card
(gpu-marked test below, and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_face_detection_tpu.models.layers import space_to_depth as jax_space_to_depth
from rs_face_detection_tpu.ops.image import s2d_layout_host
from rs_face_detection_tpu.ops.image import s2d_stem_input as jax_s2d_stem_input
from rs_face_detection_tpu.ops.stem_pallas import fold_stem_params as jax_fold
from rs_face_detection_tpu.ops.stem_pallas import fused_stem_s2d
from rs_face_detection_tpu_torch.kernels import stem as kstem
from rs_face_detection_tpu_torch.ops.image import s2d_layout, s2d_stem_input, space_to_depth
from rs_face_detection_tpu_torch.ops.stem import fold_stem_params, fused_stem, fused_stem_plain
from test_stem_pallas import MEANS, STDS, _xla_chain

torch.set_num_threads(2)


def _stem_weights(seed):
    """The draws of tests/test_stem_pallas.py: kernel, gamma, beta, mu, var."""
    rng = np.random.RandomState(seed)
    return (
        rng.randn(4, 4, 12, 64).astype(np.float32) * 0.1,
        rng.rand(64).astype(np.float32) + 0.5,
        rng.randn(64).astype(np.float32) * 0.1,
        rng.randn(64).astype(np.float32) * 0.1,
        rng.rand(64).astype(np.float32) + 0.5,
    )


def _folds(params, means=MEANS, stds=STDS, pixel_scale=1.0):
    want = jax_fold(*(jnp.asarray(p) for p in params), means, stds, pixel_scale)
    got = fold_stem_params(*(torch.from_numpy(p) for p in params), means, stds, pixel_scale)
    return [np.asarray(w) for w in want], got


@pytest.mark.parametrize("pixel_scale", [1.0, 255.0])
def test_fold_equals_jax(pixel_scale):
    want, got = _folds(_stem_weights(0), pixel_scale=pixel_scale)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[2].numpy(), want[2])


@pytest.mark.parametrize("hw", [(64, 96), (128, 64), (64, 64)])
def test_plain_matches_pallas_interpret(hw):
    params = _stem_weights(0)
    imgs = np.random.RandomState(1).randint(0, 256, (2, *hw, 3), np.uint8)
    jw, jb, jn = (jnp.asarray(w) for w in _folds(params)[0])
    want = fused_stem_s2d(
        jnp.asarray(s2d_layout_host(imgs)), jw, jb, jn,
        compute_dtype=jnp.float32, out_dtype=jnp.float32, interpret=True,
    )
    # The same JAX constants on both sides, so only the kernels differ.
    got = fused_stem_plain(
        torch.from_numpy(imgs), *(torch.from_numpy(np.array(w)) for w in (jw, jb, jn))
    )
    assert tuple(got.shape) == (2, 64, hw[0] // 4, hw[1] // 4)
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=1e-5, atol=1e-4
    )


@pytest.mark.parametrize("hw", [(72, 96), (64, 64)])
def test_plain_matches_xla_chain(hw):
    """(72, 96): H/2 = 36 is no multiple of 16, which the Pallas kernel refuses."""
    k, gamma, beta, mu, var = params = _stem_weights(2)
    imgs = np.random.RandomState(3).randint(0, 256, (1, *hw, 3), np.uint8)
    want = _xla_chain(s2d_layout_host(imgs), k, gamma, beta, mu, var)
    got = fused_stem_plain(torch.from_numpy(imgs), *_folds(params)[1])
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=1e-5, atol=1e-4
    )


def test_border_zeroed_after_normalizing():
    """All-0 and all-255 frames: a tap outside the frame contributes 0, not
    -mean * scale (the border the Pallas kernel's comments warn about)."""
    k, gamma, beta, mu, var = params = _stem_weights(4)
    for value in (0, 255):
        imgs = np.full((1, 32, 48, 3), value, np.uint8)
        want = _xla_chain(s2d_layout_host(imgs), k, gamma, beta, mu, var)
        got = fused_stem_plain(torch.from_numpy(imgs), *_folds(params)[1])
        np.testing.assert_allclose(
            got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=1e-5, atol=1e-4
        )


def test_s2d_helpers_equal_jax():
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (2, 8, 12, 3), dtype=np.uint8)
    t = torch.from_numpy(imgs)
    np.testing.assert_array_equal(s2d_layout(t).numpy(), s2d_layout_host(imgs))
    x = rng.normal(size=(2, 8, 12, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        space_to_depth(torch.from_numpy(x)).numpy(), np.asarray(jax_space_to_depth(jnp.asarray(x)))
    )
    mean, scale = (0.485 * 255, 0.456 * 255, 0.406 * 255), (1 / 58.4, 1 / 57.1, 1 / 57.4)
    want = jax_s2d_stem_input(jnp.asarray(imgs), mean, scale)
    np.testing.assert_array_equal(s2d_stem_input(t, mean, scale).numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="divisible"):
        s2d_layout(torch.zeros(1, 7, 8, 3, dtype=torch.uint8))


def test_fused_stem_runs_plain_on_cpu():
    _, consts = _folds(_stem_weights(6))
    imgs = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (2, 24, 40, 3), dtype=np.uint8))
    before = kstem.launches
    torch.testing.assert_close(fused_stem(imgs, *consts), fused_stem_plain(imgs, *consts), rtol=0, atol=0)
    assert kstem.launches == before
    with pytest.raises(ValueError, match="divisible"):
        fused_stem(imgs[:, :23], *consts)  # odd H: the module's own stem applies


def test_kernel_wrapper_refuses_cpu_tensors():
    _, consts = _folds(_stem_weights(7))
    with pytest.raises(ValueError, match="CUDA"):
        kstem.fused_stem_cuda(torch.zeros(1, 8, 8, 3, dtype=torch.uint8), *consts)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused stem kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 640, 640), (2, 72, 96), (3, 70, 34), (1, 2, 2)])
def test_kernel_matches_plain(cuda, shape):
    """K2 against the plain version on the card, TF32 off.  Bound: 1e-5 of
    the output's magnitude (192 f32 products summed in another order)."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        consts = [c.to(cuda) for c in _folds(_stem_weights(8))[1]]
        imgs = torch.from_numpy(
            np.random.default_rng(8).integers(0, 256, (*shape, 3), dtype=np.uint8)
        ).to(cuda)
        before = kstem.launches
        got = kstem.fused_stem_cuda(imgs, *consts)
        want = fused_stem_plain(imgs, *consts)
        torch.cuda.synchronize()
        assert kstem.launches == before + 1
        assert got.shape == want.shape
        bound = 1e-5 * float(want.abs().max())
        assert float((got - want).abs().max()) <= bound
        with pytest.raises(ValueError, match="even"):
            kstem.fused_stem_cuda(imgs[:, :-1].contiguous(), *consts)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
