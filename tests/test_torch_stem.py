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
  - the s2d helpers equal their JAX counterparts exactly;
  - the kernel's own arithmetic (csrc/stem.cu: exact pixel values times
    weights split into two TF32 halves, accumulated in f32 in the kernel's
    order, minus the in-frame mean correction), emulated in torch, meets
    the card's 1e-5 bound.

The kernel itself is held against the plain version on the card
(tests/test_torch_kernels_gpu.py, and chip_smoke.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rs_face_detection_tpu.models.layers import space_to_depth as jax_space_to_depth
from rs_face_detection_tpu.ops.image import s2d_layout_host
from rs_face_detection_tpu.ops.image import s2d_stem_input as jax_s2d_stem_input
from rs_face_detection_tpu.ops.stem_pallas import fold_stem_params as jax_fold
from rs_face_detection_tpu.ops.stem_pallas import fused_stem_s2d
from rs_face_detection_tpu_torch.configs import FaceDetectionConfig
from rs_face_detection_tpu_torch.kernels import stem as kstem
from rs_face_detection_tpu_torch.ops.image import letterbox_u8_batch, s2d_layout, s2d_stem_input, space_to_depth
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


def _tf32_rna(x):
    """cvt.rna.tf32.f32 by int32 bit operations: the f32 mantissa rounded to
    10 bits, ties away from zero (the sign is a separate bit)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _chop(x, top):
    """x (float64) truncated toward zero to a multiple of 2^(e - 24), where
    2^e > |top| >= 2^(e - 1): the 24 bits below top's leading bit."""
    unit = torch.ldexp(torch.ones_like(top), torch.frexp(top.abs())[1] - 24)
    return torch.trunc(x / unit) * unit


def _stem_tf32x2(imgs_u8, w192, bn2, norm2, passes=2):
    """csrc/stem.cu's conv arithmetic in torch, in the kernel's order.  With
    x = (px - mean) * scale the conv is sum_in w' px - corr, w' = w * scale
    in f32: the pixel values are exact in TF32 (0 outside the frame), w' is
    split as hi = rna(w'), lo = rna(w' - hi), and every product is exact.
    The taps run as the kernel's 24 k-steps of 8 (tap (u*8 + v)*3 + c), the
    lo step before the hi step, each one mma into the f32 accumulator.  Each
    mma is modelled as NVIDIA tensor cores were measured to add (Fasi,
    Higham, Mikaitis and Pranesh, PeerJ CS 2021): the accumulator and the 8
    exact products aligned to the largest of them with the bits past 24
    truncated, summed, and the sum rounded toward zero to f32, which loses
    more than round-to-nearest would.  corr = sum over the in-frame (u, v),
    u-major, of sum_c w' mean in f32, and conv = acc - corr in f32, as the
    kernel computes them; then BatchNorm, ReLU and the pool as the plain
    version.  ``passes=1`` keeps the hi step alone: one TF32 pass on the
    weights."""
    px = s2d_layout(imgs_u8).float()  # (B, H/2, W/2, 12), the frame's pixel values
    b, h2, w2, _ = px.shape
    pad = (2, 1, 2, 1)
    # Unfold rows are k*16 + dy*4 + dx; pixel tap (u, v, c) is s2d channel
    # k = ((u & 1)*2 + (v & 1))*3 + c at dy = u // 2, dx = v // 2.
    perm = [
        (((u & 1) * 2 + (v & 1)) * 3 + c) * 16 + (u // 2) * 4 + v // 2
        for u in range(8) for v in range(8) for c in range(3)
    ]
    cols = F.unfold(F.pad(px.permute(0, 3, 1, 2), pad), 4)[:, perm].double()  # (B, 192, L)
    inside = F.unfold(F.pad(torch.ones(b, 12, h2, w2), pad), 4)[:, perm][:, ::3]  # (B, 64 (u, v), L)
    w = w192.reshape(4, 4, 12, -1) * norm2[1][:, None]  # w' in f32, as the kernel rounds it
    w = w.permute(2, 0, 1, 3).reshape(192, -1)[perm]  # (192 taps, 64), the kernel's tap order
    wh = _tf32_rna(w)
    wl = _tf32_rna(w - wh)
    acc = torch.zeros(b, cols.shape[2], w.shape[1], dtype=torch.float64)
    for ks in range(24):
        a = cols[:, 8 * ks : 8 * ks + 8, :, None]  # (B, 8, L, 1)
        for part in (wl, wh)[2 - passes :]:
            prods = a * part[8 * ks : 8 * ks + 8, None, :].double()  # (B, 8, L, 64), exact
            top = torch.maximum(acc.abs(), prods.abs().amax(1))
            total = _chop(acc, top) + _chop(prods, top[:, None]).sum(1)
            acc = _chop(total, total)
    mean = norm2[0][torch.tensor(perm) // 16]  # the mean of each tap's s2d channel
    wm = (w * mean[:, None]).reshape(64, 3, -1)  # w' mean per (u, v) and c, in f32
    m = (wm[:, 0] + wm[:, 1]) + wm[:, 2]  # sum_c, in the kernel's order
    corr = torch.zeros(b, cols.shape[2], w.shape[1])
    for uv in range(64):
        corr = corr + inside[:, uv, :, None] * m[uv]
    y = (acc.float() - corr).permute(0, 2, 1).reshape(b, -1, h2, w2)
    y = torch.relu(y * bn2[0][:, None, None] + bn2[1][:, None, None])
    return F.max_pool2d(y, 3, 2, 1)


def _canvas(kind):
    if kind == "letterboxed":
        face = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "real_face_crop.npz"))["face"]
        return letterbox_u8_batch([face[:, :120]], 128, 96, torch.device("cpu"))[0]
    return torch.full((1, 64, 96, 3), 0 if kind == "all-0" else 255, dtype=torch.uint8)


@pytest.mark.parametrize("norm", ["config", "imagenet"])
@pytest.mark.parametrize("kind", ["letterboxed", "all-0", "all-255"])
def test_split_weights_on_exact_pixels_meet_the_kernel_tolerance(kind, norm):
    """The arithmetic of csrc/stem.cu against fused_stem_plain within the
    card's bound, 1e-5 x max|plain|, on phase 7's weight draws.  All-0 and
    all-255 under ImageNet's normalization give the largest |x| and a border
    of zeros beside it, where the correction changes from tap to tap.
    Margin found: the emulation's error is at most 0.13 of the bound on
    these six cases (0.132 letterboxed under the config's normalization).
    One TF32 pass on the weights misses the bound 21-38 times over wherever
    a pixel is not 0."""
    wrng = np.random.default_rng(7)
    params = [
        torch.from_numpy(wrng.normal(size=(4, 4, 12, 64)).astype(np.float32) / np.float32(np.sqrt(192.0))),
        torch.from_numpy(wrng.uniform(0.5, 1.5, 64).astype(np.float32)),
        torch.from_numpy(wrng.normal(0, 0.1, 64).astype(np.float32)),
        torch.from_numpy(wrng.normal(0, 0.1, 64).astype(np.float32)),
        torch.from_numpy(wrng.uniform(0.5, 1.5, 64).astype(np.float32)),
    ]
    det = FaceDetectionConfig(backbone="resnet50")
    means, stds, scale = {
        "config": (det.pixel_means, det.pixel_stds, det.pixel_scale),
        "imagenet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225), 255.0),
    }[norm]
    consts = fold_stem_params(*params, means, stds, scale)
    imgs = _canvas(kind)
    want = fused_stem_plain(imgs, *consts)
    got = _stem_tf32x2(imgs, *consts)
    assert got.shape == want.shape
    bound = 1e-5 * max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= bound, (err, bound)
    if kind != "all-0":
        one_pass = float((_stem_tf32x2(imgs, *consts, passes=1) - want).abs().max())
        assert one_pass > bound, (one_pass, bound)
