"""ops/attention.py (K4's plain version and dispatcher) against the JAX
package's attention: flax ``nn.dot_product_attention`` and the Pallas TPU
flash attention of models/vit.py::_flash_attention_fn, run in interpret mode
as tests/test_vit_fused_attention.py runs it.  Tolerance 2e-6: f32 sums in
another order.  The CUDA kernel itself is held against the plain version on
the card (marked ``gpu``)."""

import flax.linen as nn
import jax.experimental.pallas.tpu as pltpu
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_face_detection_tpu.models.vit import _flash_attention_fn
from rs_face_detection_tpu_torch.kernels.attention import flash_attention_cuda
from rs_face_detection_tpu_torch.ops.attention import attention, attention_plain

SHAPES = [(2, 17, 2, 32), (1, 257, 1, 64)]


def _qkv(shape, seed, packed):
    """q, k, v as numpy arrays, and as torch tensors that are either three
    contiguous tensors or the strided slices of one (B, N, 3, H, D) tensor."""
    b, n, h, d = shape
    arr = np.random.default_rng(seed).normal(size=(b, n, 3, h, d)).astype(np.float32)
    q, k, v = (arr[:, :, i] for i in range(3))
    if packed:
        t = torch.from_numpy(arr)
        tq, tk, tv = t[:, :, 0], t[:, :, 1], t[:, :, 2]
        assert not tq.is_contiguous()
    else:
        tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(x)) for x in (q, k, v))
    return (q, k, v), (tq, tk, tv)


@pytest.mark.parametrize("packed", [False, True], ids=["contiguous", "strided"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_flax(shape, packed):
    (q, k, v), (tq, tk, tv) = _qkv(shape, 0, packed)
    want = np.asarray(nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = attention_plain(tq, tk, tv)
    assert got.shape == shape and got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_pallas_flash_interpret(shape):
    (q, k, v), (tq, tk, tv) = _qkv(shape, 1, True)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_flash_attention_fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(attention_plain(tq, tk, tv).numpy(), want, atol=2e-6, rtol=0)


def test_plain_bf16_returns_bf16_from_f32_math():
    _, (tq, tk, tv) = _qkv((1, 9, 2, 32), 2, True)
    q, k, v = (t.bfloat16() for t in (tq, tk, tv))
    got = attention_plain(q, k, v)
    assert got.dtype == torch.bfloat16
    want = attention_plain(q.float(), k.float(), v.float()).bfloat16()
    assert torch.equal(got, want)


def test_dispatcher_takes_the_plain_version_on_the_cpu():
    _, (tq, tk, tv) = _qkv((2, 17, 2, 32), 3, True)
    assert torch.equal(attention(tq, tk, tv), attention_plain(tq, tk, tv))
    with pytest.raises(ValueError, match="unsupported device"):
        attention(*(t.to("meta") for t in (tq, tk, tv)))


def test_kernel_wrapper_refuses_cpu_tensors():
    _, (tq, tk, tv) = _qkv((1, 4, 1, 32), 4, False)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(tq, tk, tv)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [(8, 257, 16, 64), (2, 17, 2, 32), (1, 1, 16, 64), (3, 197, 12, 64)], ids=str)
def test_kernel_matches_plain_on_the_card(shape, dtype):
    """K4 against the plain version on the same inputs (strided qkv views):
    f32 within 2e-5 of max|v| (sums in another order), bf16 within 1e-2 of
    max|v| (P is rounded to bf16 before PV)."""
    if not torch.cuda.is_available():
        pytest.skip("K4 is a CUDA kernel and this host has no card")
    from rs_face_detection_tpu_torch.kernels import attention as katt

    arr = np.random.default_rng(5).normal(size=(shape[0], shape[1], 3, *shape[2:]))
    q, k, v = torch.from_numpy(arr).to("cuda", dtype).unbind(2)  # strided views
    before = katt.launches
    got = katt.flash_attention_cuda(q, k, v)
    want = attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert katt.launches == before + 1
    bound = (2e-5 if dtype == torch.float32 else 1e-2) * float(v.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= bound
