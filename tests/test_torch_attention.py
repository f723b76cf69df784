"""ops/attention.py (K4's plain version and dispatcher) against the JAX
package's attention: flax ``nn.dot_product_attention`` and the Pallas TPU
flash attention of models/vit.py::_flash_attention_fn, run in interpret mode
as tests/test_vit_fused_attention.py runs it.  Tolerance 2e-6: f32 sums in
another order.  The CUDA kernel itself is held against the plain version on
the card (tests/test_torch_kernels_gpu.py)."""

import math

import flax.linen as nn
import jax.experimental.pallas.tpu as pltpu
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_face_detection_tpu.models.vit import _flash_attention_fn
from rs_face_detection_tpu_torch.kernels import attention as katt
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


PLAN_SHAPES = [
    (8, 257, 16, 64), (1, 257, 16, 64), (2, 17, 2, 32), (1, 1, 16, 64), (3, 197, 12, 64), (1, 600, 2, 64),
    (8, 600, 16, 64),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_launch_plan_covers_every_query_row_once(shape):
    """K4's bf16 launch plan on 132 SMs: CTA s of a head takes fragments
    [s * F // splits, (s + 1) * F // splits) and warp w fragment f0 + r *
    warps + w in round r (csrc/attention.cu), so every 16-row query
    fragment is taken exactly once; the K/V stages hold the whole head up to
    512 keys and fit the 227 KB a CTA may ask for."""
    b, n, h, d = shape
    splits, warps, stages = katt.launch_plan(b, n, h, 132)
    frags = -(-n // katt.FRAG_ROWS)
    assert 1 <= splits <= frags and 1 <= warps <= katt.MAX_WARPS
    seen = np.zeros(n, np.int64)
    for split in range(splits):
        f0, f1 = split * frags // splits, (split + 1) * frags // splits
        assert f1 > f0
        for r in range(-(-(f1 - f0) // warps)):
            for w in range(warps):
                frag = f0 + r * warps + w
                if frag < f1:
                    seen[frag * 16 : (frag + 1) * 16] += 1
    assert (seen == 1).all()
    assert stages == min(-(-n // katt.STAGE_KEYS), katt.MAX_STAGES)
    assert katt.smem_bytes(d, stages) <= katt.SMEM_LIMIT
    assert katt.smem_bytes(d, katt.MAX_STAGES) <= katt.SMEM_LIMIT


@pytest.mark.parametrize("b", [8, 1], ids=["tower b8", "verify b1"])
def test_launch_plan_fills_the_card(b):
    """At (b, 257, 16, 64) the plan launches one wave that leaves at most 4
    of the 132 SMs without a CTA: two CTAs of 92,160 B of K/V fit an SM's
    227 KB.  The tower's b8: 128 heads of 2 CTAs of 5 warps (9 and 8
    fragments, two rounds), 256 CTAs; a verify's b1: 16 heads of 8 CTAs of 3
    warps, 128 CTAs."""
    splits, warps, stages = katt.launch_plan(b, 257, 16, 132)
    ctas = b * 16 * splits
    assert 128 <= ctas <= 132 * (katt.SMEM_LIMIT // katt.smem_bytes(64, stages))
    assert (splits, warps, ctas) == ((2, 5, 256) if b == 8 else (8, 3, 128))


def _flash_bf16_emulation(q, k, v):
    """csrc/attention.cu's bf16 arithmetic in torch, per 64-key stage: f32
    scores from the bf16 inputs, a running max in the log2 domain, P =
    exp2(s * scale_log2 - m) in f32, the row sum of the unrounded P, P
    rounded to bf16 for PV with f32 accumulation, the rescale by exp2(m_old -
    m_new), and one multiply by 1 / l at the end."""
    b, n, h, d = q.shape
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))  # (B, H, N, D)
    scale_log2 = torch.tensor(1.4426950408889634 / math.sqrt(d), dtype=torch.float32)
    m = torch.full((b, h, n), -math.inf)
    l = torch.zeros(b, h, n)
    acc = torch.zeros(b, h, n, d)
    for k0 in range(0, n, katt.STAGE_KEYS):
        s = qf @ kf[:, :, k0 : k0 + katt.STAGE_KEYS].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.bfloat16().float() @ vf[:, :, k0 : k0 + katt.STAGE_KEYS]
        m = m_new
    return (acc * (1.0 / l)[..., None]).bfloat16().permute(0, 2, 1, 3)


@pytest.mark.parametrize("shape", [(2, 257, 2, 64), (1, 17, 2, 32)], ids=str)
def test_bf16_rounding_of_the_tiling_meets_the_kernel_tolerance(shape):
    """The bf16 kernel's online softmax, emulated, against attention_plain
    within the card's bound 1e-2 x max|v|, at the tower's N = 257 and D = 64
    on 2 heads of batch 2 (five 64-key stages, the last holding one key)."""
    arr = np.random.default_rng(6).normal(size=(shape[0], shape[1], 3, *shape[2:])).astype(np.float32)
    q, k, v = torch.from_numpy(arr).bfloat16().unbind(2)
    want = attention_plain(q, k, v)
    got = _flash_bf16_emulation(q, k, v)
    assert got.dtype == torch.bfloat16 and got.shape == shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= 1e-2 * float(v.float().abs().max()), err
