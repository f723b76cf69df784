"""ops/quantize.py and models/quantized.py against the JAX package's
weight-only int8 (rs_face_detection_tpu/ops/quantize.py).

Tolerances: the quantizer is exact (q and s equal, leaf for leaf after the
layout maps).  K3's plain version is held within 1e-5 of sum_k |x_k w_kn|
per output: against the Pallas kernel in interpret mode in bf16 (the same
bf16 roundings of x and w, only the f32 summation order differs), and
against numpy float64 in f32.  The CUDA kernel itself is held against the
plain version on the card (tests/test_torch_kernels_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_face_detection_tpu.models.arcface import init_arcface
from rs_face_detection_tpu.ops import quantize as jq
from rs_face_detection_tpu.pipeline.extraction import FaceExtraction as JFaceExtraction
from rs_face_detection_tpu_torch.kernels import int8_matmul as k3
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.models.quantized import Int8Conv2d, Int8Linear, quantize_module
from rs_face_detection_tpu_torch.ops import quantize

torch.set_num_threads(2)


def _weights(shape, seed):
    """Normal weights with one all-zero output channel and values on the
    half-step grid, so round-half-even and the zero-scale rule both show."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.05, size=shape).astype(np.float32)
    w[..., 0] = 0.0
    if shape[-1] > 1:
        steps = rng.integers(-254, 255, size=shape[:-1]).astype(np.float32) / 2
        w[..., 1] = steps * (np.float32(1.0) / 127)  # absmax 127 steps: halves land on .5
    return w


@pytest.mark.parametrize("shape", [(64, 64), (3, 3, 16, 32), (128, 256), (7, 5)], ids=str)
def test_quantize_array_matches_jax(shape):
    w = _weights(shape, 0)
    q, s = quantize.quantize_array(w)
    jq_q, jq_s = jq.quantize_array(w)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, jq_q)
    np.testing.assert_array_equal(s, jq_s)
    # The torch layout keeps the output channel on axis 0: the same values.
    t = np.moveaxis(w, -1, 0)
    tq, ts = quantize.quantize_array(t, axis=0)
    np.testing.assert_array_equal(np.moveaxis(tq, 0, -1), jq_q)
    np.testing.assert_array_equal(ts.reshape(-1), jq_s.reshape(-1))


def test_dequantize_matches_jax():
    q, s = jq.quantize_array(_weights((32, 48), 1))
    want = np.asarray(jq.dequantize_array(jnp.asarray(q), jnp.asarray(s)))
    got = quantize.dequantize_array(torch.from_numpy(q), torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got, want)


def test_selection_rule_matches_quantize_tree():
    """size >= 4096 is quantized (a 64x64 leaf is), 4095 and 1-D leaves are not."""
    tree = {
        "a": np.ones((64, 64), np.float32),
        "b": np.ones((4095, 1), np.float32),
        "c": np.ones((5000,), np.float32),
        "d": np.ones((3, 3, 3, 64), np.float32),
        "e": np.ones((64, 64), np.float16),
        "f": np.ones((64, 64), np.int32),
    }
    qt = jq.quantize_tree(tree)
    for name, leaf in tree.items():
        assert quantize.should_quantize(torch.from_numpy(leaf)) == isinstance(qt[name], dict), name


def test_bridged_int8_tree_equals_the_port_quantizer():
    """JAX's FaceExtraction(quantized=True) tree, bridged, equals the port's
    quantize_module of the bridged float tree, leaf for leaf (torch.equal)."""
    model, variables = init_arcface("iresnet18", 512, (112, 112), seed=0)
    rng = np.random.default_rng(2)
    variables = jax.tree.map(
        lambda a: np.asarray(a) * rng.uniform(0.8, 1.2, np.shape(a)).astype(np.float32), variables
    )
    int8_tree = JFaceExtraction(model=model, variables=variables, quantized=True).variables
    bridged = weights.state_dict_from_jax("iresnet18", jax.device_get(int8_tree))
    port = quantize_module(weights.load_model("iresnet18", weights.state_dict_from_jax("iresnet18", variables)))
    mine = port.state_dict()
    assert set(mine) == set(bridged)
    for key, value in bridged.items():
        assert mine[key].dtype == value.dtype, key
        assert torch.equal(mine[key], value), key
    q_keys = sorted(k for k in bridged if k.endswith(".weight_q"))
    # 16 block convs, 4 downsample convs (layer1's is exactly 64*64 = 4096) and fc.
    assert len(q_keys) == 21 and "layer1.0.downsample.0.weight_q" in q_keys
    assert "conv1.weight" in bridged and bridged["conv1.weight"].dtype == torch.float32
    assert tuple(bridged["fc.weight_q"].shape) == (512 * 7 * 7, 512)
    assert isinstance(port.fc, Int8Linear) and isinstance(port.layer1[0].conv1, Int8Conv2d)
    # The int8 tree loads into the int8 module as it is.
    loaded = weights.load_model("iresnet18", bridged)
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in bridged.items())
    assert quantize.quantized_bytes(port) < quantize.quantized_bytes(
        weights.load_model("iresnet18", weights.state_dict_from_jax("iresnet18", variables))
    ) / 3


def _operands(shape, seed):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    q, s = jq.quantize_array(rng.normal(0, 0.05, size=(k, n)).astype(np.float32))
    return x, q, s


def _scale_bound(x, q, s, bf16):
    """sum_k |x_k w_kn| in float64, x and w rounded to bf16 where the
    arithmetic rounds them."""
    xt, w = torch.from_numpy(x), torch.from_numpy(q).float() * torch.from_numpy(s)
    if bf16:
        xt = xt.bfloat16().float()
        w = (torch.from_numpy(q).bfloat16() * torch.from_numpy(s).bfloat16()).float()
    return xt.double().abs() @ w.double().abs()


@pytest.mark.parametrize("shape", [(8, 256, 512), (1, 100, 97), (3, 1000, 96)], ids=str)
def test_plain_bf16_matches_pallas_interpret(shape):
    """At M = 1, XLA on the CPU drops the kernel's bf16 rounding of q * s
    (the interpreted result equals x_bf16 @ (q * bf16(s)) in f32, 6.5e-4 of
    the bound away here), while at M >= 2 it keeps it, as the TPU does.  Each
    output row depends on its own x row only, so one x row is run with a
    zero row beside it."""
    x, q, s = _operands(shape, 3)
    xj = np.concatenate([x, np.zeros_like(x)]) if shape[0] == 1 else x
    want = np.asarray(jq.int8_matmul(jnp.asarray(xj), jnp.asarray(q), jnp.asarray(s), interpret=True))
    want = want[: shape[0]]
    got = quantize.int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s), "bf16")
    assert got.shape == shape[::2] and got.dtype == torch.float32
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert (err <= 1e-5 * _scale_bound(x, q, s, True).numpy()).all()


@pytest.mark.parametrize("shape", [(8, 256, 512), (1, 100, 97), (5, 4095, 130)], ids=str)
def test_plain_f32_matches_float64(shape):
    x, q, s = _operands(shape, 4)
    want = x.astype(np.float64) @ (q.astype(np.float32) * s).astype(np.float64)
    got = quantize.int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s.reshape(-1)))
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert (err <= 1e-5 * _scale_bound(x, q, s, False).numpy()).all()


def test_dispatcher_and_wrapper_contract():
    x, q, s = (torch.from_numpy(a) for a in _operands((2, 40, 24), 5))
    before = k3.launches
    assert torch.equal(quantize.int8_matmul(x, q, s), quantize.int8_matmul_plain(x, q, s))
    assert k3.launches == before  # the CPU path never reaches the kernel
    with pytest.raises(ValueError, match="unsupported device"):
        quantize.int8_matmul(x.to("meta"), q.to("meta"), s.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        k3.int8_matmul_cuda(x, q, s)
    with pytest.raises(TypeError, match="int8"):
        quantize.int8_matmul_plain(x, q.float(), s)
    with pytest.raises(ValueError, match="compute"):
        quantize.int8_matmul_plain(x, q, s, "fp8")
    with pytest.raises(ValueError, match="scale"):
        quantize.int8_matmul_plain(x, q, s[:, :5])
    assert quantize.int8_matmul(x[:0], q, s).shape == (0, 24)


#: The H100's multiprocessors and the clusters of 2 and 4 CTAs it holds at
#: once at this kernel's shared memory (rsfd_int8_matmul_max_clusters on the
#: card reads 66 and 30).
CARD = (132, (66, 30))


@pytest.mark.parametrize(
    "shape", [(8, 25088, 512), (1, 25088, 512), (3, 1000, 96), (5, 4095, 130), (2, 1, 1), (33, 25088, 512),
              (9, 17, 15), (64, 4096, 512)], ids=str)
def test_split_plan_covers_k(shape):
    """launch_plan: chunks of whole k-steps, at most 1024 rows, that cover K
    with at most cluster - 1 empty ones; whole clusters of 1, 2 or 4; one
    wave on 132 SMs wherever 1024-row chunks allow one; shared memory within
    the H100's 227 KB."""
    m, k, n = shape
    rows, chunks, cl = k3.launch_plan(m, k, n, *CARD)
    assert rows % 16 == 0 and rows <= 1024 and cl in (1, 2, 4) and chunks % cl == 0
    assert chunks * rows >= k > (chunks - cl) * rows
    tiles = -(-n // 128) * -(-m // (1 if m == 1 else 8))
    held = {1: CARD[0], 2: CARD[1][0], 4: CARD[1][1]}[cl]
    if tiles * -(-k // 1024) <= CARD[0] // 2:
        assert tiles * chunks <= CARD[0] and tiles * chunks // cl <= held
    for compute in quantize.COMPUTE_MODES:
        assert k3.smem_bytes(m, rows, compute) <= k3.SMEM_LIMIT
    assert k3.smem_bytes(8, 1024, "f32") <= k3.SMEM_LIMIT  # the largest chunk the kernel takes


def test_launch_plan_at_the_fc():
    """IResNet-50's fc: 4 column tiles x 32 chunks of 784 rows, 128 CTAs in
    clusters of 2 on the card (30 clusters of 4 would hold only 120), of 4
    on a card that holds 33."""
    assert k3.launch_plan(8, 25088, 512, *CARD) == (784, 32, 2)
    assert k3.launch_plan(1, 25088, 512, *CARD) == (784, 32, 2)
    assert k3.launch_plan(8, 25088, 512, 132, (66, 33)) == (784, 32, 4)


# --- The kernel's arithmetic, emulated ------------------------------------

#: Row of a k-step (16 rows) that the mma's k index kk reads: lane t holds
#: kk = 2t, 2t+1, 2t+8, 2t+9, which csrc/int8_matmul.cu maps to rows 4t ..
#: 4t + 3.
MMA_ROWS = [4 * ((kk % 8) // 2) + kk % 2 + 2 * (kk // 8) for kk in range(16)]


def _chop(v, top):
    """v (float64) truncated toward zero to a multiple of 2^(e - 24), where
    2^e > |top| >= 2^(e - 1): the 24 bits below top's leading bit."""
    unit = torch.ldexp(torch.ones_like(top), torch.frexp(top.abs())[1] - 24)
    return torch.trunc(v / unit) * unit


def _mma(acc, prods):
    """One m16n8k16 mma's f32 accumulation as NVIDIA tensor cores were
    measured to add (Fasi, Higham, Mikaitis and Pranesh, PeerJ CS 2021),
    taken as two steps of 8 products (kk 0-7, then 8-15): the accumulator
    and the exact products aligned to the largest of them with the bits past
    24 truncated, summed, and the sum rounded toward zero to f32."""
    for half in (prods[:8], prods[8:]):
        top = torch.maximum(acc.abs(), half.abs().amax(0))
        total = _chop(acc, top) + _chop(half, top).sum(0)
        acc = _chop(total, total)
    return acc


def _emulate_kernel(x, q, s, compute, plan, parts=3):
    """csrc/int8_matmul.cu's arithmetic in torch, in the kernel's order.

    f32: x split into ``parts`` bf16 parts (hi = bf16(x), mid = bf16(x -
    hi), ...; each difference exact in f32), every product of a part and an
    integer q exact, the scale factored out to the end.  bf16: x rounded to
    bf16 and the weight bf16(bf16(q) * bf16(s)), one part.  The K axis is
    cut by ``plan`` = (rows per chunk, chunks, cluster); a chunk's k-steps of
    16 rows go in stages of 8, warp w of the 4 along K taking k-steps 2w and
    2w + 1 of each stage, each k-step one mma per part into that warp's
    accumulator (``_mma``, in the mma's k order).  Then in f32,
    round-to-nearest: a warp's parts (lo + mid) + hi; the 4 warps in order;
    the chunks of a cluster in rank order; the clusters in order; times the
    scale.  A k-step past the chunk's rows adds exact zeros, as skipping it
    does."""
    rows, chunks, cl = plan
    m, k = x.shape
    n = q.shape[1]
    xt = torch.from_numpy(x)
    if compute == "bf16":
        xparts = [xt.bfloat16().float()]
        w = (torch.from_numpy(q).bfloat16() * torch.from_numpy(s).reshape(1, n).bfloat16()).double()
    else:
        xparts, r = [], xt.clone()
        for _ in range(parts):
            xparts.append(r.bfloat16().float())
            r = r - xparts[-1]
        w = torch.from_numpy(q).double()
    stages = -(-rows // 128)
    kp = chunks * stages * 128  # each chunk padded to whole stages
    xp = torch.zeros(len(xparts), m, chunks, stages * 128, dtype=torch.float64)
    wp = torch.zeros(chunks, stages * 128, n, dtype=torch.float64)
    for c in range(chunks):
        lo, hi = c * rows, min((c + 1) * rows, k)
        if hi > lo:
            xp[:, :, c, : hi - lo] = torch.stack(xparts)[:, :, lo:hi].double()
            wp[c, : hi - lo] = w[lo:hi]
    assert kp >= k
    # (stage, warp, u, row) with the rows in the mma's k order
    xp = xp.reshape(len(xparts), m, chunks, stages, 4, 2, 16)[..., MMA_ROWS]
    wp = wp.reshape(chunks, stages, 4, 2, 16, n)[..., MMA_ROWS, :]
    out = torch.empty(m, n, dtype=torch.float32)
    for n0 in range(0, n, 32):  # column blocks keep the float64 temporaries small
        wb = wp[..., n0 : n0 + 32]
        acc = torch.zeros(4, len(xparts), chunks, m, wb.shape[-1], dtype=torch.float64)
        for st in range(stages):
            for u in range(2):
                # prods[kk, warp, part, chunk, m, n]
                a = xp[:, :, :, st, :, u, :].permute(4, 3, 0, 2, 1)  # (16, 4, P, C, m)
                b = wb[:, st, :, u].permute(2, 1, 0, 3)  # (16, 4, C, n)
                acc = _mma(acc, a[..., None] * b[:, :, None, :, None, :])
        v = acc.float()  # (warp, part, chunk, m, n)
        per_warp = v[:, len(xparts) - 1]
        for j in range(len(xparts) - 2, -1, -1):
            per_warp = per_warp + v[:, j]  # (lo + mid) + hi
        cta = ((per_warp[0] + per_warp[1]) + per_warp[2]) + per_warp[3]  # (C, m, n)
        clusters = cta.reshape(chunks // cl, cl, m, -1)
        total = None
        for g in range(chunks // cl):
            part = clusters[g, 0]
            for r in range(1, cl):
                part = part + clusters[g, r]
            total = part if total is None else total + part
        out[:, n0 : n0 + 32] = total
    if compute == "f32":
        out = out * torch.from_numpy(s.reshape(1, n))
    return out


def _positive_operands(shape, seed):
    """All-positive x and q: every product adds, so the truncating adds lose
    the most relative to sum |x w|."""
    m, k, n = shape
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=(m, k)).astype(np.float32)
    q, s = jq.quantize_array(rng.uniform(0.0, 0.05, size=(k, n)).astype(np.float32))
    return x, q, s


def _jax_reference(x, q, s, compute):
    """JAX's result: dequantize_array then an f32 dot (f32), the Pallas
    kernel in interpret mode (bf16; one row runs beside a zero row, see
    test_plain_bf16_matches_pallas_interpret)."""
    if compute == "f32":
        w = jq.dequantize_array(jnp.asarray(q), jnp.asarray(s))
        return np.asarray(jnp.dot(jnp.asarray(x), w, precision=jax.lax.Precision.HIGHEST))
    xj = np.concatenate([x, np.zeros_like(x)]) if x.shape[0] == 1 else x
    return np.asarray(jq.int8_matmul(jnp.asarray(xj), jnp.asarray(q), jnp.asarray(s), interpret=True))[: x.shape[0]]


#: (shape, plan or None for the kernel's own, all-positive operands)
EMULATION_CASES = {
    "(8, 256, 512)": ((8, 256, 512), None, False),
    "(1, 100, 97)": ((1, 100, 97), None, False),
    "(3, 1000, 96)": ((3, 1000, 96), None, False),
    "(5, 4095, 130)": ((5, 4095, 130), None, False),
    "(9, 300, 40)": ((9, 300, 40), None, False),
    "positive (8, 4096, 64)": ((8, 4096, 64), None, True),
    "positive (8, 4096, 64), 1024-row chunks": ((8, 4096, 64), (1024, 4, 2), True),
}


@pytest.mark.parametrize("compute", quantize.COMPUTE_MODES)
@pytest.mark.parametrize("case", list(EMULATION_CASES))
def test_kernel_emulation_meets_the_bound(case, compute):
    """The arithmetic the kernel ships, emulated on the CPU, within 1e-5 of
    sum_k |x_k w_kn| against int8_matmul_plain and against JAX, on the
    kernel's own plan at these shapes, and on 1024-row chunks, the largest
    the plan makes (each warp's chain is then 16 mma long, the most the
    kernel runs).  Margin found: the emulation's error is at most 0.15 of
    the bound on these cases (bf16, all-positive, 1024-row chunks; 0.05 in
    f32)."""
    shape, plan, positive = EMULATION_CASES[case]
    x, q, s = (_positive_operands if positive else _operands)(shape, 11)
    s = s.reshape(-1)
    plan = plan or k3.launch_plan(*shape, *CARD)
    got = _emulate_kernel(x, q, s, compute, plan).numpy().astype(np.float64)
    bound = 1e-5 * _scale_bound(x, q, s.reshape(1, -1), compute == "bf16").numpy()
    plain = quantize.int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s), compute)
    assert (np.abs(got - plain.numpy()) <= bound).all()
    assert (np.abs(got - _jax_reference(x, q, s, compute)) <= bound).all()


@pytest.mark.parametrize("mutation", ["one chunk over the whole K", "two bf16 parts"])
def test_kernel_emulation_mutations(mutation):
    """What the design's two choices buy, on all-positive data.  One chunk
    over the whole K (K = 16384: a 256-mma chain per warp under the
    truncating adds) misses the bound, 3.2 times over.  A two-part split of
    x is not what keeps the kernel inside it: the remainder it drops is at
    most 2^-17 of |x|, below 1e-5, and at K = 4096 on the kernel's plan the
    emulation stays within the bound (0.04 of it, as with three parts); the
    third part is margin, not necessity."""
    if mutation == "one chunk over the whole K":
        x, q, s = _positive_operands((8, 16384, 16), 12)
        plan, parts = (16384, 1, 1), 3
    else:
        x, q, s = _positive_operands((8, 4096, 32), 12)
        plan, parts = k3.launch_plan(8, 4096, 32, *CARD), 2
    s = s.reshape(-1)
    bound = 1e-5 * _scale_bound(x, q, s.reshape(1, -1), False).numpy()
    want = x.astype(np.float64) @ (q.astype(np.float32) * s).astype(np.float64)
    err = np.abs(_emulate_kernel(x, q, s, "f32", plan, parts=parts).numpy() - want)
    if mutation == "one chunk over the whole K":
        assert (err > bound).any()
    else:
        assert (err <= bound).all()
