"""ops/quantize.py and models/quantized.py against the JAX package's
weight-only int8 (rs_face_detection_tpu/ops/quantize.py).

Tolerances: the quantizer is exact (q and s equal, leaf for leaf after the
layout maps).  K3's plain version is held within 1e-5 of sum_k |x_k w_kn|
per output: against the Pallas kernel in interpret mode in bf16 (the same
bf16 roundings of x and w, only the f32 summation order differs), and
against numpy float64 in f32.  The CUDA kernel itself is held against the
plain version on the card (marked ``gpu``).
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


def test_split_plan_covers_k():
    for m, k, n in ((8, 25088, 512), (1, 25088, 512), (3, 1000, 96), (5, 4095, 130), (2, 1, 1)):
        rows, chunks = k3.split_plan(m, k, n, 132)
        assert rows % 32 == 0 and rows <= 1024 and chunks * rows >= k > (chunks - 1) * rows
    assert k3.split_plan(8, 25088, 512, 132) == (768, 33)  # 4 column tiles x 33 chunks: 132 CTAs


@pytest.mark.gpu
@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize(
    "shape", [(8, 25088, 512), (1, 25088, 512), (3, 1000, 96), (5, 4095, 130), (0, 64, 32)], ids=str
)
def test_kernel_matches_plain_on_the_card(shape, compute):
    """K3 against the plain version on the same inputs: within 1e-5 of
    sum_k |x_k w_kn| (f32 sums in another order); M = 0 launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("K3 is a CUDA kernel and this host has no card")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, q, s = _operands(shape, 6)
    xt, qt, st = (torch.from_numpy(a).cuda() for a in (x, q, s))
    before = k3.launches
    got = k3.int8_matmul_cuda(xt, qt, st, compute)
    want = quantize.int8_matmul_plain(xt, qt, st, compute)
    torch.cuda.synchronize()
    assert k3.launches == before + (shape[0] > 0)
    assert got.shape == want.shape
    bound = 1e-5 * _scale_bound(x, q, s, compute == "bf16").cuda()
    assert bool(((got - want).abs().double() <= bound).all())
