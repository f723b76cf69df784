"""The port's four CUDA kernels against their plain PyTorch versions, and its
int8 conv against the CPU's, and the kernels' custom ops against the direct
wrappers, on the card.  Every test here is marked ``gpu`` and skips where there is no card.

This file imports only numpy, pytest, torch and the port, so it runs where
JAX is not installed.  tests/conftest.py imports JAX, so on the card run it
without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Inputs are made from seeds with numpy.  The helpers are numpy copies of the
ones in the CPU test files (test_torch_nms.py, test_torch_stem.py,
test_torch_quantize.py), which hold the plain versions against JAX.

Tolerances:
  - K1 (csrc/nms.cu): bit-exact (torch.equal) with nms_mask_plain, on the
    card and on the CPU;
  - K2 (csrc/stem.cu): 1e-5 of the output's magnitude, TF32 off;
  - K3 (csrc/int8_matmul.cu): 1e-5 of sum_k |x_k w_kn| per output;
  - K4 (csrc/attention.cu): f32 2e-5 of max|v|, bf16 1e-2 of max|v|;
  - the int8-activation conv of ops/int8_conv.py (torch._int_mm, a library
    GEMM): codes and int32 accumulators bit-exact with the CPU's.
"""

import numpy as np
import pytest
import torch

from rs_face_detection_tpu_torch.kernels import attention as katt
from rs_face_detection_tpu_torch.kernels import int8_matmul as k3
from rs_face_detection_tpu_torch.kernels import nms as knms
from rs_face_detection_tpu_torch.kernels import stem as kstem
from rs_face_detection_tpu_torch.ops import quantize
from rs_face_detection_tpu_torch.ops.attention import attention_plain
from rs_face_detection_tpu_torch.ops.nms import nms_mask_plain
from rs_face_detection_tpu_torch.ops.stem import fold_stem_params, fused_stem_plain

#: The pixel normalization of tests/test_stem_pallas.py.
MEANS = (123.675, 116.28, 103.53)
STDS = (58.395, 57.12, 57.375)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


# --- K1: greedy NMS -------------------------------------------------------


def _random_dets(rng, n, ties=False):
    ctr = rng.uniform(0, 400, size=(n, 2)).astype(np.float32)
    wh = rng.uniform(5, 150, size=(n, 2)).astype(np.float32)
    score = rng.uniform(0, 1, size=(n, 1)).astype(np.float32)
    if ties:  # duplicate boxes and exactly equal scores
        ctr = np.round(ctr / 25) * 25
        wh = np.round(wh / 40) * 40 + 5
        score = np.round(score * 4) / 4
    return np.concatenate([ctr - wh / 2, ctr + wh / 2, score], axis=1).astype(np.float32)


def _sorted(dets):
    order = np.argsort(-dets[:, 4], kind="stable")
    return order, np.ascontiguousarray(dets[order, :4])


def _sorted_batch(rng, b, k, ties=True):
    return np.stack([_sorted(_random_dets(rng, k, ties))[1] for _ in range(b)])


def _check_nms(dev, boxes, valid, thr):
    """One launch; the mask equals nms_mask_plain on the card and on the CPU."""
    b, v = torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev)
    before = knms.launches
    got = knms.nms_mask_cuda(b, v, thr)
    torch.cuda.synchronize()
    assert knms.launches == before + 1
    assert got.dtype == torch.bool and got.shape == v.shape
    assert torch.equal(got, nms_mask_plain(b, v, thr))
    assert torch.equal(got.cpu(), nms_mask_plain(b.cpu(), v.cpu(), thr))
    return got.cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("k", [16, 100, 128, 130, 1000, 1024])
def test_nms_kernel_matches_plain(cuda, k):
    rng = np.random.default_rng(k)
    boxes = _sorted_batch(rng, 32, k)
    _check_nms(cuda, boxes, rng.uniform(size=(32, k)) > 0.2, 0.45)


def _valid_pattern(rng, pattern, b, k):
    if pattern == "all":
        return np.ones((b, k), bool)
    if pattern == "none":
        return np.zeros((b, k), bool)
    if pattern == "prefix":  # as stable_topk leaves them: the whole row, none, one, word ends
        ends = [k, 0, 1, min(k, 64), min(k, 65), int(rng.integers(0, k + 1))]
        return np.arange(k)[None, :] < np.array([ends[i % len(ends)] for i in range(b)])[:, None]
    valid = rng.uniform(size=(b, k)) > 0.4  # scattered holes
    valid[0, -1] = True  # the last box valid, n = K
    return valid


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["prefix", "holes", "none", "all"])
@pytest.mark.parametrize("k", [1, 63, 64, 65, 128, 256, 1024])
def test_nms_kernel_valid_patterns(cuda, k, pattern):
    """The valid bound n and the word edges: n is 1 + the last valid index,
    so rows and columns past it are never computed and come back 0."""
    rng = np.random.default_rng(10 * k + len(pattern))
    valid = _valid_pattern(rng, pattern, 6, k)
    keep = _check_nms(cuda, _sorted_batch(rng, 6, k), valid, 0.45)
    assert not keep[~valid].any()


@pytest.mark.gpu
@pytest.mark.parametrize("k", [64, 256])
def test_nms_kernel_nan_coordinates(cuda, k):
    """A box with a NaN coordinate neither suppresses nor is suppressed."""
    rng = np.random.default_rng(20 + k)
    boxes = _sorted_batch(rng, 4, k)
    boxes[:, ::5, 2] = np.nan
    boxes[:, 3::11, 1] = np.nan
    keep = _check_nms(cuda, boxes, np.ones((4, k), bool), 0.45)
    assert keep[:, ::5].all()


@pytest.mark.gpu
@pytest.mark.parametrize("thr", [0.45, -0.1])
def test_nms_kernel_infinite_coordinates(cuda, thr):
    rng = np.random.default_rng(31)
    boxes = _sorted_batch(rng, 4, 96)
    boxes[:, ::7, 2] = np.inf
    boxes[:, 3::7, 0] = np.inf
    boxes[:, 1::9, 1] = -np.inf
    _check_nms(cuda, boxes, np.ones((4, 96), bool), thr)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [65, 256])
def test_nms_kernel_duplicate_boxes(cuda, k):
    """Runs of identical boxes (IoU exactly 1): only the first of a run is kept."""
    rng = np.random.default_rng(40 + k)
    base = _sorted_batch(rng, 3, (k + 3) // 4)
    boxes = np.ascontiguousarray(np.repeat(base, 4, axis=1)[:, :k])
    keep = _check_nms(cuda, boxes, np.ones((3, k), bool), 0.45)
    assert not keep[:, 1::4].any()


@pytest.mark.gpu
@pytest.mark.parametrize("thr", [0.0, -0.1])
@pytest.mark.parametrize("k", [100, 256])
def test_nms_kernel_thresholds(cuda, k, thr):
    """thr 0: any overlap suppresses, a division-free IoU of 0 never does.
    thr < 0: every IoU of 0 suppresses too, so no shortcut applies."""
    rng = np.random.default_rng(50 + k)
    valid = rng.uniform(size=(4, k)) > 0.3
    keep = _check_nms(cuda, _sorted_batch(rng, 4, k, ties=False), valid, thr)
    if thr < 0:  # boxes with finite coordinates: the first valid box alone survives
        assert (keep.sum(1) == valid.any(1)).all()


# --- K2: the fused ResNet-50 stem ----------------------------------------


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


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 640, 640), (2, 72, 96), (3, 70, 34), (1, 2, 2)])
def test_stem_kernel_matches_plain(cuda, shape):
    """K2 against the plain version on the card, TF32 off.  Bound: 1e-5 of
    the output's magnitude (192 exact products of pixel values and split
    weights, summed in another order, and the mean correction)."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        params = (torch.from_numpy(p) for p in _stem_weights(8))
        consts = [c.to(cuda) for c in fold_stem_params(*params, MEANS, STDS, 1.0)]
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


# --- K4: flash attention --------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize(
    "shape",
    [(8, 257, 16, 64), (1, 257, 16, 64), (2, 17, 2, 32), (1, 1, 16, 64), (3, 197, 12, 64), (1, 600, 2, 64),
     (8, 600, 16, 64)],
    ids=str,
)
def test_attention_kernel_matches_plain_on_the_card(cuda, shape, dtype):
    """K4 against the plain version on the same inputs (strided qkv views):
    f32 within 2e-5 of max|v| (sums in another order), bf16 within 1e-2 of
    max|v| (P is rounded to bf16 before PV).  At N = 600 K and V stream
    through the 8-stage ring; (8, 600, 16, 64) streams it over three rounds
    of 7 warps."""
    arr = np.random.default_rng(5).normal(size=(shape[0], shape[1], 3, *shape[2:]))
    q, k, v = torch.from_numpy(arr).to(cuda, dtype).unbind(2)  # strided views
    before = katt.launches
    got = katt.flash_attention_cuda(q, k, v)
    want = attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert katt.launches == before + 1
    bound = (2e-5 if dtype == torch.float32 else 1e-2) * float(v.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= bound


# --- K3: the int8 dequant-matmul -----------------------------------------


def _operands(shape, seed):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    q, s = quantize.quantize_array(rng.normal(0, 0.05, size=(k, n)).astype(np.float32))
    return x, q, s


def _scale_bound(x, q, s, bf16):
    """sum_k |x_k w_kn| in float64, x and w rounded to bf16 where the
    arithmetic rounds them."""
    xt, w = torch.from_numpy(x), torch.from_numpy(q).float() * torch.from_numpy(s)
    if bf16:
        xt = xt.bfloat16().float()
        w = (torch.from_numpy(q).bfloat16() * torch.from_numpy(s).bfloat16()).float()
    return xt.double().abs() @ w.double().abs()


def _check_int8_matmul(dev, x, q, s, compute, qt=None):
    """One launch (none at M = 0); within 1e-5 of sum_k |x_k w_kn| of the
    plain version on the same inputs (f32 sums in another order), TF32 off.
    Returns the kernel's output."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        xt, st = torch.from_numpy(x).to(dev), torch.from_numpy(s).to(dev)
        qt = torch.from_numpy(q).to(dev) if qt is None else qt
        before = k3.launches
        got = k3.int8_matmul_cuda(xt, qt, st, compute)
        want = quantize.int8_matmul_plain(xt, qt, st, compute)
        torch.cuda.synchronize()
        assert k3.launches == before + (x.shape[0] > 0)
        assert got.shape == want.shape and got.dtype == torch.float32
        bound = 1e-5 * _scale_bound(x, q, s, compute == "bf16").to(dev)
        assert bool(((got - want).abs().double() <= bound).all())
        return got
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.gpu
@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize(
    "shape",
    [(8, 25088, 512), (1, 25088, 512), (3, 1000, 96), (5, 4095, 130), (0, 64, 32),
     (2, 25088, 512), (9, 25088, 512), (17, 4095, 512), (33, 25088, 512),
     (5, 17, 96), (5, 4095, 96), (3, 1000, 1), (3, 1000, 15), (3, 1000, 130)],
    ids=str,
)
def test_int8_matmul_kernel_matches_plain_on_the_card(cuda, shape, compute):
    """K3 against the plain version on the same inputs: within 1e-5 of
    sum_k |x_k w_kn|; M = 0 launches nothing.  The shapes take every row
    tile (M = 1, 2, 8, 9, 17, 33), a ragged K tail (17, 4095) and ragged
    column tiles (N = 1, 15, 130: byte loads into the ring)."""
    _check_int8_matmul(cuda, *_operands(shape, 6), compute)


@pytest.mark.gpu
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_int8_matmul_kernel_all_positive(cuda, compute):
    """All-positive x and q at the fc's shape: every product adds, the case
    where the tensor cores' truncating adds lose the most."""
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, size=(8, 25088)).astype(np.float32)
    q, s = quantize.quantize_array(rng.uniform(0, 0.05, size=(25088, 512)).astype(np.float32))
    _check_int8_matmul(cuda, x, q, s, compute)


@pytest.mark.gpu
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_int8_matmul_kernel_misaligned_q(cuda, compute):
    """A contiguous q one byte past a 16-byte boundary: byte loads."""
    x, q, s = _operands((5, 1000, 96), 8)
    buf = torch.empty(q.size + 1, dtype=torch.int8, device=cuda)
    qt = buf[1:].view(q.shape)
    qt.copy_(torch.from_numpy(q))
    assert qt.is_contiguous() and qt.data_ptr() % 16 == 1
    _check_int8_matmul(cuda, x, q, s, compute, qt=qt)


@pytest.mark.gpu
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_int8_matmul_kernel_repeats_and_graph(cuda, compute):
    """Two calls give the same bits (the K chunks are summed in a fixed
    order, no float atomics), and a call captured in a CUDA graph and
    replayed gives the eager call's bits (no host sync, no per-call host
    state)."""
    x, q, s = (torch.from_numpy(a).to(cuda) for a in _operands((8, 25088, 512), 9))
    first = k3.int8_matmul_cuda(x, q, s, compute)
    second = k3.int8_matmul_cuda(x, q, s, compute)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture
        k3.int8_matmul_cuda(x, q, s, compute)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = k3.int8_matmul_cuda(x, q, s, compute)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(captured, first)


# --- the int8-activation conv (torch._int_mm, no kernel of the port's own) --


def _ties_amax(rng):
    """An amax whose f32 quotient amax / 127 differs from amax times the f32
    reciprocal of 127, and inputs that sit at rounding ties of the quotient."""
    while True:
        amax = np.float32(rng.uniform(100, 900))
        sx = amax / np.float32(127)
        if sx != amax * (np.float32(1) / np.float32(127)):
            return amax, sx


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case",
    [((1, 1, 32, 16), (1, 1), ((0, 0), (0, 0))), ((3, 3, 3, 8), (2, 2), ((1, 1), (1, 1))),
     ((3, 3, 64, 64), (2, 2), ((1, 1), (1, 1))), ((4, 4, 12, 64), (1, 1), ((2, 1), (2, 1))),
     ((1, 1, 64, 256), (2, 2), ((0, 0), (0, 0)))],
    ids=["1x1_s1", "3x3_s2_k27", "3x3_s2", "stem_4x4_pad21", "1x1_s2"],
)
def test_int8_conv_on_the_card_equals_the_cpu(cuda, case):
    """Codes and int32 accumulators on the card equal the CPU's bit for bit,
    on inputs at rounding ties (the scale is a true division on the card
    too) and at sizes that pad M, K and N."""
    from rs_face_detection_tpu_torch.ops.int8_conv import int8_conv2d, quantize_activation

    (kh, kw, i, o), stride, padding = case
    rng = np.random.default_rng(kh * 100 + i)
    amax, sx = _ties_amax(rng)
    halves = rng.integers(-254, 255, size=(3, i, 9, 7)).astype(np.float32) / 2
    x = torch.from_numpy((halves * sx).astype(np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, size=(o, i, kh, kw)).astype(np.int8))
    a = torch.tensor(amax)
    codes = quantize_activation(x, a)
    codes_dev = quantize_activation(x.to(cuda), a.to(cuda))
    assert torch.equal(codes_dev.cpu(), codes)
    for b in (3, 1):  # b1 of a 9x7 frame pads M at stride 2
        acc = int8_conv2d(codes[:b], w, stride, padding)
        acc_dev = int8_conv2d(codes_dev[:b], w.to(cuda), stride, padding)
        assert acc_dev.dtype == torch.int32 and torch.equal(acc_dev.cpu(), acc)


# --- the kernels as custom ops ------------------------------------------------


def _op_and_wrapper(case, dev, rng):
    """(the custom op's dispatcher, the direct wrapper, its launch counter
    module, the arguments) at a main-path shape."""
    from rs_face_detection_tpu_torch.ops import attention, nms, stem

    if case == "nms_mask":
        boxes = torch.from_numpy(_sorted_batch(rng, 8, 128)).to(dev)
        valid = torch.from_numpy(rng.uniform(size=(8, 128)) > 0.2).to(dev)
        return nms.nms_mask, knms.nms_mask_cuda, knms, (boxes, valid, 0.45)
    if case == "fused_stem":
        canvas = torch.from_numpy(rng.integers(0, 256, (2, 72, 96, 3), dtype=np.uint8)).to(dev)
        consts = fold_stem_params(
            *(torch.from_numpy(a.astype(np.float32)) for a in (
                rng.normal(size=(4, 4, 12, 64)) / 14.0, rng.uniform(0.5, 1.5, 64), rng.normal(0, 0.1, 64),
                rng.normal(0, 0.1, 64), rng.uniform(0.5, 1.5, 64))), MEANS, STDS, 1.0)
        return stem.fused_stem, kstem.fused_stem_cuda, kstem, (canvas, *(c.to(dev) for c in consts))
    if case == "attention":
        qkv = torch.from_numpy(rng.normal(size=(2, 257, 3, 16, 64)).astype(np.float32)).to(dev, torch.bfloat16)
        return attention.attention, katt.flash_attention_cuda, katt, (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    x = torch.from_numpy(rng.normal(size=(8, 4096)).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.integers(-127, 128, (4096, 512), dtype=np.int8)).to(dev)
    s = torch.from_numpy(rng.uniform(0.001, 0.01, 512).astype(np.float32)).to(dev)
    return quantize.int8_matmul, k3.int8_matmul_cuda, k3, (x, q, s, "f32")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["nms_mask", "fused_stem", "attention", "int8_matmul"])
def test_custom_op_on_the_card_equals_the_wrapper(cuda, case):
    """The rsfd:: custom op launches the kernel once (no fallback to the
    plain version) and gives the direct wrapper's bits."""
    op, wrapper, counter, args = _op_and_wrapper(case, cuda, np.random.default_rng(31))
    before = counter.launches
    got = op(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = wrapper(*args)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape and got.stride() == want.stride()
    assert torch.equal(got, want)
