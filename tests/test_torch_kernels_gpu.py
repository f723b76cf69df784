"""The port's four CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``gpu`` and skips where there is no card.

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
  - K4 (csrc/attention.cu): f32 2e-5 of max|v|, bf16 1e-2 of max|v|.
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


@pytest.mark.gpu
@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize(
    "shape", [(8, 25088, 512), (1, 25088, 512), (3, 1000, 96), (5, 4095, 130), (0, 64, 32)], ids=str
)
def test_int8_matmul_kernel_matches_plain_on_the_card(cuda, shape, compute):
    """K3 against the plain version on the same inputs: within 1e-5 of
    sum_k |x_k w_kn| (f32 sums in another order); M = 0 launches nothing."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x, q, s = _operands(shape, 6)
        xt, qt, st = (torch.from_numpy(a).to(cuda) for a in (x, q, s))
        before = k3.launches
        got = k3.int8_matmul_cuda(xt, qt, st, compute)
        want = quantize.int8_matmul_plain(xt, qt, st, compute)
        torch.cuda.synchronize()
        assert k3.launches == before + (shape[0] > 0)
        assert got.shape == want.shape
        bound = 1e-5 * _scale_bound(x, q, s, compute == "bf16").to(cuda)
        assert bool(((got - want).abs().double() <= bound).all())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
