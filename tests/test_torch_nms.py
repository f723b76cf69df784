"""The port's greedy NMS: plain PyTorch bit-exact against every JAX variant.

The plain version (ops/nms.py::nms_mask_plain) is the CUDA kernel's
reference and the CPU path; it must give the same keep mask, bit for bit, as
nms_mask_greedy, nms_mask_fixpoint, the Pallas kernel (interpret mode) and
the host oracle nms_numpy, batched over images.  The CUDA kernel's own steps
(csrc/nms.cu: the valid bound, 32-lane ballot words, the scan over kept
boxes only) are emulated in numpy and held to the same masks bit for bit.
The kernel itself is held against the plain version on the card
(tests/test_torch_kernels_gpu.py, and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_face_detection_tpu.ops.nms import nms_mask_fixpoint, nms_mask_greedy, nms_numpy
from rs_face_detection_tpu.ops.nms_pallas import nms_mask_pallas
from rs_face_detection_tpu_torch.kernels import nms as knms
from rs_face_detection_tpu_torch.ops.nms import nms_mask, nms_mask_plain

torch.set_num_threads(2)


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


def _jax_masks(boxes, valid, thr):
    b, v = jnp.asarray(boxes), jnp.asarray(valid)
    return {
        "greedy": np.asarray(nms_mask_greedy(b, v, thr)),
        "fixpoint": np.asarray(nms_mask_fixpoint(b, v, thr)),
        "pallas": np.asarray(nms_mask_pallas(b, v, thr, interpret=True)),
    }


def _check_batch(boxes, valid, thr):
    """Port's batched plain mask equals every JAX variant, image by image."""
    port = nms_mask_plain(torch.from_numpy(boxes), torch.from_numpy(valid), thr).numpy()
    for i in range(boxes.shape[0]):
        for name, mask in _jax_masks(boxes[i], valid[i], thr).items():
            np.testing.assert_array_equal(port[i], mask, err_msg=f"image {i} vs {name}")
    return port


def test_golden_case():
    dets = np.array(
        [
            [100.0, 100.0, 210.0, 210.0, 0.72],
            [250.0, 250.0, 420.0, 420.0, 0.8],
            [220.0, 220.0, 320.0, 330.0, 0.92],
            [100.0, 100.0, 210.0, 210.0, 0.6],
        ],
        dtype=np.float32,
    )
    order, boxes = _sorted(dets)
    keep = _check_batch(boxes[None], np.ones((1, 4), bool), 0.4)[0]
    assert [int(order[i]) for i in range(4) if keep[i]] == [2, 1, 0] == nms_numpy(dets, 0.4)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [16, 100, 130, 256])
def test_random_batches(k, ties):
    rng = np.random.default_rng(k + 1000 * ties)
    dets = [_random_dets(rng, k, ties) for _ in range(3)]
    sorted_ = [_sorted(d) for d in dets]
    boxes = np.stack([s[1] for s in sorted_])
    port = _check_batch(boxes, np.ones((3, k), bool), 0.45)
    for d, (order, _), keep in zip(dets, sorted_, port):
        assert [int(order[i]) for i in range(k) if keep[i]] == nms_numpy(d, 0.45)


@pytest.mark.parametrize("thr", [0.2, 0.7])
def test_other_thresholds(thr):
    rng = np.random.default_rng(7)
    boxes = np.stack([_sorted(_random_dets(rng, 64))[1] for _ in range(2)])
    _check_batch(boxes, np.ones((2, 64), bool), thr)


def test_suppression_chain():
    n = 40
    dets = np.array(
        [[i * 6.0, 0.0, i * 6.0 + 12.0, 12.0, 1.0 - i * 0.01] for i in range(n)],
        dtype=np.float32,
    )
    _, boxes = _sorted(dets)
    keep = _check_batch(boxes[None], np.ones((1, n), bool), 0.3)[0]
    assert np.flatnonzero(keep).tolist() == list(range(0, n, 2)) == nms_numpy(dets, 0.3)


def test_invalid_padding():
    rng = np.random.default_rng(3)
    boxes = np.stack([_sorted(_random_dets(rng, 48, ties=True))[1] for _ in range(4)])
    valid = np.ones((4, 48), bool)
    valid[0] = False  # all invalid
    valid[1, 30:] = False  # trailing padding
    valid[2, ::3] = False  # holes
    port = _check_batch(boxes, valid, 0.45)
    assert not port[0].any()
    assert not port[~valid].any()
    # Trailing padding never changes the kept rows before it.
    head = nms_mask_plain(torch.from_numpy(boxes[1:2, :30]), torch.ones(1, 30, dtype=torch.bool), 0.45)
    np.testing.assert_array_equal(port[1, :30], head[0].numpy())


def test_nan_boxes_do_not_suppress():
    rng = np.random.default_rng(5)
    boxes = np.stack([_sorted(_random_dets(rng, 32, ties=True))[1] for _ in range(2)])
    boxes[:, ::5, 2] = np.nan
    _check_batch(boxes, np.ones((2, 32), bool), 0.45)


def test_nms_mask_runs_plain_on_cpu():
    rng = np.random.default_rng(9)
    boxes = torch.from_numpy(np.stack([_sorted(_random_dets(rng, 20))[1] for _ in range(2)]))
    valid = torch.ones(2, 20, dtype=torch.bool)
    before = knms.launches
    assert torch.equal(nms_mask(boxes, valid, 0.45), nms_mask_plain(boxes, valid, 0.45))
    assert knms.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        knms.nms_mask_cuda(torch.zeros(1, 4, 4), torch.ones(1, 4, dtype=torch.bool), 0.45)


# --- csrc/nms.cu, step by step -------------------------------------------

_WARPS = 32  # kThreads / 32
_MASK64 = (1 << 64) - 1


def _ballot(pred):
    """__ballot_sync over 32 lanes: bit l set when lane l's predicate holds."""
    return int(np.packbits(np.asarray(pred, bool), bitorder="little").view("<u4")[0])


def _suppresses(a, area_a, b, area_b, thr):
    """The kernel's ``suppresses`` over the 32 lanes' boxes b, in float32."""
    one = np.float32(1)
    iw = np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]) + one
    ih = np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1]) + one
    iw = np.where(iw < 0, np.float32(0), iw)  # clamp0 keeps a NaN
    ih = np.where(ih < 0, np.float32(0), ih)
    inter = iw * ih
    skip = (inter == 0) & (thr >= 0)  # the exact shortcut: no division
    return ~skip & (inter / (area_a + area_b - inter) > thr)


def _kernel_emulation(boxes, valid, thr, rng):
    """The keep mask as csrc/nms.cu computes it, image by image: phase 0's
    ballot bit sets and valid bound n, phase 1's 32-column ballot words
    (rows in the zigzag order; the words a row leaves unwritten hold random
    bits, as uninitialised shared memory may), phase 2's scan over kept boxes
    only, with a removed word per lane."""
    batch, k = valid.shape
    thr = np.float32(thr)
    span = 64 * ((k + 63) // 64)
    keep = np.zeros((batch, k), bool)
    for img in range(batch):
        box = np.zeros((span, 4), np.float32)
        box[:k] = boxes[img]
        v = np.zeros(span, bool)
        v[:k] = valid[img]
        ok = v & ~np.isnan(box).any(1)
        area = (box[:, 2] - box[:, 0] + np.float32(1)) * (box[:, 3] - box[:, 1] + np.float32(1))
        vbits = [_ballot(v[c : c + 32]) for c in range(0, span, 32)]
        okbits = [_ballot(ok[c : c + 32]) for c in range(0, span, 32)]
        n = 1 + max((c * 32 + b.bit_length() - 1 for c, b in enumerate(vbits) if b), default=-1)
        chunks, words = (n + 31) // 32, (n + 63) // 64
        rows = rng.integers(0, 1 << 32, size=(n, 2 * words), dtype=np.uint64)
        order = [
            _WARPS * q + (_WARPS - 1 - g if q & 1 else g)
            for q in range(n // _WARPS + 1)
            for g in range(_WARPS)
        ]
        for i in (i for i in order if i < n):
            if not (vbits[i >> 5] >> (i & 31)) & 1:
                continue
            ok_i = bool((okbits[i >> 5] >> (i & 31)) & 1)
            with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
                for c in range(i >> 5, chunks):
                    j = 32 * c + np.arange(32)
                    lane_ok = (okbits[c] >> np.arange(32)) & 1 == 1
                    s = ok_i & (j > i) & lane_ok & _suppresses(box[i], area[i], box[j], area[j], thr)
                    rows[i, c] = _ballot(s)

        def word(i, w):
            return int(rows[i, 2 * w]) | int(rows[i, 2 * w + 1]) << 32

        removed = [0] * words
        kept = [0] * words
        for w in range(words):
            valid_w = vbits[2 * w] | vbits[2 * w + 1] << 32
            cand = valid_w & ~removed[w] & _MASK64
            while cand:
                low = cand & -cand
                i = 64 * w + low.bit_length() - 1
                for lane in range(w + 1, words):
                    removed[lane] |= word(i, lane)
                kept[w] |= low
                cand = (cand ^ low) & ~word(i, w)
        keep[img, :n] = [(kept[j >> 6] >> (j & 63)) & 1 for j in range(n)]
    return keep


def _emulation_cases():
    rng = np.random.default_rng(11)
    cases = []
    for k, ties in ((16, False), (100, True), (130, False), (256, True)):
        boxes = np.stack([_sorted(_random_dets(rng, k, ties))[1] for _ in range(2)])
        cases.append((f"random-k{k}-ties{ties}", boxes, np.ones((2, k), bool), 0.45))
    dets = np.array(
        [[100, 100, 210, 210, 0.72], [250, 250, 420, 420, 0.8], [220, 220, 320, 330, 0.92],
         [100, 100, 210, 210, 0.6]], np.float32,
    )
    cases.append(("golden", _sorted(dets)[1][None], np.ones((1, 4), bool), 0.4))
    chain = np.array([[i * 6.0, 0.0, i * 6.0 + 12.0, 12.0] for i in range(40)], np.float32)
    cases.append(("chain", chain[None], np.ones((1, 40), bool), 0.3))
    boxes = np.stack([_sorted(_random_dets(rng, 48, ties=True))[1] for _ in range(4)])
    valid = np.ones((4, 48), bool)
    valid[0] = False
    valid[1, 30:] = False
    valid[2, ::3] = False
    cases.append(("padding", boxes, valid, 0.45))
    boxes = np.stack([_sorted(_random_dets(rng, 32, ties=True))[1] for _ in range(2)])
    boxes[:, ::5, 2] = np.nan
    cases.append(("nan", boxes, np.ones((2, 32), bool), 0.45))
    for thr in (0.45, -0.1):  # inf - inf in a clamp: NaN, which never suppresses
        boxes = np.stack([_sorted(_random_dets(rng, 40, ties=True))[1] for _ in range(2)])
        boxes[:, ::7, 2] = np.inf
        boxes[:, 3::7, 0] = np.inf
        boxes[:, 1::9, 1] = -np.inf
        cases.append((f"inf-thr{thr}", boxes, np.ones((2, 40), bool), thr))
    for thr in (0.0, -0.1):
        boxes = np.stack([_sorted(_random_dets(rng, 70, ties=True))[1] for _ in range(2)])
        cases.append((f"thr{thr}", boxes, rng.uniform(size=(2, 70)) > 0.3, thr))
    # The last valid box at 63, 64 and 127: n ends a word, opens one, ends two.
    for last in (63, 64, 127):
        boxes = np.stack([_sorted(_random_dets(rng, 130, ties=True))[1] for _ in range(2)])
        valid = np.zeros((2, 130), bool)
        valid[0, : last + 1] = True  # a prefix
        valid[1, : last + 1] = rng.uniform(size=last + 1) > 0.3  # holes
        valid[1, last] = True
        cases.append((f"last{last}", boxes, valid, 0.45))
    return cases


@pytest.mark.parametrize("case", _emulation_cases(), ids=lambda c: c[0])
def test_kernel_emulation_is_bit_exact(case):
    """csrc/nms.cu's algorithm, step by step, equals nms_mask_plain and the
    JAX greedy scan bit for bit, whatever the words a row leaves unwritten
    hold."""
    _, boxes, valid, thr = case
    plain = nms_mask_plain(torch.from_numpy(boxes), torch.from_numpy(valid), thr).numpy()
    for seed in range(2):
        np.testing.assert_array_equal(_kernel_emulation(boxes, valid, thr, np.random.default_rng(seed)), plain)
    for i in range(boxes.shape[0]):
        greedy = np.asarray(nms_mask_greedy(jnp.asarray(boxes[i]), jnp.asarray(valid[i]), thr))
        np.testing.assert_array_equal(plain[i], greedy, err_msg=f"image {i}")
