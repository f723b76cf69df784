"""int8 x int8 -> int32 convolution as one int8 GEMM (``torch._int_mm``).

Counterpart of the integer conv inside rs_face_detection_tpu/models/
layers.py::Int8Conv (``jax.lax.conv_general_dilated`` on int8 operands with
``preferred_element_type=int32``), on NCHW int8 codes and OIHW int8 weights:

  - ``quantize_activation``: JAX's per-tensor activation quantizer, in its
    order of operations: ``sx = max(amax, 1e-8) / 127`` in f32, then
    ``clip(round(x / sx), -127, 127)`` (a division, not a multiply by
    ``127 / amax``; ``torch.round`` and ``jnp.round`` both round half to
    even), so equal inputs give equal codes.  Both divisors are tensors on
    x's device: a CUDA division by a CPU scalar multiplies by its f32
    reciprocal instead, which differs from the quotient in the last bit for
    about 5% of amax values (measured on the CPU), and moves the codes that
    sit at a rounding tie.  (Under ``jax.jit`` XLA folds the ``/ 127.0`` of
    the JAX source into that same reciprocal multiply; eager JAX divides.)
  - ``int8_conv2d``: the conv as ``A @ B`` with A the (M, K) patch matrix of
    the codes in channels-last order (M = B*Ho*Wo rows, K = kh*kw*C columns
    in (kh, kw, C) order) and B the (K, N) weight matrix.  A 1x1/s1 conv
    without padding is a plain matmul over a channels-last view of the
    codes; every other conv pads the int8 codes with zeros (explicit,
    possibly asymmetric padding) and gathers its patches by ``as_strided``.
    ``F.unfold`` has no int8 kernel and ``F.conv2d`` on int8 returns int8
    (it wraps), so neither is used.

``torch._int_mm`` is cuBLASLt's int8 GEMM on the card and an exact int32
matmul on the CPU, so the card's accumulators equal the CPU's bit for bit,
and the CPU's equal JAX's.  Its rules on the card (H100, torch 2.11 +
CUDA 12.8, read from its error messages):

  - M > 16 ("self.size(0) needs to be greater than 16");
  - K and N multiples of 8 ("... needs to be greater than 0 and a multiple
    of 8");
  - with B row-major, cuBLASLt refused M = 17 (CUBLAS_STATUS_NOT_SUPPORTED)
    and took 3-4x longer than B as the transpose of a row-major (N, K)
    matrix, which it takes at every M tried; so B is always that view.

The operands are padded to meet them: rows of zeros up to a multiple of 8
and at least 24, K and N to multiples of 8 (zero codes add nothing, so the
result stays exact); the padding is sliced off the result.
"""

from __future__ import annotations

from typing import Tuple

import torch

Padding = Tuple[Tuple[int, int], Tuple[int, int]]

#: torch._int_mm's alignment of K, N and (here) M on the card.
ALIGN = 8
#: The fewest rows the card's _int_mm takes (M > 16), rounded up to ALIGN.
MIN_ROWS = 24

#: torch._int_mm calls made on a CUDA tensor (the int8 convs' GEMMs).
int_mm_calls = 0


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def activation_scale(amax: torch.Tensor) -> torch.Tensor:
    """JAX's ``jnp.maximum(amax, 1e-8) / 127.0`` in f32, divided on amax's
    device by a tensor there."""
    amax = amax.float()
    return torch.clamp_min(amax, 1e-8) / torch.full((), 127.0, device=amax.device)


def quantize_activation(x: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric int8 codes of x against a calibrated amax."""
    return torch.round(x.float() / activation_scale(amax)).clamp_(-127, 127).to(torch.int8)


def weight_matrix(wq: torch.Tensor) -> torch.Tensor:
    """The (K, N) int8 weight operand of ``int8_conv2d`` from OIHW int8
    weights: the transpose of a row-major (N', K') matrix, rows (kh, kw, I),
    zero-padded to multiples of 8."""
    o, i, kh, kw = wq.shape
    k = kh * kw * i
    rows = wq.permute(0, 2, 3, 1).reshape(o, k)
    n_pad, k_pad = _round_up(o, ALIGN), _round_up(k, ALIGN)
    if (n_pad, k_pad) != (o, k):
        padded = rows.new_zeros((n_pad, k_pad))
        padded[:o, :k] = rows
        rows = padded
    return rows.contiguous().t()


def _patches(xq: torch.Tensor, kh: int, kw: int, stride, padding: Padding, k_cols: int):
    """(rows, k_cols) int8 patch matrix of NCHW codes, and (b, ho, wo)."""
    b, c, h, w = xq.shape
    (pt, pb), (pl, pr) = padding
    sh, sw = stride
    hp, wp = h + pt + pb, w + pl + pr
    ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    m, k = b * ho * wo, kh * kw * c
    rows = m if m % ALIGN == 0 and m >= MIN_ROWS else max(_round_up(m, ALIGN), MIN_ROWS)
    x = xq.permute(0, 2, 3, 1)  # NHWC: a view of channels-last codes
    if (kh, kw, sh, sw, pt, pb, pl, pr) == (1, 1, 1, 1, 0, 0, 0, 0) and (rows, k_cols) == (m, k):
        return x.reshape(m, k), (b, ho, wo)
    if pt or pb or pl or pr:
        xp = xq.new_zeros((b, hp, wp, c))
        xp[:, pt : pt + h, pl : pl + w] = x
    else:
        xp = x.contiguous()
    patches = xp.as_strided((b, ho, wo, kh, kw, c), (hp * wp * c, sh * wp * c, sw * c, wp * c, c, 1))
    if (rows, k_cols) == (m, k):
        return patches.reshape(m, k), (b, ho, wo)
    a = xq.new_zeros((rows, k_cols))
    a[:m].view(b, ho, wo, k_cols)[..., :k].unflatten(-1, (kh, kw, c)).copy_(patches)
    return a, (b, ho, wo)


def int8_conv2d(
    xq: torch.Tensor,
    wq: torch.Tensor,
    stride: Tuple[int, int] = (1, 1),
    padding: Padding = ((0, 0), (0, 0)),
    wmat: torch.Tensor | None = None,
) -> torch.Tensor:
    """int32 (B, O, Ho, Wo) conv of int8 NCHW codes with int8 OIHW weights.

    ``padding`` is ((top, bottom), (left, right)) of zero codes; ``wmat``
    is ``weight_matrix(wq)`` when the caller keeps it.  The result is a
    channels-last view of the GEMM's output.
    """
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8_conv2d takes int8 codes and weights, got {xq.dtype} and {wq.dtype}")
    o, i, kh, kw = wq.shape
    if xq.dim() != 4 or xq.shape[1] != i:
        raise ValueError(f"codes {tuple(xq.shape)} do not match weights {tuple(wq.shape)}")
    if wmat is None:
        wmat = weight_matrix(wq)
    a, (b, ho, wo) = _patches(xq, kh, kw, stride, padding, wmat.shape[0])
    if a.device.type == "cuda":
        global int_mm_calls
        int_mm_calls += 1
    elif a.device.type != "cpu":
        raise ValueError(f"int8_conv2d: unsupported device {a.device}")
    acc = torch._int_mm(a, wmat)
    return acc[: b * ho * wo, :o].view(b, ho, wo, o).permute(0, 3, 1, 2)
