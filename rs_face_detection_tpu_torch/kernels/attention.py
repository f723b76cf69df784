"""Wrapper of the CUDA flash-attention forward kernel (csrc/attention.cu), K4.

Counterpart of the Pallas TPU flash attention behind
rs_face_detection_tpu/models/vit.py::_flash_attention_fn.  Its plain PyTorch
version is ``ops.attention.attention_plain``; ``ops.attention.attention``
picks between the two by the tensor's device.  This wrapper only launches: it
checks its inputs and raises on anything the kernel does not take.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build

#: Kernel launches made by this process (the main path's proof of use).
launches = 0

#: Head dims the kernel is instantiated for.
HEAD_DIMS = (32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: bf16 path: query rows per fragment (one warp's share of a round), keys
#: per cp.async stage, stages and warps per CTA at most, and the shared
#: memory a CTA may ask for (csrc/attention.cu's 16, kStageKeys,
#: kMaxStages, kMaxWarps; the H100's 227 KB).
FRAG_ROWS, STAGE_KEYS, MAX_STAGES, MAX_WARPS = 16, 64, 8, 8
SMEM_LIMIT = 232448


@functools.lru_cache(maxsize=256)
def launch_plan(b: int, n: int, h: int, sms: int) -> Tuple[int, int, int]:
    """(splits, warps, stages) of the bf16 kernel at (b, n, h) on ``sms``
    multiprocessors.

    A head's F = ceil(n / 16) query fragments are split evenly over
    ``splits`` CTAs (CTA s takes [s * F // splits, (s + 1) * F // splits)) so
    that the b * h heads give about two CTAs per SM (two fit by shared
    memory up to 320 keys at D = 64), but no CTA takes fewer than two
    fragments, since each reads the head's whole K and V: the tower's b8
    gives 128 heads of 2 CTAs, a verify's b1 16 heads of 8.  ``warps`` is
    the fewest warps that walk a CTA's largest share in the fewest rounds of
    at most 8 warps, each warp one fragment a round.  ``stages`` is the
    number of 64-key K/V stages kept in shared memory: the whole head up to
    8 stages (512 keys), else a ring of 8 that streams.
    """
    frags = -(-n // FRAG_ROWS)
    splits = max(1, min(frags // 2, 2 * sms // (b * h)))
    per = -(-frags // splits)
    rounds = -(-per // MAX_WARPS)
    warps = -(-per // rounds)
    stages = min(-(-n // STAGE_KEYS), MAX_STAGES)
    return splits, warps, stages


def smem_bytes(d: int, stages: int) -> int:
    """Dynamic shared memory of the bf16 kernel: K and V stages of 64 rows
    padded by 8 elements."""
    return 2 * stages * STAGE_KEYS * (d + 8) * 2


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib() -> ctypes.CDLL:
    lib = build.load("attention")
    fn = lib.rsfd_flash_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # q
            ctypes.c_void_p,  # k
            ctypes.c_void_p,  # v
            ctypes.c_void_p,  # o
            ctypes.c_int,  # B
            ctypes.c_int,  # N
            ctypes.c_int,  # H
            ctypes.c_int,  # D
            ctypes.c_int,  # dtype
            *([ctypes.c_longlong] * 9),  # q, k, v strides of B, N, H
            ctypes.c_int,  # splits
            ctypes.c_int,  # warps
            ctypes.c_int,  # stages
            ctypes.c_void_p,  # stream
        ]
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v on (B, N, H, D) CUDA tensors.

    q, k and v: one shape, one dtype (bfloat16 or float32), one device; D of
    32 or 64 with unit stride; any strides over B, N and H as long as every
    row starts 16-byte aligned (the slices of a packed qkv projection do).
    Returns a contiguous (B, N, H, D) tensor in the inputs' dtype.  Launches
    once on the current stream and does not synchronise.
    """
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"mixed dtypes: q {q.dtype}, {name} {t.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, q is {tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q, k, v must be (B, N, H, D), got {tuple(q.shape)}")
    b, n, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim must be one of {HEAD_DIMS}, got {d}")
    align = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have unit stride over D, got {t.stride()}")
        if t.data_ptr() % 16 or any(s % align for s in t.stride()[:3]):
            raise ValueError(f"{name} rows must start 16-byte aligned (strides {t.stride()})")
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    splits, warps, stages = launch_plan(b, n, h, _sm_count(q.device.index))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rsfd_flash_attention(
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            out.data_ptr(),
            b,
            n,
            h,
            d,
            _DTYPES[q.dtype],
            *q.stride()[:3],
            *k.stride()[:3],
            *v.stride()[:3],
            splits,
            warps,
            stages,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"rsfd_flash_attention failed to launch: cudaError {err}")
    launches += 1
    return out
