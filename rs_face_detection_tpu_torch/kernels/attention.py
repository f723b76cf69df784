"""Wrapper of the CUDA flash-attention forward kernel (csrc/attention.cu), K4.

Counterpart of the Pallas TPU flash attention behind
rs_face_detection_tpu/models/vit.py::_flash_attention_fn.  Its plain PyTorch
version is ``ops.attention.attention_plain``; ``ops.attention.attention``
picks between the two by the tensor's device.  This wrapper only launches: it
checks its inputs and raises on anything the kernel does not take.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

#: Kernel launches made by this process (the main path's proof of use).
launches = 0

#: Head dims the kernel is instantiated for.
HEAD_DIMS = (32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
            stream,
        )
    if err != 0:
        raise RuntimeError(f"rsfd_flash_attention failed to launch: cudaError {err}")
    launches += 1
    return out
