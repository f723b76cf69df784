"""Wrapper of the CUDA int8 dequant-matmul (csrc/int8_matmul.cu), K3.

Counterpart of the Pallas TPU kernel rs_face_detection_tpu/ops/quantize.py::
int8_matmul.  Its plain version is ``ops.quantize.int8_matmul_plain``;
``ops.quantize.int8_matmul`` picks between the two by the tensor's device.
This wrapper only launches: it checks its inputs and raises on anything the
kernel does not take.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..ops.quantize import check_int8_operands
from . import build

#: Kernel launches made by this process (the main path's proof of use).
launches = 0

#: Rows of q per step of a CTA, columns per CTA, rows per K chunk at most,
#: and x rows per CTA (csrc/int8_matmul.cu's kRows, kBN, kMaxKC and MT).
ROWS, BLOCK_N, MAX_CHUNK, BLOCK_M = 32, 128, 1024, 8


def _lib() -> ctypes.CDLL:
    lib = build.load("int8_matmul")
    fn = lib.rsfd_int8_matmul
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # x
            ctypes.c_void_p,  # q
            ctypes.c_void_p,  # scale
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # partial sums of the K chunks
            ctypes.c_int,  # M
            ctypes.c_int,  # K
            ctypes.c_int,  # N
            ctypes.c_int,  # rows per K chunk
            ctypes.c_int,  # bf16
            ctypes.c_int,  # 16-byte loads
            ctypes.c_void_p,  # stream
        ]
    return lib


def split_plan(m: int, k: int, n: int, sms: int) -> Tuple[int, int]:
    """(rows per K chunk, number of chunks): about one CTA for each of the
    card's ``sms`` multiprocessors -- at about 200 registers a thread one CTA
    of 256 threads fills an SM, so a second wave would only add a tail -- a
    chunk a multiple of 32 rows and at most 1024 (x's tile in shared
    memory)."""
    block_m = 1 if m == 1 else BLOCK_M
    tiles = -(-n // BLOCK_N) * -(-m // block_m)
    chunks = max(-(-sms // tiles), -(-k // MAX_CHUNK))
    chunks = min(chunks, -(-k // ROWS))
    rows = -(-(-(-k // chunks)) // ROWS) * ROWS
    return rows, -(-k // rows)


def int8_matmul_cuda(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, compute: str = "f32"
) -> torch.Tensor:
    """x (M, K) @ (q (K, N) int8 * scale (N,) or (1, N)) -> f32 (M, N).

    x and scale: contiguous float32; q: contiguous int8; all on one CUDA
    device.  ``compute`` is "f32" or "bf16" (ops/quantize.py says what each
    rounds).  M = 0 or N = 0 returns an empty tensor without launching.
    Launches on the current stream and does not synchronise.
    """
    global launches
    n = check_int8_operands(x, q, scale, compute)
    m, k = x.shape
    for name, t in (("x", x), ("q", q), ("scale", scale)):
        if t.device.type != "cuda":
            raise ValueError(f"int8_matmul_cuda needs CUDA tensors, got {name} on {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides {t.stride()}")
    if x.dtype != torch.float32 or scale.dtype != torch.float32:
        raise TypeError(f"x and scale must be float32, got {x.dtype} and {scale.dtype}")
    if k == 0:
        raise ValueError("int8_matmul_cuda needs K >= 1")
    if m >= 2**31 // max(n, 1) or -(-m // BLOCK_M) > 65535:
        raise ValueError(f"M = {m} is too large for one launch")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    rows, chunks = split_plan(m, k, n, sms)
    partial = torch.empty((chunks, m, n) if chunks > 1 else (0,), dtype=torch.float32, device=x.device)
    vec = n % 16 == 0 and q.data_ptr() % 16 == 0
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rsfd_int8_matmul(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), partial.data_ptr(),
            m, k, n, rows, int(compute == "bf16"), int(vec), stream,
        )
    if err != 0:
        raise RuntimeError(f"rsfd_int8_matmul failed to launch: cudaError {err}")
    launches += 1
    return out
