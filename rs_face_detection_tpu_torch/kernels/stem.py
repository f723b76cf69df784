"""Wrapper of the CUDA fused ResNet-50 stem kernel (csrc/stem.cu), K2.

Counterpart of the Pallas TPU kernel rs_face_detection_tpu/ops/stem_pallas.py
(``fused_stem_s2d``), on the letterboxed (B, H, W, 3) uint8 canvas instead of
a host-side s2d copy.  Its plain PyTorch version is
``ops.stem.fused_stem_plain``; ``ops.stem.fused_stem`` picks between the two
by the tensor's device.  This wrapper only launches: it checks its inputs and
raises on anything the kernel does not take.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..ops.stem import STEM_CHANNELS, stem_output_hw
from . import build

#: Kernel launches made by this process (the main path's proof of use),
#: bumped under _launch_lock: serving threads launch concurrently.
launches = 0
_launch_lock = threading.Lock()


def count_launch() -> None:
    """Add one to ``launches``: called where the kernel launched, and nowhere else."""
    global launches
    with _launch_lock:
        launches += 1


def _setup(lib: ctypes.CDLL) -> None:
    fn = lib.rsfd_fused_stem
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # canvas
        ctypes.c_void_p,  # w192
        ctypes.c_void_p,  # bn2
        ctypes.c_void_p,  # norm2
        ctypes.c_void_p,  # out
        ctypes.c_int,  # B
        ctypes.c_int,  # H
        ctypes.c_int,  # W
        ctypes.c_void_p,  # stream
    ]


def _lib() -> ctypes.CDLL:
    return build.load("stem", _setup)


def _check_const(name: str, t: torch.Tensor, shape, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, canvas on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_stem_cuda(
    canvas: torch.Tensor, w192: torch.Tensor, bn2: torch.Tensor, norm2: torch.Tensor
) -> torch.Tensor:
    """(B, H, W, 3) uint8 BGR -> (B, 64, ceil(H/4), ceil(W/4)) float32 NCHW.

    canvas: a contiguous uint8 CUDA tensor with even H and W; the folded
    constants of ops.stem.fold_stem_params on the same device.  Launches once
    for the whole batch on the current stream and does not synchronise.
    """
    if canvas.device.type != "cuda":
        raise ValueError(f"fused_stem_cuda needs CUDA tensors, got {canvas.device}")
    if canvas.dtype != torch.uint8:
        raise TypeError(f"canvas must be uint8, got {canvas.dtype}")
    if canvas.dim() != 4 or canvas.shape[3] != 3:
        raise ValueError(f"canvas must be (B, H, W, 3), got {tuple(canvas.shape)}")
    b, h, w = canvas.shape[0], canvas.shape[1], canvas.shape[2]
    if h % 2 or w % 2 or h < 2 or w < 2:
        raise ValueError(f"canvas H and W must be even and >= 2, got {h}x{w}")
    if not canvas.is_contiguous():
        raise ValueError("canvas must be contiguous")
    _check_const("w192", w192, (192, STEM_CHANNELS), canvas.device)
    _check_const("bn2", bn2, (2, STEM_CHANNELS), canvas.device)
    _check_const("norm2", norm2, (2, 12), canvas.device)
    hp, wp = stem_output_hw(h, w)
    out = torch.empty((b, STEM_CHANNELS, hp, wp), dtype=torch.float32, device=canvas.device)
    if b == 0:
        return out
    lib = _lib()
    with torch.cuda.device(canvas.device):
        stream = torch.cuda.current_stream(canvas.device).cuda_stream
        err = lib.rsfd_fused_stem(
            canvas.data_ptr(),
            w192.data_ptr(),
            bn2.data_ptr(),
            norm2.data_ptr(),
            out.data_ptr(),
            b,
            h,
            w,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"rsfd_fused_stem failed to launch: cudaError {err}")
    count_launch()
    return out
