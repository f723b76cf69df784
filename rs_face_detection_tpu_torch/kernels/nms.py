"""Wrapper of the CUDA greedy-NMS kernel (csrc/nms.cu).

Counterpart of the Pallas TPU kernel rs_face_detection_tpu/ops/nms_pallas.py
(``nms_mask_pallas``), batched over images.  Its plain PyTorch version is
``ops.nms.nms_mask_plain``; ``ops.nms.nms_mask`` picks between the two by the
tensor's device.  This wrapper only launches: it checks its inputs and raises
on anything the kernel does not take.
"""

from __future__ import annotations

import ctypes
import threading

import torch

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
    fn = lib.rsfd_nms_mask
    lib.rsfd_nms_max_k.restype = ctypes.c_int
    lib.rsfd_nms_max_k.argtypes = []
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # boxes
        ctypes.c_void_p,  # valid
        ctypes.c_void_p,  # keep
        ctypes.c_int,  # B
        ctypes.c_int,  # K
        ctypes.c_float,  # thr
        ctypes.c_void_p,  # stream
    ]


def _lib() -> ctypes.CDLL:
    return build.load("nms", _setup)


def nms_mask_cuda(
    boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Greedy-NMS keep mask (B, K) bool over score-sorted (B, K, 4) boxes.

    boxes: float32 CUDA tensor, contiguous; valid: (B, K) bool or uint8 on
    the same device (nonzero = valid).  Launches once for the whole batch on
    the current stream and does not synchronise.
    """
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_mask_cuda needs CUDA tensors, got {boxes.device}")
    if valid.device != boxes.device:
        raise ValueError(f"valid on {valid.device}, boxes on {boxes.device}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes.dtype}")
    if valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"valid must be bool or uint8, got {valid.dtype}")
    if boxes.dim() != 3 or boxes.shape[2] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    if tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError(
            f"valid {tuple(valid.shape)} does not match boxes {tuple(boxes.shape)}"
        )
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
    b, k = boxes.shape[0], boxes.shape[1]
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    lib = _lib()
    if k > lib.rsfd_nms_max_k():
        raise ValueError(f"K={k} exceeds the kernel's limit of {lib.rsfd_nms_max_k()}")
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = lib.rsfd_nms_mask(
            boxes.data_ptr(),
            valid.data_ptr(),
            keep.data_ptr(),
            b,
            k,
            float(iou_threshold),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"rsfd_nms_mask failed to launch: cudaError {err}")
    count_launch()
    return keep
