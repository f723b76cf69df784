"""Wrapper of the CUDA int8 dequant-matmul (csrc/int8_matmul.cu), K3.

Counterpart of the Pallas TPU kernel rs_face_detection_tpu/ops/quantize.py::
int8_matmul.  Its plain version is ``ops.quantize.int8_matmul_plain``;
``ops.quantize.int8_matmul`` picks between the two by the tensor's device.
This wrapper only launches: it checks its inputs and raises on anything the
kernel does not take.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Tuple

import torch

from ..ops.quantize import check_int8_operands
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

#: Rows per k-step (one mma), columns per CTA, rows per K chunk at most, x
#: rows per CTA at M > 1, CTAs per thread-block cluster at most, counter
#: slots and counters per slot (csrc/int8_matmul.cu's kStep, kBN, kMaxKC,
#: MT, kMaxCluster, kSlots and kSlotCounters).
KSTEP, BLOCK_N, MAX_CHUNK, BLOCK_M, CLUSTER = 16, 128, 1024, 8, 4
SLOTS, SLOT_COUNTERS = 32, 8192
#: Shared memory of a CTA: the ring of 8 q stages of 128 x 128 bytes, x's
#: chunk in f32, its bf16 parts as B fragments, the cluster's partial sums;
#: the H100's limit per block.
RING_BYTES, SMEM_LIMIT = 8 * 128 * 128, 232448


def launch_plan(m: int, k: int, n: int, sms: int, clusters: Tuple[int, int]) -> Tuple[int, int, int]:
    """(rows per K chunk, chunks, cluster size) of the kernel at (m, k, n) on
    a card of ``sms`` multiprocessors that holds ``clusters`` = (clusters of
    2, clusters of 4) CTAs at once (one CTA of 512 threads fills an SM).

    The output is cut into column tiles of 128 and row tiles of 8 (1 at
    m = 1); each tile's K axis into chunks of whole k-steps, as many as one
    wave of whole clusters holds, of at most MAX_CHUNK rows (the tensor
    cores' truncating chains stay short).  The cluster size, 2 or 4 (fewer
    with fewer chunks), is the one whose grid fits one wave, then the one
    with more chunks, 4 on a tie.  The chunk count is a multiple of the
    cluster size; at most cluster - 1 trailing chunks are empty."""
    block_m = 1 if m == 1 else BLOCK_M
    tiles = -(-n // BLOCK_N) * -(-m // block_m)
    steps = -(-k // KSTEP)
    least = -(-k // MAX_CHUNK)

    def chunks_for(cl: int, held: int) -> Tuple[bool, int, int]:
        fit = min(sms, held * cl) // tiles // cl * cl
        chunks = max(least, min(fit, steps), 1)
        cl = min(cl, 1 << (chunks.bit_length() - 1))
        down = chunks // cl * cl
        chunks = down if down >= least else down + cl
        one_wave = tiles * chunks <= sms and (cl == 1 or tiles * chunks // cl <= held)
        return one_wave, chunks, cl

    _, chunks, cl = max(chunks_for(2, clusters[0]), chunks_for(CLUSTER, clusters[1]))
    rows = KSTEP * -(-steps // chunks)
    chunks = -(-(-(-k // rows)) // cl) * cl
    return rows, chunks, cl


def smem_bytes(m: int, rows: int, compute: str) -> int:
    """Dynamic shared memory of a CTA at chunks of ``rows`` rows
    (csrc/int8_matmul.cu's smem_bytes)."""
    block_m = 1 if m == 1 else BLOCK_M
    b_tiles = 1 if m == 1 or compute == "bf16" else 3
    return RING_BYTES + block_m * (rows | 16) * 4 + (rows // KSTEP) * b_tiles * 256 + block_m * BLOCK_N * 4


def _setup(lib: ctypes.CDLL) -> None:
    fn = lib.rsfd_int8_matmul
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # x
        ctypes.c_void_p,  # q
        ctypes.c_void_p,  # scale
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # the clusters' partial tiles
        ctypes.c_int,  # M
        ctypes.c_int,  # K
        ctypes.c_int,  # N
        ctypes.c_int,  # rows per K chunk
        ctypes.c_int,  # chunks
        ctypes.c_int,  # cluster size
        ctypes.c_int,  # counter slot
        ctypes.c_int,  # bf16
        ctypes.c_void_p,  # stream
    ]
    lib.rsfd_int8_matmul_max_clusters.restype = ctypes.c_int
    lib.rsfd_int8_matmul_max_clusters.argtypes = [ctypes.c_int]


def _lib() -> ctypes.CDLL:
    return build.load("int8_matmul", _setup)


@functools.lru_cache(maxsize=None)
def _card(index: int) -> Tuple[int, Tuple[int, int]]:
    """(multiprocessors, (clusters of 2, clusters of 4) held at once) of a card."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    with torch.cuda.device(index):
        held = tuple(_lib().rsfd_int8_matmul_max_clusters(cl) for cl in (2, CLUSTER))
    if min(held) <= 0:
        raise RuntimeError(f"rsfd_int8_matmul_max_clusters failed: {held}")
    return sms, held


_slot_lock = threading.Lock()
_slots: Dict[Tuple[int, int], int] = {}


def _slot(index: int, stream: int) -> int:
    """The counter slot of a (device, stream): calls in flight on different
    streams never share counters; calls on one stream run in order.  A CUDA
    graph keeps the slot of the stream it was captured on, so graphs
    captured on one stream are replayed one at a time."""
    with _slot_lock:
        slot = _slots.get((index, stream))
        if slot is None:
            slot = sum(1 for dev, _ in _slots if dev == index)
            if slot >= SLOTS:
                raise RuntimeError(f"int8_matmul_cuda: more than {SLOTS} streams on cuda:{index}")
            _slots[index, stream] = slot
        return slot


def int8_matmul_cuda(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, compute: str = "f32"
) -> torch.Tensor:
    """x (M, K) @ (q (K, N) int8 * scale (N,) or (1, N)) -> f32 (M, N).

    x and scale: contiguous float32; q: contiguous int8; all on one CUDA
    device.  ``compute`` is "f32" or "bf16" (ops/quantize.py says what each
    rounds).  M = 0 or N = 0 returns an empty tensor without launching.
    Launches one kernel on the current stream and does not synchronise; safe
    under CUDA-graph capture.
    """
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
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    block_m = 1 if m == 1 else BLOCK_M
    tiles = -(-n // BLOCK_N) * -(-m // block_m)
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    rows, chunks, cl = launch_plan(m, k, n, *_card(index))
    groups = chunks // cl
    if m >= 2**31 // n or -(-m // block_m) > 65535 or (groups > 1 and tiles * cl > SLOT_COUNTERS):
        raise ValueError(f"(M, N) = ({m}, {n}) is too large for one launch")
    partial = torch.empty((groups, tiles, block_m * BLOCK_N) if groups > 1 else (0,), dtype=torch.float32,
                          device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rsfd_int8_matmul(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), partial.data_ptr(),
            m, k, n, rows, chunks, cl, _slot(index, stream), int(compute == "bf16"), stream,
        )
    if err != 0:
        raise RuntimeError(f"rsfd_int8_matmul failed to launch: cudaError {err}")
    count_launch()
    return out
