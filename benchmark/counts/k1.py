"""K1, greedy NMS over score-sorted candidates (csrc/nms.cu, ``nms_mask_kernel``).

Bytes: the (B, K, 4) float32 boxes and the (B, K) valid mask read once, the
(B, K) keep mask written once (the count of the repository's chip smoke).
Operations: what greedy NMS needs on these inputs, about 15 float32
operations per IoU of a kept box against each later valid box; they run
outside the tensor cores, so their peak is the float32 rate.
"""

import torch

from . import F32_FLOPS, share

FLOPS_PER_IOU = 15


def launch_bytes(shape) -> int:
    b, k = shape[0], shape[1]
    return b * k * 4 * 4 + 2 * b * k


def launch_flops(valid: torch.Tensor, keep: torch.Tensor) -> int:
    """Operations of one launch: each kept box against the valid boxes after it."""
    v = valid.int()
    later_valid = torch.flip(torch.cumsum(torch.flip(v, [1]), 1), [1]) - v
    return FLOPS_PER_IOU * int((later_valid * keep.int()).sum())


def roofline(launches, kernel_seconds: float, kernel_launches: int):
    """The share over the traced launches, or None where K1 did not run.

    ``launches``: (boxes shape, valid, keep) per recorded call; the bound of
    the mean recorded launch is scaled to the launches the trace timed."""
    if not launches or kernel_seconds <= 0 or kernel_launches <= 0:
        return None
    n_bytes = sum(launch_bytes(s) for s, _, _ in launches) / len(launches)
    n_flops = sum(launch_flops(v, k) for _, v, k in launches) / len(launches)
    return share(n_bytes * kernel_launches, n_flops * kernel_launches, F32_FLOPS, kernel_seconds)
