"""K2, the fused stem of the ResNet-50 (csrc/stem.cu, ``fused_stem_kernel``).

The stem is normalize, a 4x4 stride-1 conv of 12 to 64 channels on the 2x2
space-to-depth frame (192 multiply-adds per output), BatchNorm, ReLU and a
3x3 stride-2 max-pool.  Operations: the algorithm's, 2 per multiply-add of
the conv, B * (H/2) * (W/2) * 64 * 192 * 2 (20.1 GFLOP at (8, 640, 640)),
whatever the kernel does to compute them (its two TF32 products per
multiply-add are 40.3 GFLOP); the pointwise work is left out.  Bytes: the
uint8 frames read once and the pooled float32 output written once.  The
peak is the TF32 rate: no float32 multiplication on the card is faster.
"""

from . import TF32_FLOPS, share

MACS_PER_OUTPUT = 192
CHANNELS = 64


def launch_flops(frame_shape) -> int:
    b, h, w = frame_shape[0], frame_shape[1], frame_shape[2]
    return 2 * b * (h // 2) * (w // 2) * CHANNELS * MACS_PER_OUTPUT


def launch_bytes(frame_shape, out_shape) -> int:
    n_in = 1
    for d in frame_shape:
        n_in *= d
    n_out = 4
    for d in out_shape:
        n_out *= d
    return n_in + n_out


def roofline(launches, kernel_seconds: float, kernel_launches: int):
    """The share over the traced launches, or None where K2 did not run."""
    if not launches or kernel_seconds <= 0 or kernel_launches <= 0:
        return None
    n_bytes = sum(launch_bytes(f, o) for f, o in launches) / len(launches)
    n_flops = sum(launch_flops(f) for f, _ in launches) / len(launches)
    return share(n_bytes * kernel_launches, n_flops * kernel_launches, TF32_FLOPS, kernel_seconds)
