"""Operation and byte counts of the kernels, and the model-FLOP counter.

Peaks of one NVIDIA H100 SXM (the data sheet's dense rates at 700 W): HBM
3.35 TB/s, TF32 tensor cores 495 TFLOP/s (the fastest rate at which the card
multiplies float32 inputs), float32 outside the tensor cores 67 TFLOP/s.
A roofline share is the least time the card could take, the larger of the
bytes over the memory rate and the operations over their peak, divided by
the kernel's measured device time.
"""

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12


def share(n_bytes: float, n_flops: float, flops_peak: float, seconds: float) -> float:
    """The roofline share in percent of a kernel that took ``seconds``."""
    return 100.0 * max(n_bytes / HBM_BYTES_PER_S, n_flops / flops_peak) / seconds
