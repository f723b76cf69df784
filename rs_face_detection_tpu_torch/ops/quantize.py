"""Weight-only int8 quantization and the int8 dequant-matmul (K3).

Counterpart of the weight-only half of rs_face_detection_tpu/ops/quantize.py
(``quantize_array``, ``dequantize_array``, ``quantize_tree``'s selection rule,
``quantized_bytes``) and of its Pallas kernel ``int8_matmul``:

  - ``quantize_array``: symmetric per-output-channel int8, a numpy copy of
    JAX's bit for bit (``np.round`` rounds half to even, a clip to +-127, a
    zero scale replaced by 1.0).  JAX's output channel is flax's last axis;
    a torch weight keeps it on axis 0, so ``axis`` says which.  The scale is
    the absmax over every other axis, so q and s come out the same values in
    either layout;
  - ``dequantize_array``: ``q * scale`` in the compute dtype;
  - ``should_quantize``: quantize_tree's rule, a float leaf with ``ndim >= 2``
    and ``size >= min_size`` (4096, inclusive);
  - ``int8_matmul_plain``: K3's plain version, ``x (M, K) @ (q (K, N) int8 *
    scale (N,))`` -> f32 (M, N), in one of two arithmetics:
      ``compute="f32"``: ``x @ (q.float() * s)`` in f32, the arithmetic of
      JAX's quantized FaceExtraction (``dequantize_tree`` in f32, then a
      flax Dense in f32);
      ``compute="bf16"``: the Pallas kernel's rounding chain: x rounded to
      bf16, the weight ``bf16(q) * bf16(s)`` rounded to bf16, the products
      (exact in f32) summed in f32;
  - ``int8_matmul``: the custom op ``rsfd::int8_matmul``, one node in a
    traced or exported graph.  A CPU tensor takes the plain version; a CUDA
    tensor launches the CUDA kernel (kernels/int8_matmul.py) or raises; any
    other device raises.

And of its full int8 inference (``calibrate``, ``quantize_retinaface``): a
float RetinaFace becomes a copy whose ConvBN convs run int8 activations
(models/quantized.py::Int8ActConv2d), calibrated on model-input batches.
``quantize_model_variables`` has no counterpart: the swap quantizes each
conv's weights where it stands.
"""

from __future__ import annotations

import copy
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

#: quantize_tree's default: smaller leaves (biases, norms, slopes) stay float.
MIN_SIZE = 4096
COMPUTE_MODES = ("f32", "bf16")


def quantize_array(w, axis: int = -1) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 quantization per output channel ``axis``.

    Returns (int8 values of w's shape, float32 scales of w's shape with every
    axis but ``axis`` of size 1) such that ``w ~= q * scale``.
    """
    w = np.asarray(w, dtype=np.float32)
    axis = axis % w.ndim
    absmax = np.max(np.abs(w), axis=tuple(a for a in range(w.ndim) if a != axis), keepdims=True)
    scale = (absmax / 127.0).astype(np.float32)
    scale = np.where(scale == 0.0, 1.0, scale)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_array(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """q * scale, in the requested compute dtype: ``q.to(dtype) *
    scale.to(dtype)`` in one elementwise pass (int8 times a float promotes
    to the float, and int8 widens to it exactly)."""
    return q * scale.to(dtype)


def should_quantize(w: torch.Tensor, min_size: int = MIN_SIZE) -> bool:
    """quantize_tree's rule: a float leaf with ndim >= 2 and size >= min_size."""
    return w.dtype in (torch.float32, torch.float16) and w.dim() >= 2 and w.numel() >= min_size


def quantized_bytes(model: nn.Module) -> int:
    """Total bytes of a module's state (parameters and buffers), int8
    leaves at one byte each."""
    return sum(t.numel() * t.element_size() for t in model.state_dict().values())


def check_int8_operands(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, compute: str) -> int:
    """Validate K3's operands; returns N."""
    if compute not in COMPUTE_MODES:
        raise ValueError(f"compute must be one of {COMPUTE_MODES}, got {compute!r}")
    if x.dim() != 2 or q.dim() != 2:
        raise ValueError(f"x must be (M, K) and q (K, N), got {tuple(x.shape)} and {tuple(q.shape)}")
    if q.dtype != torch.int8:
        raise TypeError(f"q must be int8, got {q.dtype}")
    if not x.is_floating_point():
        raise TypeError(f"x must be a float tensor, got {x.dtype}")
    k, n = q.shape
    if x.shape[1] != k:
        raise ValueError(f"x is {tuple(x.shape)} but q is {tuple(q.shape)}")
    if scale.numel() != n or scale.dim() > 2 or (scale.dim() == 2 and scale.shape[0] != 1):
        raise ValueError(f"scale must be (N,) or (1, N) with N = {n}, got {tuple(scale.shape)}")
    return n


def int8_matmul_plain(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, compute: str = "f32"
) -> torch.Tensor:
    """Plain K3: x (M, K) float, q (K, N) int8, scale (N,) or (1, N) -> f32 (M, N)."""
    n = check_int8_operands(x, q, scale, compute)
    s = scale.reshape(1, n)
    if compute == "bf16":
        xb = x.to(torch.bfloat16).float()
        w = (q.to(torch.bfloat16) * s.to(torch.bfloat16)).float()
        return xb @ w
    return x.float() @ (q.float() * s.float())


@torch.library.custom_op("rsfd::int8_matmul", mutates_args=(), device_types="cpu")
def int8_matmul_op(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, compute: str) -> torch.Tensor:
    """The custom op ``rsfd::int8_matmul``: the plain version on the CPU."""
    return int8_matmul_plain(x, q, scale, compute)


@int8_matmul_op.register_kernel("cuda")
def _int8_matmul_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, compute: str) -> torch.Tensor:
    from ..kernels.int8_matmul import int8_matmul_cuda

    return int8_matmul_cuda(x, q, scale, compute)


@int8_matmul_op.register_fake
def _int8_matmul_fake(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, compute: str) -> torch.Tensor:
    n = check_int8_operands(x, q, scale, compute)
    return x.new_empty((x.shape[0], n), dtype=torch.float32)


def int8_matmul(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, compute: str = "f32"
) -> torch.Tensor:
    """K3 on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    return int8_matmul_op(x, q, scale, compute)


def calibrate(qmodel: nn.Module, batches: Iterable[torch.Tensor]) -> nn.Module:
    """Record every int8-activation conv's ``amax`` over model-input batches
    ((B, 3, H, W) float, moved to the model's device): each conv records
    ``max |x|`` of its input, monotonically across batches, and runs in f32
    on its dequantized weights meanwhile.  Returns the model."""
    from ..models.quantized import Int8ActConv2d

    convs = [m for m in qmodel.modules() if isinstance(m, Int8ActConv2d)]
    device = next(qmodel.parameters()).device
    try:
        for conv in convs:
            conv.calibrating = True
        with torch.no_grad():
            for batch in batches:
                qmodel(torch.as_tensor(batch).to(device))
    finally:
        for conv in convs:
            conv.calibrating = False
    return qmodel


def default_calibration_batches(
    image_size: Sequence[int], n_calib: int = 2, calib_batch_size: int = 2, seed: int = 0
) -> list:
    """JAX's default calibration input, transposed to NCHW: ``n_calib``
    batches of uint8-range pixels ``default_rng(seed).integers(0, 256,
    (calib_batch_size, H, W, 3))`` as float32, used as model input."""
    width, height = image_size
    rng = np.random.default_rng(seed)
    return [
        torch.from_numpy(
            rng.integers(0, 256, (calib_batch_size, height, width, 3)).astype(np.float32)
        ).permute(0, 3, 1, 2)
        for _ in range(n_calib)
    ]


def quantize_retinaface(
    model: nn.Module,
    image_size: Sequence[int],
    calib_batches: Optional[Iterable[torch.Tensor]] = None,
    n_calib: int = 2,
    calib_batch_size: int = 2,
    seed: int = 0,
    device="cuda",
) -> nn.Module:
    """A float RetinaFace -> a calibrated int8-activation copy on ``device``
    (the card unless the caller asks for the CPU); ``model`` is left as it
    is.  ``image_size`` is (width, height); ``calib_batches`` are (B, 3, H,
    W) model inputs (normalized images), by default JAX's random pixels
    (``default_calibration_batches``): fine for throughput work, while
    accuracy-sensitive serving passes representative images."""
    from ..models.quantized import quantize_activations
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    qmodel = quantize_activations(copy.deepcopy(model).eval()).to(dev)
    if calib_batches is None:
        calib_batches = default_calibration_batches(image_size, n_calib, calib_batch_size, seed)
    return calibrate(qmodel, calib_batches)
