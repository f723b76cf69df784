"""Weight-only int8 layers, and the conversion of a float module to them.

Counterpart of the weight-only tree of rs_face_detection_tpu/ops/quantize.py
(``quantize_tree`` at rest, ``dequantize_tree`` per call), module by module:

  - ``Int8Conv2d`` holds an int8 ``weight_q`` (O, I/g, kh, kw) and a
    per-output-channel f32 ``weight_scale`` (O,), dequantizes them on every
    call (``dequantize_array``, as JAX's XLA does inside the jit graph) and
    runs ``F.conv2d``: the weights stay int8 at rest, no f32 copy is kept;
  - ``Int8Linear`` holds ``weight_q`` as (in, out) int8 -- flax's Dense
    layout, the (K, N) operand of K3 -- its f32 ``weight_scale`` (out,) and a
    float bias, and runs ``ops.quantize.int8_matmul`` (K3 on the card) in f32
    arithmetic, then adds the bias;
  - ``quantize_module`` swaps every Conv2d and Linear whose weight meets
    quantize_tree's rule (``ops.quantize.should_quantize``) for its int8 form.

The int8 values and scales equal JAX's ``quantize_tree`` leaf for leaf after
the layout maps of models/weights.py (tests/test_torch_quantize.py).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.quantize import MIN_SIZE, dequantize_array, int8_matmul, quantize_array, should_quantize


class Int8Conv2d(nn.Module):
    def __init__(self, conv: nn.Conv2d) -> None:
        super().__init__()
        if conv.padding_mode != "zeros":
            raise ValueError(f"Int8Conv2d takes zero padding, got {conv.padding_mode!r}")
        self.stride, self.padding = conv.stride, conv.padding
        self.dilation, self.groups = conv.dilation, conv.groups
        q, s = quantize_array(conv.weight.detach().cpu().numpy(), axis=0)
        self.register_buffer("weight_q", torch.from_numpy(q))
        self.register_buffer("weight_scale", torch.from_numpy(s.reshape(-1)))
        self.bias = None if conv.bias is None else nn.Parameter(conv.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = dequantize_array(self.weight_q, self.weight_scale[:, None, None, None], x.dtype)
        return F.conv2d(x, w, self.bias, self.stride, self.padding, self.dilation, self.groups)


class Int8Linear(nn.Module):
    def __init__(self, linear: nn.Linear) -> None:
        super().__init__()
        q, s = quantize_array(linear.weight.detach().cpu().numpy(), axis=0)
        self.register_buffer("weight_q", torch.from_numpy(np.ascontiguousarray(q.T)))
        self.register_buffer("weight_scale", torch.from_numpy(s.reshape(-1)))
        self.bias = None if linear.bias is None else nn.Parameter(linear.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        y = int8_matmul(x.reshape(-1, x.shape[-1]).contiguous(), self.weight_q, self.weight_scale, "f32")
        if self.bias is not None:
            y = y + self.bias
        return y.reshape(*lead, y.shape[-1])


def quantize_module(model: nn.Module, min_size: int = MIN_SIZE) -> nn.Module:
    """Swap, in place, every Conv2d and Linear whose weight meets
    quantize_tree's rule for Int8Conv2d / Int8Linear; returns the model."""
    for name, module in list(model.named_modules()):
        if isinstance(module, (nn.Conv2d, nn.Linear)) and should_quantize(module.weight, min_size):
            parent_name, _, child = name.rpartition(".")
            parent = model.get_submodule(parent_name) if parent_name else model
            int8 = Int8Conv2d(module) if isinstance(module, nn.Conv2d) else Int8Linear(module)
            setattr(parent, child, int8.to(module.weight.device))
    return model


def is_quantized(model: nn.Module) -> bool:
    return any(isinstance(m, (Int8Conv2d, Int8Linear)) for m in model.modules())
