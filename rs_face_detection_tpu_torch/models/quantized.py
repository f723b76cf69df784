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

The calibrated int8-activation mode is the counterpart of
rs_face_detection_tpu/models/layers.py::Int8Conv inside ``ConvBN(quant=True)``:

  - ``Int8ActConv2d`` holds ``weight_q`` (O, I, kh, kw) int8 and
    ``weight_scale`` (O,) f32 (per-output-channel symmetric, as above) and a
    static per-tensor activation range ``amax`` () f32.  Serving quantizes
    its input against ``amax`` and runs the int8 x int8 -> int32 conv of
    ops/int8_conv.py (``torch._int_mm``; no float fallback on the card),
    then scales the accumulators by ``sx * weight_scale``.  While
    ``calibrating`` it records ``max |x|`` into ``amax`` (monotonically over
    batches) and runs the conv in f32 on the dequantized weights ``q * s``,
    as JAX's calibration forward does;
  - ``quantize_activations`` swaps, in place, every conv of a module that
    JAX's ``ConvBN(quant=True)`` swaps: the groups == 1 convs without a bias
    (ConvBN's).  Depthwise convs and the RetinaFace heads (1x1 convs with a
    bias) stay float.  For a RetinaFace that is 34 convs on the
    MobileNet-0.25 and 73 on the ResNet-50.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.int8_conv import activation_scale, int8_conv2d, quantize_activation, weight_matrix
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


class Int8ActConv2d(nn.Module):
    def __init__(self, conv: nn.Conv2d) -> None:
        super().__init__()
        if conv.groups != 1 or conv.bias is not None or conv.padding_mode != "zeros" or conv.dilation != (1, 1):
            raise ValueError("Int8ActConv2d takes an undilated groups == 1 conv with zero padding and no bias")
        self.stride = tuple(conv.stride)
        ph, pw = conv.padding
        self.padding = ((ph, ph), (pw, pw))
        q, s = quantize_array(conv.weight.detach().cpu().numpy(), axis=0)
        self.register_buffer("weight_q", torch.from_numpy(q))
        self.register_buffer("weight_scale", torch.from_numpy(s.reshape(-1)))
        self.register_buffer("amax", torch.zeros((), dtype=torch.float32))
        self.calibrating = False
        self._wmat_key = None

    def _weight_matrix(self) -> torch.Tensor:
        """weight_q as int8_conv2d's GEMM operand, rebuilt when weight_q is
        moved or loaded."""
        key = (self.weight_q.device, self.weight_q.data_ptr(), self.weight_q._version)
        if self._wmat_key != key:
            self._wmat, self._wmat_key = weight_matrix(self.weight_q), key
        return self._wmat

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (pt, pb), (pl, pr) = self.padding
        if self.calibrating:
            self.amax.copy_(torch.maximum(self.amax, x.detach().float().abs().max()))
            w = self.weight_q.float() * self.weight_scale[:, None, None, None]
            return F.conv2d(F.pad(x.float(), (pl, pr, pt, pb)), w, None, self.stride)
        acc = int8_conv2d(quantize_activation(x, self.amax), self.weight_q, self.stride, self.padding,
                          self._weight_matrix())
        # int32 times f32 promotes each accumulator to f32, then multiplies:
        # JAX's y.astype(f32) * (sx * ks), in one pass.
        return acc * (activation_scale(self.amax) * self.weight_scale)[:, None, None]


def quantize_activations(model: nn.Module) -> nn.Module:
    """Swap, in place, every groups == 1 Conv2d without a bias for an
    Int8ActConv2d (amax 0 until ``ops.quantize.calibrate``); returns the
    model."""
    for name, module in list(model.named_modules()):
        if type(module) is nn.Conv2d and module.groups == 1 and module.bias is None:
            parent_name, _, child = name.rpartition(".")
            parent = model.get_submodule(parent_name) if parent_name else model
            setattr(parent, child, Int8ActConv2d(module).to(module.weight.device))
    return model


def has_int8_activations(model: nn.Module) -> bool:
    return any(isinstance(m, Int8ActConv2d) for m in model.modules())
