"""The ResNet-50 stem in one pass over uint8 frames (K2) and its plain version.

Counterpart of rs_face_detection_tpu/ops/stem_pallas.py.  The stem of the
s2d ResNet-50 (models/resnet.py) is: normalize the uint8 BGR frame, a 4x4/s1
conv on its 2x2 space-to-depth layout with block-space pad (2, 1), eval
BatchNorm, ReLU, then a 3x3/s2 max-pool with pad 1.  ``fold_stem_params``
folds the BGR order, the pixel normalization and the BatchNorm into three
constant arrays, exactly as the JAX package does, and both versions below
take those:

  - ``fused_stem_plain``: plain PyTorch (s2d layout, normalize, conv2d,
    affine, ReLU, max_pool2d); the CPU path and the kernel's reference;
  - ``fused_stem``: the custom op ``rsfd::fused_stem``, one node in a traced
    or exported graph.  A CPU tensor takes the plain version; a CUDA tensor
    launches the CUDA kernel (kernels/stem.py) or raises; any other device
    raises.

Both read the letterboxed (B, H, W, 3) uint8 BGR canvas as it is (s2d
channel k = (bi*2 + bj)*3 + c is pixel (2i + bi, 2j + bj, c)) and return
(B, 64, ceil(H/4), ceil(W/4)) float32 NCHW, the layout the backbone takes.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .image import S2D_FLIP, s2d_layout

#: Output channels of the ResNet-50 stem.
STEM_CHANNELS = 64


def fold_stem_params(
    kernel_rgb: torch.Tensor,
    bn_scale: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    pixel_means: Sequence[float],
    pixel_stds: Sequence[float],
    pixel_scale: float,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold BGR order, normalization and BatchNorm into (w192, bn2, norm2).

    kernel_rgb: the (4, 4, 12, 64) HWIO s2d stem kernel, whose input
    channels expect RGB.  Returns float32 tensors on its device: im2col
    weights (192, 64) with rows (dy*4 + dx)*12 + k and k in the frame's BGR
    s2d order; the BatchNorm affine (2, 64) as (scale, shift); per-channel
    (mean, scale) (2, 12) in BGR s2d order, with pixel_scale folded into
    the scale.  Same values as ops/stem_pallas.py::fold_stem_params.
    """
    if tuple(kernel_rgb.shape[:3]) != (4, 4, 12):
        raise ValueError(f"stem kernel must be (4, 4, 12, C), got {tuple(kernel_rgb.shape)}")
    w = kernel_rgb.float()[:, :, list(S2D_FLIP), :]
    w192 = w.reshape(192, w.shape[-1]).contiguous()
    a = bn_scale.float() / torch.sqrt(bn_var.float() + eps)
    bn2 = torch.stack([a, bn_bias.float() - bn_mean.float() * a]).contiguous()
    mean3 = np.asarray(pixel_means, np.float32) * pixel_scale
    scale3 = (1.0 / np.asarray(pixel_stds, np.float32)) / pixel_scale
    norm2 = np.stack([np.tile(mean3[::-1], 4), np.tile(scale3[::-1], 4)]).astype(np.float32)
    return w192, bn2, torch.from_numpy(norm2).to(kernel_rgb.device)


def stem_output_hw(h: int, w: int) -> Tuple[int, int]:
    """Pooled (rows, cols) of the stem on an (h, w) frame: the 3x3/s2 pad-1
    pool over the (h/2, w/2) conv grid."""
    return (h // 2 - 1) // 2 + 1, (w // 2 - 1) // 2 + 1


def fused_stem_plain(
    imgs_u8: torch.Tensor, w192: torch.Tensor, bn2: torch.Tensor, norm2: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch K2: (B, H, W, 3) uint8 BGR -> (B, 64, H/4, W/4) f32.

    The frame's s2d layout (ops/image.py::s2d_layout) normalized as
    ``(float(px) - mean) * scale`` with norm2, then conv2d 12->64, 4x4,
    stride 1, pad (2, 1) on each axis (zeros in the normalized frame) with
    w192 as its weights, ``* scale + shift``, ReLU and max_pool2d(3, 2, 1).
    H and W must be even.  The folded constants keep the frame's BGR order,
    so no channel is reordered: the conv input is ops/image.py::
    s2d_stem_input's, value for value, in BGR instead of RGB order.
    """
    x = (s2d_layout(imgs_u8).float() - norm2[0]) * norm2[1]
    weight = w192.reshape(4, 4, 12, -1).permute(3, 2, 0, 1)  # OIHW
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (2, 1, 2, 1)), weight)
    y = torch.relu(y * bn2[0][:, None, None] + bn2[1][:, None, None])
    return F.max_pool2d(y, 3, 2, 1)


@torch.library.custom_op("rsfd::fused_stem", mutates_args=(), device_types="cpu")
def fused_stem_op(
    imgs_u8: torch.Tensor, w192: torch.Tensor, bn2: torch.Tensor, norm2: torch.Tensor
) -> torch.Tensor:
    """The custom op ``rsfd::fused_stem``: the plain version on the CPU, in
    the kernel's contiguous NCHW layout (the plain conv's output keeps the
    channels-last strides of the s2d frame)."""
    return fused_stem_plain(imgs_u8, w192, bn2, norm2).contiguous()


@fused_stem_op.register_kernel("cuda")
def _fused_stem_cuda(
    imgs_u8: torch.Tensor, w192: torch.Tensor, bn2: torch.Tensor, norm2: torch.Tensor
) -> torch.Tensor:
    from ..kernels.stem import fused_stem_cuda

    return fused_stem_cuda(imgs_u8, w192, bn2, norm2)


@fused_stem_op.register_fake
def _fused_stem_fake(
    imgs_u8: torch.Tensor, w192: torch.Tensor, bn2: torch.Tensor, norm2: torch.Tensor
) -> torch.Tensor:
    b, h, w = imgs_u8.shape[:3]
    return imgs_u8.new_empty((b, STEM_CHANNELS, *stem_output_hw(h, w)), dtype=torch.float32)


def fused_stem(
    imgs_u8: torch.Tensor, w192: torch.Tensor, bn2: torch.Tensor, norm2: torch.Tensor
) -> torch.Tensor:
    """K2 on a CUDA tensor, the plain version on a CPU tensor."""
    if imgs_u8.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_stem: unsupported device {imgs_u8.device}")
    return fused_stem_op(imgs_u8, w192, bn2, norm2)
