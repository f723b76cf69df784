"""Dense attention softmax(QK^T / sqrt(D)) V (K4) and its plain version.

Counterpart of the attention of rs_face_detection_tpu/models/vit.py: flax's
``nn.dot_product_attention`` and, with ``fused_attention=True``, the Pallas
TPU flash-attention kernel behind ``_flash_attention_fn``.  Both functions
take q, k and v as (B, N, H, D) in the JAX package's layout -- views with
any strides, such as the three slices of a packed (B, N, 3, H, D) qkv
projection -- and return a contiguous (B, N, H, D) tensor in the inputs'
dtype:

  - ``attention_plain``: plain PyTorch, scores in f32, the softmax in f32,
    then PV in f32; the CPU path and the kernel's reference;
  - ``attention``: the custom op ``rsfd::attention``, one node in a traced
    or exported graph.  A CPU tensor takes the plain version; a CUDA tensor
    launches the CUDA kernel (kernels/attention.py) or raises; any other
    device raises.

No mask and no dropout: the ViT's attention is dense and inference-only.
"""

from __future__ import annotations

import math

import torch


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain K4: (B, N, H, D) q, k, v -> (B, N, H, D) in q's dtype.

    The scores ``q . k`` are taken in f32 and scaled by 1/sqrt(D) there, the
    softmax runs in f32, and PV in f32; only the result is rounded to the
    inputs' dtype.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype).contiguous()


@torch.library.custom_op("rsfd::attention", mutates_args=(), device_types="cpu")
def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The custom op ``rsfd::attention``: the plain version on the CPU."""
    return attention_plain(q, k, v)


@attention_op.register_kernel("cuda")
def _attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    from ..kernels.attention import flash_attention_cuda

    return flash_attention_cuda(q, k, v)


@attention_op.register_fake
def _attention_fake(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return q.new_empty(q.shape)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K4 on a CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention: unsupported device {q.device}")
    return attention_op(q, k, v)
