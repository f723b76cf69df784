"""Vision Transformer of the eKYC anti-spoofing heads, with K4 attention.

Counterpart of rs_face_detection_tpu/models/vit.py (``ViT`` and every config
of ``_CONFIGS``): patchify conv, CLS token and position embedding, ``ln_pre``
for the CLIP configs, pre-LN transformer blocks (LayerNorm epsilon 1e-5),
exact-erf GELU for ``vit_*`` and QuickGELU for ``clip_*``, then
``ln_post`` on the CLS row, the bias-free ``proj`` where the config has one,
the classifier ``head`` and a softmax.

Attention is a packed qkv projection, the three (B, N, H, D) slices of its
output passed as they are to ``ops.attention.attention`` (K4 on the card,
its plain version on the CPU), and an output projection.  Module and
parameter names are OpenAI CLIP's visual tower without the ``visual.``
prefix (``conv1``, ``class_embedding``, ``positional_embedding``,
``transformer.resblocks.{i}.attn.in_proj_weight``, ``mlp.c_fc``,
``ln_post``, ``proj``), so a public CLIP state_dict loads without a remap.

Precision follows the JAX registry's serving policy (bf16 compute over
bf16-cast kernels, models/precision.py): ``cast_for_serving`` puts every
weight in bf16 but the LayerNorms, whose parameters and math stay f32.  The
module then runs in the dtype of its projections: the residual stream is
bf16, the LayerNorm outputs are cast back to it, and the tail after
``ln_post`` runs in f32 on whatever the weights hold.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import attention

LN_EPS = 1e-5


class ViTConfig(NamedTuple):
    patch: int
    width: int
    depth: int
    heads: int
    pre_ln: bool = False  # ln_pre after cls + pos embedding
    quick_gelu: bool = False  # x * sigmoid(1.702 x) instead of exact GELU
    proj_dim: int = 0  # embedding projection after ln_post (0 = none)


#: Copy of the JAX package's ``models/vit.py::_CONFIGS``.
CONFIGS = {
    "vit_tiny_test": ViTConfig(16, 64, 2, 2),
    "vit_b16": ViTConfig(16, 768, 12, 12),
    "vit_l14": ViTConfig(14, 1024, 24, 16),
    "clip_tiny_test": ViTConfig(16, 64, 2, 2, pre_ln=True, quick_gelu=True, proj_dim=32),
    "clip_b16": ViTConfig(16, 768, 12, 12, pre_ln=True, quick_gelu=True, proj_dim=512),
    "clip_l14": ViTConfig(14, 1024, 24, 16, pre_ln=True, quick_gelu=True, proj_dim=768),
}


class Attention(nn.Module):
    """Packed qkv projection, K4, output projection (CLIP's key names).

    ``heads`` is the number of heads this module computes: under tensor
    parallelism (parallel/tp.py) the rank's share, with ``in_proj_*``
    holding those heads' rows of each of q, k and v and ``out_proj`` their
    columns, so the widths follow the weights, not the residual stream."""

    def __init__(self, width: int, heads: int) -> None:
        super().__init__()
        if width % heads:
            raise ValueError(f"width {width} does not split into {heads} heads")
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        # Output features are [q | k | v], each (heads, head_dim) head-major.
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias).view(b, n, 3, self.heads, -1)
        o = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return self.out_proj(o.view(b, n, -1))


class MLP(nn.Module):
    def __init__(self, width: int, quick_gelu: bool) -> None:
        super().__init__()
        self.quick_gelu = quick_gelu
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.c_fc(x)
        y = y * torch.sigmoid(1.702 * y) if self.quick_gelu else F.gelu(y)
        return self.c_proj(y)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block; the LayerNorms run in f32, the rest in the stream's dtype."""

    def __init__(self, width: int, heads: int, quick_gelu: bool) -> None:
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = Attention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = MLP(width, quick_gelu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x.float()).to(x.dtype))
        return x + self.mlp(self.ln_2(x.float()).to(x.dtype))


class Transformer(nn.Module):
    def __init__(self, cfg: ViTConfig) -> None:
        super().__init__()
        self.resblocks = nn.Sequential(
            *(ResidualAttentionBlock(cfg.width, cfg.heads, cfg.quick_gelu) for _ in range(cfg.depth))
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resblocks(x)


class ViT(nn.Module):
    """Patchify -> CLS + pos embed [-> ln_pre] -> transformer -> head.

    Input (B, 3, S, S) normalized RGB with S = ``image_size``; output
    (B, num_classes) probabilities in f32 (logits without ``softmax``).
    """

    def __init__(
        self, config: str = "clip_l14", num_classes: int = 2, image_size: int = 224, softmax: bool = True
    ) -> None:
        super().__init__()
        cfg = CONFIGS[config]
        self.config, self.softmax = config, softmax
        if image_size % cfg.patch:
            raise ValueError(f"image size {image_size} is not a multiple of patch {cfg.patch}")
        width = cfg.width
        tokens = (image_size // cfg.patch) ** 2 + 1
        self.conv1 = nn.Conv2d(3, width, cfg.patch, cfg.patch, bias=not cfg.pre_ln)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(tokens, width))
        self.ln_pre = nn.LayerNorm(width, eps=LN_EPS) if cfg.pre_ln else None
        self.transformer = Transformer(cfg)
        self.ln_post = nn.LayerNorm(width, eps=LN_EPS)
        self.proj = nn.Parameter(torch.empty(width, cfg.proj_dim)) if cfg.proj_dim else None
        self.head = nn.Linear(cfg.proj_dim or width, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.conv1.weight.dtype
        x = self.conv1(x.to(dt))  # (B, W, S/P, S/P)
        b, w = x.shape[0], x.shape[1]
        x = x.flatten(2).transpose(1, 2)  # (B, N, W), patches row-major
        cls = self.class_embedding.to(dt).expand(b, 1, w)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        if self.ln_pre is not None:
            x = self.ln_pre(x.float()).to(dt)
        x = self.transformer(x)
        x = self.ln_post(x[:, 0].float())
        if self.proj is not None:
            x = x @ self.proj.float()
        logits = F.linear(x, self.head.weight.float(), self.head.bias.float())
        return torch.softmax(logits, dim=-1) if self.softmax else logits


def cast_for_serving(model: ViT) -> ViT:
    """Cast every parameter but the LayerNorms' to bf16, in place: the JAX
    registry's ``clone(dtype=bf16)`` plus ``cast_kernels``."""
    model.to(torch.bfloat16)
    for module in model.modules():
        if isinstance(module, nn.LayerNorm):
            module.float()
    return model
