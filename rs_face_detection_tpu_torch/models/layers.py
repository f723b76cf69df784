"""Shared building blocks: conv-bn-act, depthwise-separable block, FPN, SSH.

Counterpart of rs_face_detection_tpu/models/layers.py in NCHW, with the
biubug6 RetinaFace key layout (``Sequential(Conv, BN, act)``), so a public
``mobilenet0.25_Final.pth`` state_dict loads as it is.  Padding is the torch
symmetric k//2 the flax code already uses (``torch_padding``), and every
BatchNorm keeps the flax definition's epsilon of 1e-5.

For training (parallel/train.py) the BatchNorm follows flax's ``nn.BatchNorm``
(momentum 0.9), and ``remat`` runs a block under ``torch.utils.checkpoint``,
the counterpart of flax's ``nn.remat``.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5

_recompute = threading.local()


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same keys, same eval forward) whose running
    statistics follow flax's: in training the batch is normalized with its
    biased statistics and the buffers take ``0.9 * old + 0.1 * batch`` with
    the *biased* variance, computed as flax does, E[x^2] - E[x]^2 clipped at 0
    (``nn.BatchNorm2d`` would take the unbiased one, n/(n-1) larger).  The
    buffers are not updated while ``remat`` recomputes a block, as flax's
    ``nn.remat`` updates them once.

    ``stats_group`` (``sync_batch_stats``): the process group of the ranks
    that hold the other rows of the batch (the mesh's "data" axis).  With a
    group of more than one rank, training takes the statistics of the global
    batch, as JAX's one-program train step does over a batch sharded on
    "data": a sum, a sum of squares and a count, summed over the group by
    an all-reduce, then flax's mean, biased variance and normalization, with
    a backward that sums over the group too (``_GlobalBatchNorm``).
    ``nn.SyncBatchNorm`` would update ``running_var`` with the unbiased
    variance."""

    stats_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.stats_group is not None and dist.get_world_size(self.stats_group) > 1:
            return self._global_forward(x)
        if not getattr(_recompute, "active", False):
            with torch.no_grad():
                xf = x.float()
                mean = xf.mean(dim=(0, 2, 3))
                var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_(min=0.0)
                keep = 1.0 - self.momentum
                self.running_mean.copy_(self.running_mean * keep + mean * self.momentum)
                self.running_var.copy_(self.running_var * keep + var * self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps, self.stats_group)
        if not getattr(_recompute, "active", False):
            with torch.no_grad():
                keep = 1.0 - self.momentum
                self.running_mean.copy_(self.running_mean * keep + mean * self.momentum)
                self.running_var.copy_(self.running_var * keep + var * self.momentum)
        return y


class _GlobalBatchNorm(torch.autograd.Function):
    """Training BatchNorm over the rows of every rank of ``group``: flax's
    statistics of the global batch (mean, and the biased variance E[x^2] -
    E[x]^2 clipped at 0) from one all-reduce of each rank's per-channel sum,
    sum of squares and count.  The backward is the analytic one, as
    F.batch_norm's (the centered form, with one all-reduce of the sums of
    dy and dy * xhat): autograd through E[x^2] - E[x]^2 would cancel most
    digits of the gradient where raw pixels make a channel's mean large.
    The weight and bias gradients are this rank's share; the data-parallel
    average over the ranks completes them.  Returns (y, mean, var)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        xf = x.float()
        stats = torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)), xf.new_full((1,), x.numel() // c)])
        dist.all_reduce(stats, group=group)
        count = stats[2 * c]
        mean = stats[:c] / count
        var = (stats[c : 2 * c] / count - mean * mean).clamp(min=0.0)
        invstd = torch.rsqrt(var + eps)
        xhat = (xf - mean[None, :, None, None]) * invstd[None, :, None, None]
        y = xhat * weight[None, :, None, None] + bias[None, :, None, None]
        ctx.save_for_backward(xhat, invstd, weight, count)
        ctx.group, ctx.dtype = group, x.dtype
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, invstd, weight, count = ctx.saved_tensors
        c = xhat.shape[1]
        g = dy.float()
        local = torch.cat([g.sum(dim=(0, 2, 3)), (g * xhat).sum(dim=(0, 2, 3))])
        d_bias, d_weight = local[:c].clone(), local[c:].clone()
        dist.all_reduce(local, group=ctx.group)
        mean_dy, mean_dy_xhat = local[:c] / count, local[c:] / count
        dx = (g - mean_dy[None, :, None, None] - xhat * mean_dy_xhat[None, :, None, None]) * (
            invstd * weight)[None, :, None, None]
        return dx.to(ctx.dtype), d_weight.to(weight.dtype), d_bias.to(weight.dtype), None, None


def sync_batch_stats(module: nn.Module, group) -> None:
    """Set the process group over which every BatchNorm2d of ``module``
    takes its training statistics (None: each rank's own rows)."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.stats_group = group


@contextlib.contextmanager
def _recomputing():
    _recompute.active = True
    try:
        yield
    finally:
        _recompute.active = False


def remat(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)`` with its activations recomputed on the backward pass
    instead of saved (flax ``nn.remat``), when the module trains with
    gradients on; a plain call otherwise."""
    if not (block.training and torch.is_grad_enabled()):
        return block(x)
    return checkpoint(
        block, x, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _recomputing()),
    )


def conv_bn(
    inp: int,
    oup: int,
    kernel: int = 3,
    stride: int = 1,
    groups: int = 1,
    negative_slope: float | None = 0.0,
) -> nn.Sequential:
    """Conv (no bias, padding k//2) + BN + optional leaky ReLU.

    negative_slope None means no activation; 0.0 is a plain ReLU."""
    layers = [
        nn.Conv2d(inp, oup, kernel, stride, kernel // 2, groups=groups, bias=False),
        BatchNorm2d(oup, eps=BN_EPS),
    ]
    if negative_slope is not None:
        layers.append(nn.LeakyReLU(negative_slope))
    return nn.Sequential(*layers)


def conv_dw(inp: int, oup: int, stride: int, negative_slope: float = 0.1) -> nn.Sequential:
    """MobileNetV1 depthwise-separable block: dw 3x3 + BN + act, pw 1x1 + BN
    + act, flat in one Sequential (biubug6 ``conv_dw`` keys .0/.1/.3/.4)."""
    return nn.Sequential(
        *conv_bn(inp, inp, 3, stride, groups=inp, negative_slope=negative_slope),
        *conv_bn(inp, oup, 1, 1, negative_slope=negative_slope),
    )


def upsample_nearest_2x(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest 2x upsample cropped to `size` (H, W): the flax FPN's
    repeat-then-crop (layers.py::_upsample_nearest_2x)."""
    up = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return up[:, :, : size[0], : size[1]]


class FPN(nn.Module):
    """3-level feature pyramid: lateral 1x1 + top-down upsample + merge 3x3."""

    def __init__(self, in_channels, out_channels: int, negative_slope: float) -> None:
        super().__init__()
        self.output1 = conv_bn(in_channels[0], out_channels, 1, negative_slope=negative_slope)
        self.output2 = conv_bn(in_channels[1], out_channels, 1, negative_slope=negative_slope)
        self.output3 = conv_bn(in_channels[2], out_channels, 1, negative_slope=negative_slope)
        self.merge1 = conv_bn(out_channels, out_channels, 3, negative_slope=negative_slope)
        self.merge2 = conv_bn(out_channels, out_channels, 3, negative_slope=negative_slope)

    def forward(self, feats):
        """[C3, C4, C5] (strides 8, 16, 32) -> [P3, P4, P5]."""
        o1 = self.output1(feats[0])
        o2 = self.output2(feats[1])
        o3 = self.output3(feats[2])
        o2 = self.merge2(o2 + upsample_nearest_2x(o3, o2.shape[2:]))
        o1 = self.merge1(o1 + upsample_nearest_2x(o2, o1.shape[2:]))
        return [o1, o2, o3]


class SSH(nn.Module):
    """SSH context module: 3x3 / 5x5 / 7x7 receptive-field branches (the
    larger two as stacked 3x3 convs), concatenated, then ReLU."""

    def __init__(self, in_channels: int, out_channels: int, negative_slope: float) -> None:
        super().__init__()
        if out_channels % 4:
            raise ValueError(f"SSH out_channels must divide by 4, got {out_channels}")
        half, quarter = out_channels // 2, out_channels // 4
        self.conv3X3 = conv_bn(in_channels, half, negative_slope=None)
        self.conv5X5_1 = conv_bn(in_channels, quarter, negative_slope=negative_slope)
        self.conv5X5_2 = conv_bn(quarter, quarter, negative_slope=None)
        self.conv7X7_2 = conv_bn(quarter, quarter, negative_slope=negative_slope)
        self.conv7x7_3 = conv_bn(quarter, quarter, negative_slope=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c5_1 = self.conv5X5_1(x)
        out = torch.cat(
            [self.conv3X3(x), self.conv5X5_2(c5_1), self.conv7x7_3(self.conv7X7_2(c5_1))],
            dim=1,
        )
        return F.relu(out)
