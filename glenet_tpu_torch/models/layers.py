"""Shared NN building blocks (torch counterpart of
glenet_tpu/models/layers.py).

Tensors carry padding (fixed voxel budgets), so `MaskedBatchNorm` takes its
moments over valid rows only.  Attribute names of the modules follow the
JAX package's variable names (e.g. `MaskedBatchNorm_0`, `Conv_0`), so the
weight bridge (utils/jax_weights.py) maps variables by path.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import distributed as dp

BN_EPS = 1e-3
BN_MOMENTUM = 0.01  # new = (1 - m) * old + m * batch

# When True every MaskedBatchNorm normalizes with its RUNNING stats even in
# train mode (and does not update them).
BN_FORCE_RUNNING_STATS = False


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the channels at `channel_dim` with an optional validity
    mask: moments are taken over every other axis, counting only rows where
    `mask` (x's shape without the channel axis) is True; outputs at masked-off
    rows are zero."""

    def __init__(self, features: int, eps: float = BN_EPS,
                 channel_dim: int = -1):
        super().__init__()
        self.eps = eps
        self.channel_dim = channel_dim
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))

    def _bcast(self, t, ndim):
        shape = [1] * ndim
        shape[self.channel_dim] = -1
        return t.reshape(shape)

    @staticmethod
    def moment_sums(x32, mask, cdim):
        """(sum, sum of squares, count) over every axis but `cdim`,
        counting the rows where `mask` is True (a Python count without
        one)."""
        axes = [d for d in range(x32.dim()) if d != cdim]
        if mask is None:
            return (x32.sum(axes), (x32 * x32).sum(axes),
                    x32.numel() / x32.shape[cdim])
        m = mask.float().unsqueeze(cdim)
        return (x32 * m).sum(axes), (x32 * x32 * m).sum(axes), m.sum()

    def forward(self, x, mask=None, use_running_average: bool = True):
        cdim = self.channel_dim % x.dim()
        if use_running_average or BN_FORCE_RUNNING_STATS:
            mean, var = self.running_mean, self.running_var
        else:
            # in the data-parallel train step the moments are those of the
            # global batch: sums over the data group, with their gradient
            total, total_sq, cnt = self.moment_sums(x.float(), mask, cdim)
            if mask is None:
                # a Python count: a tensor made from it would be a host
                # sync per call; every rank holds as many rows
                cnt = max(cnt * dp.data_rows()[1], 1.0)
                total, total_sq = dp.sum_moments(total, total_sq)
            else:
                total, total_sq, cnt = dp.sum_moments(total, total_sq, cnt)
                cnt = cnt.clamp_min(1.0)
            mean = total / cnt
            var = (total_sq / cnt - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.mul_(1 - BN_MOMENTUM).add_(
                    BN_MOMENTUM * mean)
                self.running_var.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var)
        nd = x.dim()
        y = (x - self._bcast(mean, nd)) * self._bcast(
            torch.rsqrt(var + self.eps), nd)
        y = y * self._bcast(self.weight, nd) + self._bcast(self.bias, nd)
        if mask is not None:
            y = torch.where(mask.unsqueeze(cdim), y, 0.0)
        return y.to(x.dtype)


class ConvBlock(nn.Module):
    """Conv2D (no bias) + BN (+ ReLU) on NCHW tensors (the JAX block is
    NHWC; callers here keep the BEV maps channels-first and expose NHWC
    views).

    `transpose` is the stride == kernel deconvolution of the BEV backbones
    (flax ConvTranspose, 'SAME'); the weight bridge flips its kernel into
    torch's ConvTranspose2d layout.  With `output_padding` set it is torch's
    ConvTranspose2d(k, s, padding, output_padding) (SSFA's k3 s2 p1 op1),
    whose weight sits on the block itself, as JAX's `kernel` leaf does.
    `use_relu=False` leaves the ReLU out."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, transpose: bool = False,
                 output_padding: int | None = None, use_relu: bool = True):
        super().__init__()
        self.transpose = transpose
        self.output_padding = output_padding if transpose else None
        if self.output_padding is not None:
            self.weight = nn.Parameter(torch.empty(in_ch, features,
                                                   kernel_size, kernel_size))
            nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
            self.stride, self.padding = stride, padding
        elif transpose:
            self.ConvTranspose_0 = nn.ConvTranspose2d(
                in_ch, features, kernel_size, stride, bias=False)
        else:
            self.Conv_0 = nn.Conv2d(in_ch, features, kernel_size, stride,
                                    padding, bias=False)
        self.use_relu = use_relu
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features, channel_dim=1)

    def forward(self, x, train: bool = False):
        if self.output_padding is not None:
            x = F.conv_transpose2d(x, self.weight, stride=self.stride,
                                   padding=self.padding,
                                   output_padding=self.output_padding)
        elif self.transpose:
            x = self.ConvTranspose_0(x)
        else:
            x = self.Conv_0(x)
        x = self.MaskedBatchNorm_0(x, use_running_average=not train)
        return F.relu(x) if self.use_relu else x


class MLP(nn.Module):
    """Dense layers (no bias with BN) each followed by a MaskedBatchNorm over
    the last axis, with the optional validity `mask` (x's shape without the
    feature axis), and a ReLU, except after the last layer unless
    final_activation.  Children are named Dense_<i> / MaskedBatchNorm_<i>,
    as in the JAX module."""

    def __init__(self, in_features: int, features, use_bn: bool = True,
                 final_activation: bool = True):
        super().__init__()
        self.n, self.use_bn = len(features), use_bn
        self.final_activation = final_activation
        for i, f in enumerate(features):
            setattr(self, f'Dense_{i}', nn.Linear(in_features, f,
                                                  bias=not use_bn))
            if use_bn:
                setattr(self, f'MaskedBatchNorm_{i}', MaskedBatchNorm(f))
            in_features = f

    def forward(self, x, mask=None, train: bool = False):
        for i in range(self.n):
            x = getattr(self, f'Dense_{i}')(x)
            if self.use_bn:
                x = getattr(self, f'MaskedBatchNorm_{i}')(
                    x, mask=mask, use_running_average=not train)
            if i < self.n - 1 or self.final_activation:
                x = F.relu(x)
        return x
