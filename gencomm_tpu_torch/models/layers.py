"""Shared building blocks, NHWC at every ``forward``.

Counterpart of ``gencomm_tpu/models/layers.py``. The base layers (``Conv``,
``ConvTranspose``, ``Dense``, ``BatchNorm``, ``GroupNorm``, ``LayerNorm``)
keep PyTorch's parameter layouts; ``weights.py`` carries flax parameters
into them. Convolutions run as ``F.conv2d`` on a channels-last view, so the
NHWC <-> NCHW permutes move no data. Normalization statistics follow flax:
Var = E[x^2] - E[x]^2, clipped at 0, and y = (x - mean) * (rsqrt(var + eps)
* scale) + bias. ``BatchNorm`` takes batch statistics under ``train()``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _same_pads(n: int, k: int, s: int):
    """flax "SAME" padding (lo, hi) of one spatial axis."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """2D convolution on NHWC; weight (O, I/groups, kh, kw).

    padding: "SAME" (flax: (0, 1) for stride 2 on an even axis), "VALID",
    or an int p for a symmetric (p, p) pad (torch's ``padding=p``).
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding="SAME", bias: bool = True, groups: int = 1):
        super().__init__()
        self.kernel, self.stride, self.padding, self.groups = (
            kernel, stride, padding, groups)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups,
                                               kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x):
        xc = x.permute(0, 3, 1, 2)
        if self.padding == "VALID":
            pads = ((0, 0), (0, 0))
        elif self.padding == "SAME":
            pads = (_same_pads(x.shape[1], self.kernel, self.stride),
                    _same_pads(x.shape[2], self.kernel, self.stride))
        else:
            pads = ((self.padding,) * 2,) * 2
        (ht, hb), (wl, wr) = pads
        if ht == hb and wl == wr:
            y = F.conv2d(xc, self.weight, self.bias, self.stride, (ht, wl),
                         groups=self.groups)
        else:
            y = F.conv2d(F.pad(xc, (wl, wr, ht, hb)), self.weight, self.bias,
                         self.stride, 0, groups=self.groups)
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.Module):
    """Transposed convolution with kernel == stride ("VALID", no overlap)
    on NHWC; weight (I, O, k, k), no bias."""

    def __init__(self, in_ch: int, out_ch: int, stride: int):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, stride, stride))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight,
                               stride=self.stride)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Linear):
    """flax ``nn.Dense``: a Linear over the last axis."""


def _fast_stats(x, dims, keepdim=True):
    mean = x.mean(dim=dims, keepdim=keepdim)
    var = ((x * x).mean(dim=dims, keepdim=keepdim) - mean * mean).clamp_min(0.0)
    return mean, var


def update_running_stats(norm: nn.Module, mean, var,
                         momentum: float = 0.99) -> None:
    """flax's running averages: running = momentum * running + (1 -
    momentum) * batch, with the biased batch variance. Outside autograd."""
    with torch.no_grad():
        norm.running_mean.mul_(momentum).add_((1.0 - momentum) * mean)
        norm.running_var.mul_(momentum).add_((1.0 - momentum) * var)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis (momentum 0.99, eps 1e-3).
    At eval it reads the running statistics. In training it normalizes by
    the batch's: the mean and the biased fast variance E[x^2] - E[x]^2,
    clipped at 0 (flax ``use_fast_variance``), which also update the
    running statistics (``update_running_stats``). Built in eval mode, as
    flax modules default to ``train=False``; a parent's ``train()`` switches
    it."""

    def __init__(self, num_features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.eval()

    def forward(self, x):
        if self.training:
            mean, var = _fast_stats(x, tuple(range(x.dim() - 1)),
                                    keepdim=False)
            update_running_stats(self, mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class GroupNorm(nn.Module):
    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        n, h, w, c = x.shape
        g = self.num_groups
        xg = x.reshape(n, h * w, g, c // g)
        mean, var = _fast_stats(xg, (1, 3))
        mul = torch.rsqrt(var + self.eps)
        y = ((xg - mean) * mul).reshape(n, h, w, c)
        return y * self.weight + self.bias


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis (eps 1e-6)."""

    def __init__(self, num_features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        mean, var = _fast_stats(x, (-1,))
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class ConvBNReLU(nn.Module):
    """Conv (no bias) + BN(eps 1e-3) + ReLU. ``torch_pad`` pads (1, 1) as
    torch's ``padding=k//2`` does, instead of flax "SAME"."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, torch_pad: bool = False):
        super().__init__()
        self.Conv_0 = Conv(in_ch, features, kernel, stride,
                           padding=(kernel - 1) // 2 if torch_pad else "SAME",
                           bias=False)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x):
        return torch.relu(self.BatchNorm_0(self.Conv_0(x)))


class DeconvBNReLU(nn.Module):
    """ConvTranspose (k == stride) + BN + ReLU."""

    def __init__(self, in_ch: int, features: int, stride: int = 2):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(in_ch, features, stride)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x):
        return torch.relu(self.BatchNorm_0(self.ConvTranspose_0(x)))


class DoubleConv(nn.Module):
    """Two convs with ReLU, both flax "SAME" padded."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv(in_ch, features, kernel, stride)
        self.Conv_1 = Conv(features, features, 3)

    def forward(self, x):
        return torch.relu(self.Conv_1(torch.relu(self.Conv_0(x))))


class DownsampleConv(nn.Module):
    """Shrink header: a stack of DoubleConvs."""

    def __init__(self, in_ch: int, dims: Sequence[int], kernels: Sequence[int],
                 strides: Sequence[int]):
        super().__init__()
        for i, (k, d, s) in enumerate(zip(kernels, dims, strides)):
            self.add_module(f"DoubleConv_{i}", DoubleConv(in_ch, d, k, s))
            in_ch = d

    def forward(self, x):
        for m in self.children():
            x = m(x)
        return x
