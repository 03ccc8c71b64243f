"""Shared building blocks, NHWC at every ``forward``.

Counterpart of ``gencomm_tpu/models/layers.py``. The base layers (``Conv``,
``ConvTranspose``, ``Dense``, ``BatchNorm``, ``GroupNorm``, ``LayerNorm``)
keep PyTorch's parameter layouts; ``weights.py`` carries flax parameters
into them. Convolutions run as ``F.conv2d`` on a channels-last view, so the
NHWC <-> NCHW permutes move no data. Normalization statistics follow flax:
Var = E[x^2] - E[x]^2, clipped at 0, and y = (x - mean) * (rsqrt(var + eps)
* scale) + bias. ``BatchNorm`` takes batch statistics under ``train()``.

``dtype`` follows flax's ``dtype`` attribute (parameters stay fp32):
``torch.bfloat16`` casts the input and the parameters to bf16 and returns
bf16; ``None`` computes in the promoted type of input and parameters, so a
bf16 input into an fp32 layer gives fp32, as flax's ``promote_dtype`` does
(PyTorch's ``F.conv2d`` would refuse the mix). A bf16 convolution or
product is rounded to bf16 before its bias is added in bf16, as flax adds
it; in fp32 the bias stays inside PyTorch's call. Normalization statistics
and the normalization itself run in fp32 whatever the input; the result is
cast to ``dtype`` where one is given, else it stays fp32.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _compute_dtype(x: torch.Tensor, weight: torch.Tensor, dtype):
    """The type a layer computes in: ``dtype``, else input and weight
    promoted (flax ``promote_dtype``)."""
    return dtype if dtype is not None else torch.promote_types(x.dtype,
                                                               weight.dtype)


def _cast(t, dt):
    return None if t is None else t.to(dt)


def _split_bias(bias, dt):
    """(bias inside PyTorch's call, bias added after it): in bf16 flax rounds
    the product before ``y += bias``; in fp32 the bias stays inside."""
    return (bias, None) if dt == torch.float32 else (None, bias)


def as_dtype(v: float, dtype) -> float:
    """A Python constant as JAX applies it to an array of ``dtype``: a
    weakly typed scalar is rounded to the array's type first (bf16), where
    PyTorch would multiply by the fp32 value."""
    return float(torch.tensor(v, dtype=dtype)) if dtype is not None else v


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``. On bf16 it is evaluated as XLA expands it,
    1 / (1 + exp(-x)) with every step rounded to bf16 (one fused fp32
    sigmoid rounded once differs in a third of the values)."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """flax's ``nn.softmax``. On bf16 it follows ``jax.nn.softmax``'s
    composition, exp(x - max) / sum, each operation rounded to bf16 (the
    fused softmax rounded once differs in most values)."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu`` (tanh approximation). On bf16 it follows
    ``jax.nn.gelu``'s composition, each operation rounded to bf16."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    c0, c1 = (as_dtype(v, x.dtype) for v in (_SQRT_2_OVER_PI, 0.044715))
    return x * (0.5 * (1.0 + torch.tanh(c0 * (x + c1 * (x * x * x)))))


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
                 padding="SAME", bias: bool = True, groups: int = 1,
                 dtype=None):
        super().__init__()
        self.kernel, self.stride, self.padding, self.groups = (
            kernel, stride, padding, groups)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups,
                                               kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x):
        dt = _compute_dtype(x, self.weight, self.dtype)
        xc = x.to(dt).permute(0, 3, 1, 2)
        inner, after = _split_bias(_cast(self.bias, dt), dt)
        weight = self.weight.to(dt)
        if self.padding == "VALID":
            pads = ((0, 0), (0, 0))
        elif self.padding == "SAME":
            pads = (_same_pads(x.shape[1], self.kernel, self.stride),
                    _same_pads(x.shape[2], self.kernel, self.stride))
        else:
            pads = ((self.padding,) * 2,) * 2
        (ht, hb), (wl, wr) = pads
        if ht == hb and wl == wr:
            y = F.conv2d(xc, weight, inner, self.stride, (ht, wl),
                         groups=self.groups)
        else:
            y = F.conv2d(F.pad(xc, (wl, wr, ht, hb)), weight, inner,
                         self.stride, 0, groups=self.groups)
        y = y.permute(0, 2, 3, 1)
        return y if after is None else y + after


class ConvTranspose(nn.Module):
    """Transposed convolution with kernel == stride ("VALID", no overlap)
    on NHWC; weight (I, O, k, k), no bias."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, dtype=None):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, stride, stride))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x):
        dt = _compute_dtype(x, self.weight, self.dtype)
        y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2),
                               self.weight.to(dt), stride=self.stride)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Linear):
    """flax ``nn.Dense``: a Linear over the last axis."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=None):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        dt = _compute_dtype(x, self.weight, self.dtype)
        inner, after = _split_bias(_cast(self.bias, dt), dt)
        y = F.linear(x.to(dt), self.weight.to(dt), inner)
        return y if after is None else y + after


def _fast_stats(x, dims, keepdim=True):
    x = x.float()  # E[x^2] - E[x]^2 in bf16 would lose the variance
    mean = x.mean(dim=dims, keepdim=keepdim)
    var = ((x * x).mean(dim=dims, keepdim=keepdim) - mean * mean).clamp_min(0.0)
    return mean, var


def _norm_out(y, dtype):
    """A normalization's fp32 result in the layer's ``dtype`` (none: fp32,
    flax's promotion of a bf16 input with fp32 parameters)."""
    return y if dtype is None else y.to(dtype)


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

    def __init__(self, num_features: int, eps: float = 1e-3, dtype=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
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
        return _norm_out((x.float() - mean) * mul + self.bias, self.dtype)


class GroupNorm(nn.Module):
    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6,
                 dtype=None):
        super().__init__()
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        n, h, w, c = x.shape
        g = self.num_groups
        xg = x.float().reshape(n, h * w, g, c // g)
        mean, var = _fast_stats(xg, (1, 3))
        # flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(g, c // g)
        y = (xg - mean) * mul + self.bias.reshape(g, c // g)
        return _norm_out(y.reshape(n, h, w, c), self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis (eps 1e-6)."""

    def __init__(self, num_features: int, eps: float = 1e-6, dtype=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        x = x.float()
        mean, var = _fast_stats(x, (-1,))
        return _norm_out((x - mean) * (torch.rsqrt(var + self.eps)
                                       * self.weight) + self.bias, self.dtype)


class ConvBNReLU(nn.Module):
    """Conv (no bias) + BN(eps 1e-3) + ReLU. ``torch_pad`` pads (1, 1) as
    torch's ``padding=k//2`` does, instead of flax "SAME"."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, torch_pad: bool = False, dtype=None):
        super().__init__()
        self.Conv_0 = Conv(in_ch, features, kernel, stride,
                           padding=(kernel - 1) // 2 if torch_pad else "SAME",
                           bias=False, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features, dtype=dtype)

    def forward(self, x):
        return torch.relu(self.BatchNorm_0(self.Conv_0(x)))


class DeconvBNReLU(nn.Module):
    """ConvTranspose (k == stride) + BN + ReLU."""

    def __init__(self, in_ch: int, features: int, stride: int = 2,
                 dtype=None):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(in_ch, features, stride, dtype)
        self.BatchNorm_0 = BatchNorm(features, dtype=dtype)

    def forward(self, x):
        return torch.relu(self.BatchNorm_0(self.ConvTranspose_0(x)))


class DoubleConv(nn.Module):
    """Two convs with ReLU, both flax "SAME" padded."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, dtype=None):
        super().__init__()
        self.Conv_0 = Conv(in_ch, features, kernel, stride, dtype=dtype)
        self.Conv_1 = Conv(features, features, 3, dtype=dtype)

    def forward(self, x):
        return torch.relu(self.Conv_1(torch.relu(self.Conv_0(x))))


class DownsampleConv(nn.Module):
    """Shrink header: a stack of DoubleConvs."""

    def __init__(self, in_ch: int, dims: Sequence[int], kernels: Sequence[int],
                 strides: Sequence[int], dtype=None):
        super().__init__()
        for i, (k, d, s) in enumerate(zip(kernels, dims, strides)):
            self.add_module(f"DoubleConv_{i}", DoubleConv(in_ch, d, k, s, dtype))
            in_ch = d

    def forward(self, x):
        for m in self.children():
            x = m(x)
        return x


class NaiveCompressor(nn.Module):
    """The conv autoencoder channel compressor: ConvBNReLU to
    ``input_dim // compress_ratio`` channels, ConvBNReLU back, then a 3x3
    conv (no bias), BN (eps 1e-3) and ReLU; flax "SAME" padding."""

    def __init__(self, input_dim: int, compress_ratio: int):
        super().__init__()
        hidden = input_dim // compress_ratio
        self.ConvBNReLU_0 = ConvBNReLU(input_dim, hidden, 3)
        self.ConvBNReLU_1 = ConvBNReLU(hidden, input_dim, 3)
        self.Conv_0 = Conv(input_dim, input_dim, 3, bias=False)
        self.BatchNorm_0 = BatchNorm(input_dim)

    def forward(self, x):
        x = self.ConvBNReLU_1(self.ConvBNReLU_0(x))
        return torch.relu(self.BatchNorm_0(self.Conv_0(x)))


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of ``jax.image.resize``'s "bilinear" along one
    axis (``compute_weight_mat``, antialiased): a triangle kernel widened
    by 1 / scale when the axis shrinks, each output's weights normalised,
    in fp32 as JAX computes them."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(n_out / n_in)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(x: torch.Tensor, shape) -> torch.Tensor:
    """``jax.image.resize(x, shape, "bilinear")``: every axis whose size
    changes is contracted with its weight matrix (``_resize_weights``);
    unlike ``F.interpolate`` it antialiases where an axis shrinks. Axes
    of equal size are left as they are."""
    if len(shape) != x.dim():
        raise ValueError(f"shape {tuple(shape)} does not match {tuple(x.shape)}")
    for d, n in enumerate(shape):
        if x.shape[d] != n:
            w = torch.from_numpy(_resize_weights(x.shape[d], n)).to(
                device=x.device, dtype=x.dtype)
            x = torch.tensordot(x, w, dims=([d], [0])).movedim(-1, d)
    return x
