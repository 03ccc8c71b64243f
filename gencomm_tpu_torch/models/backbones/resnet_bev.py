"""ResNet / ResNeXt multiscale BEV backbone, NHWC.

Counterpart of ``gencomm_tpu/models/backbones/resnet_bev.py``:
``BasicBlock`` (3x3-3x3 residual), ``Bottleneck`` (HEAL's ResNeXt-32x4d
stage: expansion 1, 32 groups of width 4 per 64 features) and
``ResNetBEVBackbone`` with its ``encode_multiscale`` / ``decode_multiscale``
split, which the HEAL pyramid fuses between. The residual blocks' norms use
eps 1e-5 (torch's ``BatchNorm2d`` default in the reference's blocks), the
deconv decode heads eps 1e-3; momentum 0.99 throughout. A 3x3 conv at
stride 2 pads (1, 1), as torch's ``padding=1`` does, not flax "SAME"'s
(0, 1) on an even axis. Submodule names follow flax's auto-names.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from gencomm_tpu_torch.models.layers import (
    BatchNorm, Conv, ConvBNReLU, DeconvBNReLU,
)

BLOCK_EPS = 1e-5


def _downsample(block: nn.Module, in_ch: int, features: int, stride: int):
    """The identity path's 1x1 conv and norm, where the block changes the
    stride or the width (flax names ``downsample`` and the block's last
    ``BatchNorm_j``)."""
    if stride == 1 and in_ch == features:
        return None
    block.downsample = Conv(in_ch, features, 1, stride, bias=False)
    return BatchNorm(features, eps=BLOCK_EPS)


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv(in_ch, features, 3, stride, padding=1, bias=False)
        self.BatchNorm_0 = BatchNorm(features, eps=BLOCK_EPS)
        self.Conv_1 = Conv(features, features, 3, bias=False)
        self.BatchNorm_1 = BatchNorm(features, eps=BLOCK_EPS)
        self.BatchNorm_2 = _downsample(self, in_ch, features, stride)

    def forward(self, x):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        identity = x if self.BatchNorm_2 is None else \
            self.BatchNorm_2(self.downsample(x))
        return torch.relu(y + identity)


class Bottleneck(nn.Module):
    """1x1 to ``width`` channels, a grouped 3x3 (the stride), 1x1 back to
    ``features``; width = features * width_per_group * groups / 64."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 groups: int = 32, width_per_group: int = 4):
        super().__init__()
        width = int(features * (width_per_group * groups / 64.0))
        self.Conv_0 = Conv(in_ch, width, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(width, eps=BLOCK_EPS)
        self.Conv_1 = Conv(width, width, 3, stride, padding=1, bias=False,
                           groups=groups)
        self.BatchNorm_1 = BatchNorm(width, eps=BLOCK_EPS)
        self.Conv_2 = Conv(width, features, 1, bias=False)
        self.BatchNorm_2 = BatchNorm(features, eps=BLOCK_EPS)
        self.BatchNorm_3 = _downsample(self, in_ch, features, stride)

    def forward(self, x):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        identity = x if self.BatchNorm_3 is None else \
            self.BatchNorm_3(self.downsample(x))
        return torch.relu(y + identity)


def add_levels(module: nn.Module, in_ch: int, layer_nums: Sequence[int],
               layer_strides: Sequence[int], num_filters: Sequence[int],
               block=BasicBlock, first: int = 0) -> int:
    """Adds the residual levels ``layer{i}_{k}`` (from level ``first``) to
    ``module``; returns the last level's width."""
    for i in range(first, len(layer_nums)):
        module.add_module(f"layer{i}_0", block(in_ch, num_filters[i],
                                               layer_strides[i]))
        for k in range(1, layer_nums[i]):
            module.add_module(f"layer{i}_{k}", block(num_filters[i],
                                                     num_filters[i]))
        in_ch = num_filters[i]
    return in_ch


def add_deblocks(module: nn.Module, widths: Sequence[int],
                 upsample_strides: Sequence[int],
                 num_upsample_filters: Sequence[int]) -> int:
    """Adds the decode heads ``deblock{i}`` (a deconv, or a strided conv
    for a stride below 1) to ``module`` for levels of ``widths`` channels;
    returns the width of their concatenation."""
    out = []
    for i, width in enumerate(widths):
        if i < len(upsample_strides):
            s, f = upsample_strides[i], num_upsample_filters[i]
            if s >= 1:
                module.add_module(f"deblock{i}", DeconvBNReLU(width, f, int(s)))
            else:
                k = int(round(1 / s))
                module.add_module(f"deblock{i}", ConvBNReLU(width, f, k, k))
            width = f
        out.append(width)
    return sum(out)


def decode_levels(module: nn.Module, feats):
    """Each level through its ``deblock{i}`` (where it has one), the results
    concatenated on the channels."""
    ups = [getattr(module, f"deblock{i}")(x)
           if hasattr(module, f"deblock{i}") else x
           for i, x in enumerate(feats)]
    return torch.cat(ups, dim=-1) if len(ups) > 1 else ups[0]


class ResNetBEVBackbone(nn.Module):
    """Residual levels (``resnext``: Bottleneck blocks, else BasicBlock),
    then per-level decode heads concatenated."""

    def __init__(self, in_ch: int, layer_nums: Sequence[int],
                 layer_strides: Sequence[int], num_filters: Sequence[int],
                 upsample_strides: Sequence[int] = (),
                 num_upsample_filters: Sequence[int] = (),
                 resnext: bool = False):
        super().__init__()
        self.n_levels = len(layer_nums)
        # a level always has its first block (flax builds layer{i}_0 first)
        self.layer_nums = tuple(max(n, 1) for n in layer_nums)
        add_levels(self, in_ch, layer_nums, layer_strides, num_filters,
                   Bottleneck if resnext else BasicBlock)
        self.out_channels = add_deblocks(self, num_filters, upsample_strides,
                                         num_upsample_filters)

    @staticmethod
    def from_config(cfg: dict, in_ch: int) -> "ResNetBEVBackbone":
        return ResNetBEVBackbone(
            in_ch, cfg["layer_nums"], cfg["layer_strides"], cfg["num_filters"],
            cfg.get("upsample_strides", ()),
            cfg.get("num_upsample_filter", ()),
            resnext=bool(cfg.get("resnext", False)))

    def encode_multiscale(self, x):
        feats = []
        for i, n in enumerate(self.layer_nums):
            for k in range(n):
                x = getattr(self, f"layer{i}_{k}")(x)
            feats.append(x)
        return feats

    def decode_multiscale(self, feats):
        return decode_levels(self, feats)

    def forward(self, x):
        return self.decode_multiscale(self.encode_multiscale(x))
