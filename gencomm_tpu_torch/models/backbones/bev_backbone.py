"""SSD-style multiscale BEV backbone, NHWC.

Counterpart of ``gencomm_tpu/models/backbones/bev_backbone.py``: N levels of
strided conv stacks (stems padded (1, 1) as in the reference's
ZeroPad2d(1)), per-level deconv heads, concatenated after cropping to the
smallest map. ``dtype`` is every layer's (``models/layers.py``). The
optional ``level_fuse(i, feat)`` hook runs on each level's map between the
encode and the decode (the legacy SECOND model's per-level fusion).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from gencomm_tpu_torch.models.layers import ConvBNReLU, DeconvBNReLU


class BEVBackbone(nn.Module):
    def __init__(self, in_ch: int, layer_nums: Sequence[int],
                 layer_strides: Sequence[int], num_filters: Sequence[int],
                 upsample_strides: Sequence[int] = (),
                 num_upsample_filters: Sequence[int] = (), dtype=None):
        super().__init__()
        self.n_levels = len(layer_nums)
        for i, (n_layers, stride, filters) in enumerate(
                zip(layer_nums, layer_strides, num_filters)):
            self.add_module(f"block{i}_0", ConvBNReLU(
                in_ch, filters, 3, stride, torch_pad=True, dtype=dtype))
            for k in range(n_layers):
                self.add_module(f"block{i}_{k + 1}",
                                ConvBNReLU(filters, filters, 3, dtype=dtype))
            in_ch = filters
        self.layer_nums = tuple(layer_nums)
        self.n_deblocks = len(upsample_strides)
        for i, (s, f) in enumerate(zip(upsample_strides, num_upsample_filters)):
            if s < 1:
                raise NotImplementedError(
                    "strided-conv decoder levels (upsample stride < 1) are "
                    "not ported yet")
            self.add_module(f"deblock{i}",
                            DeconvBNReLU(num_filters[i], f, int(s), dtype))
        widths = list(num_upsample_filters[:self.n_deblocks]) + list(
            num_filters[self.n_deblocks:])
        self.out_channels = sum(widths) if len(widths) > 1 else widths[0]

    def encode_multiscale(self, x):
        feats = []
        for i, n_layers in enumerate(self.layer_nums):
            for k in range(n_layers + 1):
                x = getattr(self, f"block{i}_{k}")(x)
            feats.append(x)
        return feats

    def decode_multiscale(self, feats):
        ups = [getattr(self, f"deblock{i}")(x) if i < self.n_deblocks else x
               for i, x in enumerate(feats)]
        if len(ups) > 1:
            h = min(u.shape[1] for u in ups)
            w = min(u.shape[2] for u in ups)
            return torch.cat([u[:, :h, :w] for u in ups], dim=-1)
        return ups[0]

    def forward(self, x, level_fuse=None):
        feats = self.encode_multiscale(x)
        if level_fuse is not None:
            feats = [level_fuse(i, f) for i, f in enumerate(feats)]
        return self.decode_multiscale(feats)
