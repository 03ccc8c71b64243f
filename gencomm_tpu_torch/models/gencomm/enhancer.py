"""Post-generation feature Enhancer, the shipped ``use_attn=False`` path.

Counterpart of ``gencomm_tpu/models/gencomm/enhancer.py`` (``FRFN``,
``SplitAttn``, ``EnhancerBlock``, ``Enhancer``): x + LN(x), then the FRFN
gated MLP (partial conv on the first dim//4 channels, GELU tanh, depthwise
conv), then a sigmoid channel gate from the fp32 spatial mean. The window
and angle attention branches are not ported. NHWC. ``dtype`` (bf16 under
``half``) is every layer's; the input is cast to it at the block's entry.
"""

from __future__ import annotations

import torch
from torch import nn

from gencomm_tpu_torch.models.layers import (
    Conv, Dense, LayerNorm, gelu, sigmoid,
)


class FRFN(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, dtype=None):
        super().__init__()
        self.dim_conv = dim // 4
        self.partial_conv = Conv(self.dim_conv, self.dim_conv, 3, bias=False,
                                 dtype=dtype)
        self.linear1 = Dense(dim, hidden_dim * 2, dtype=dtype)
        self.dwconv = Conv(hidden_dim, hidden_dim, 3, groups=hidden_dim,
                           dtype=dtype)
        self.linear2 = Dense(hidden_dim, dim, dtype=dtype)

    def forward(self, x):
        x1 = self.partial_conv(x[..., :self.dim_conv])
        x = torch.cat([x1, x[..., self.dim_conv:].to(x1.dtype)], dim=-1)
        g1, g2 = gelu(self.linear1(x)).chunk(2, dim=-1)
        g1 = gelu(self.dwconv(g1))
        return self.linear2(g1 * g2)


class SplitAttn(nn.Module):
    def __init__(self, dim: int, dtype=None):
        super().__init__()
        self.fc1 = Dense(dim, dim, bias=False, dtype=dtype)
        self.ln = LayerNorm(dim, dtype=dtype)
        self.fc2 = Dense(dim, dim, bias=False, dtype=dtype)

    def forward(self, x):
        gap = x.to(torch.float32).mean(dim=(1, 2), keepdim=True).to(x.dtype)
        y = self.fc2(torch.relu(self.ln(self.fc1(gap))))
        return x * sigmoid(y).to(x.dtype)


class EnhancerBlock(nn.Module):
    def __init__(self, dim: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = FRFN(dim, dim * 2, dtype)

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x + self.norm1(x)  # the shipped residual with attention disabled
        return x + self.mlp(self.norm2(x))


class Enhancer(nn.Module):
    def __init__(self, dim: int, use_attn: bool = False, dtype=None):
        super().__init__()
        if use_attn:
            raise NotImplementedError(
                "the Enhancer attention branches are not ported yet (ROADMAP "
                "item 17)")
        self.block_1 = EnhancerBlock(dim, dtype)
        self.split_attn = SplitAttn(dim, dtype)

    def forward(self, x):
        return self.split_attn(self.block_1(x))
