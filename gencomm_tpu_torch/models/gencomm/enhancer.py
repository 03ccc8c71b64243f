"""Post-generation feature Enhancer, the shipped ``use_attn=False`` path.

Counterpart of ``gencomm_tpu/models/gencomm/enhancer.py`` (``FRFN``,
``SplitAttn``, ``EnhancerBlock``, ``Enhancer``): x + LN(x), then the FRFN
gated MLP (partial conv on the first dim//4 channels, GELU tanh, depthwise
conv), then a sigmoid channel gate from the fp32 spatial mean. The window
and angle attention branches are not ported. NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gencomm_tpu_torch.models.layers import Conv, Dense, LayerNorm


def gelu(x):
    return F.gelu(x, approximate="tanh")  # flax nn.gelu default


class FRFN(nn.Module):
    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.dim_conv = dim // 4
        self.partial_conv = Conv(self.dim_conv, self.dim_conv, 3, bias=False)
        self.linear1 = Dense(dim, hidden_dim * 2)
        self.dwconv = Conv(hidden_dim, hidden_dim, 3, groups=hidden_dim)
        self.linear2 = Dense(hidden_dim, dim)

    def forward(self, x):
        x1 = self.partial_conv(x[..., :self.dim_conv])
        x = torch.cat([x1, x[..., self.dim_conv:]], dim=-1)
        g1, g2 = gelu(self.linear1(x)).chunk(2, dim=-1)
        g1 = gelu(self.dwconv(g1))
        return self.linear2(g1 * g2)


class SplitAttn(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = Dense(dim, dim, bias=False)
        self.ln = LayerNorm(dim)
        self.fc2 = Dense(dim, dim, bias=False)

    def forward(self, x):
        gap = x.to(torch.float32).mean(dim=(1, 2), keepdim=True).to(x.dtype)
        y = self.fc2(torch.relu(self.ln(self.fc1(gap))))
        return x * torch.sigmoid(y)


class EnhancerBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = FRFN(dim, dim * 2)

    def forward(self, x):
        x = x + self.norm1(x)  # the shipped residual with attention disabled
        return x + self.mlp(self.norm2(x))


class Enhancer(nn.Module):
    def __init__(self, dim: int, use_attn: bool = False):
        super().__init__()
        if use_attn:
            raise NotImplementedError(
                "the Enhancer attention branches are not ported yet")
        self.block_1 = EnhancerBlock(dim)
        self.split_attn = SplitAttn(dim)

    def forward(self, x):
        return self.split_attn(self.block_1(x))
