"""DDPM UNet denoiser for GenComm feature generation, NHWC.

Counterpart of ``gencomm_tpu/models/gencomm/unet.py``: swish, GroupNorm(4,
eps 1e-6), sinusoidal timestep embedding (dividing by half - 1) into a
2-layer MLP, ResnetBlocks with the embedding added, Downsample = pad
(0, 1, 0, 1) + VALID stride-2 conv, Upsample = nearest repeat + conv.
Attention blocks are not ported: none is built unless a level's nominal
resolution is in ``attn_resolutions``, which the flagship's ch_mult=(1, 1)
at resolution 128 never reaches. ``dtype`` is every layer's
(``models/layers.py``); the input is cast to it and the output is in it.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gencomm_tpu_torch.models.layers import Conv, Dense, GroupNorm, sigmoid


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding, [sin | cos] halves."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / (half - 1))
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def swish(x):
    return x * sigmoid(x)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_ch: int, dtype=None):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(4, in_ch, dtype=dtype)
        self.Conv_0 = Conv(in_ch, out_ch, 3, dtype=dtype)
        self.Dense_0 = Dense(temb_ch, out_ch, dtype=dtype)
        self.GroupNorm_1 = GroupNorm(4, out_ch, dtype=dtype)
        self.Conv_1 = Conv(out_ch, out_ch, 3, dtype=dtype)
        self.Conv_2 = (Conv(in_ch, out_ch, 1, dtype=dtype)
                       if in_ch != out_ch else None)

    def forward(self, x, temb):
        h = self.Conv_0(swish(self.GroupNorm_0(x)))
        h = h + self.Dense_0(swish(temb))[:, None, None, :]
        h = self.Conv_1(swish(self.GroupNorm_1(h)))
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        return x + h


class Downsample(nn.Module):
    def __init__(self, ch: int, dtype=None):
        super().__init__()
        self.Conv_0 = Conv(ch, ch, 3, 2, padding="VALID", dtype=dtype)

    def forward(self, x):
        return self.Conv_0(F.pad(x, (0, 0, 0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, ch: int, dtype=None):
        super().__init__()
        self.Conv_0 = Conv(ch, ch, 3, dtype=dtype)

    def forward(self, x):
        return self.Conv_0(x.repeat_interleave(2, 1).repeat_interleave(2, 2))


class DiffusionUNet(nn.Module):
    def __init__(self, in_ch: int, out_ch: int = 128, ch: int = 8,
                 ch_mult: Sequence[int] = (1, 1), num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (16,),
                 resolution: int = 128, dtype=None):
        super().__init__()
        self.ch, self.ch_mult = ch, tuple(ch_mult)
        self.num_res_blocks, self.dtype = num_res_blocks, dtype
        temb_ch = ch * 4
        self.Dense_0 = Dense(ch, temb_ch, dtype=dtype)
        self.Dense_1 = Dense(temb_ch, temb_ch, dtype=dtype)
        self.conv_in = Conv(in_ch, ch, 3, dtype=dtype)

        num_res = len(ch_mult)
        curr_res = resolution
        hs_ch = [ch]
        block_in = ch
        for i_level in range(num_res):
            block_out = ch * ch_mult[i_level]
            for i_block in range(num_res_blocks):
                self._no_attn(curr_res, attn_resolutions)
                self.add_module(f"down{i_level}_block{i_block}",
                                ResnetBlock(block_in, block_out, temb_ch, dtype))
                block_in = block_out
                hs_ch.append(block_in)
            if i_level != num_res - 1:
                self.add_module(f"down{i_level}_ds", Downsample(block_in, dtype))
                hs_ch.append(block_in)
                curr_res //= 2
        self.mid_block1 = ResnetBlock(block_in, block_in, temb_ch, dtype)
        self.mid_block2 = ResnetBlock(block_in, block_in, temb_ch, dtype)
        for i_level in reversed(range(num_res)):
            block_out = ch * ch_mult[i_level]
            for i_block in range(num_res_blocks + 1):
                self._no_attn(curr_res, attn_resolutions)
                self.add_module(f"up{i_level}_block{i_block}", ResnetBlock(
                    block_in + hs_ch.pop(), block_out, temb_ch, dtype))
                block_in = block_out
            if i_level != 0:
                self.add_module(f"up{i_level}_us", Upsample(block_in, dtype))
                curr_res *= 2
        self.GroupNorm_0 = GroupNorm(4, block_in, dtype=dtype)
        self.conv_out = Conv(block_in, out_ch, 3, dtype=dtype)

    @staticmethod
    def _no_attn(curr_res, attn_resolutions):
        if curr_res in attn_resolutions:
            raise NotImplementedError(
                f"UNet attention at resolution {curr_res} is not ported yet")

    def forward(self, x, t):
        """x (N, H, W, Cin) = concat(condition, noisy feature); t (N,)."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        temb = self.Dense_0(timestep_embedding(t, self.ch))
        temb = self.Dense_1(swish(temb))
        num_res = len(self.ch_mult)
        hs = [self.conv_in(x)]
        for i_level in range(num_res):
            for i_block in range(self.num_res_blocks):
                hs.append(getattr(self, f"down{i_level}_block{i_block}")(
                    hs[-1], temb))
            if i_level != num_res - 1:
                hs.append(getattr(self, f"down{i_level}_ds")(hs[-1]))
        h = self.mid_block2(self.mid_block1(hs[-1], temb), temb)
        for i_level in reversed(range(num_res)):
            for i_block in range(self.num_res_blocks + 1):
                h = getattr(self, f"up{i_level}_block{i_block}")(
                    torch.cat([h, hs.pop()], dim=-1), temb)
            if i_level != 0:
                h = getattr(self, f"up{i_level}_us")(h)
        return self.conv_out(swish(self.GroupNorm_0(h)))
