"""Deformable message extractor: BEV feature -> 2-channel message.

Counterpart of ``gencomm_tpu/models/gencomm/message_extractor.py``: offset
conv to 18 channels ((dy, dx) per tap), offsets clamped to ±4 px, kernel K1,
bias, SE channel gate, 1x1 fuse to ``out_ch`` channels. NHWC. Like the JAX
module it has no ``dtype``: on a bf16 feature (``half``) the offset conv
promotes to fp32, K1 takes the bf16 map and returns bf16 (its bf16
instantiation on the card), and the bias, the SE gate and the fuse convs
promote again, so the message is fp32.
"""

from __future__ import annotations

import torch
from torch import nn

from gencomm_tpu_torch.models.layers import Conv
from gencomm_tpu_torch.ops.deform_conv import deform_conv3x3_clamped


class MessageExtractor(nn.Module):
    def __init__(self, in_ch: int = 128, out_ch: int = 2, mid_ch: int = 64):
        super().__init__()
        self.offset = Conv(in_ch, 18, 3)
        # the deformable conv's weight keeps the JAX layout (3, 3, Cin, Cout)
        self.dcn_kernel = nn.Parameter(
            torch.randn(3, 3, in_ch, mid_ch) / (9 * in_ch) ** 0.5)
        self.dcn_bias = nn.Parameter(torch.zeros(mid_ch))
        self.se_reduce = Conv(mid_ch, mid_ch // 2, 1)
        self.se_expand = Conv(mid_ch // 2, mid_ch, 1)
        self.fuse0 = Conv(mid_ch, mid_ch, 1)
        self.fuse1 = Conv(mid_ch, out_ch, 1)

    def forward(self, x):
        x = x.contiguous()
        offsets = self.offset(x)
        b1 = deform_conv3x3_clamped(x, offsets, self.dcn_kernel, self.dcn_bias)
        gap = b1.mean(dim=(1, 2), keepdim=True)
        a = torch.sigmoid(self.se_expand(torch.relu(self.se_reduce(gap))))
        y = torch.relu(self.fuse0(b1 * a))
        return self.fuse1(y)
