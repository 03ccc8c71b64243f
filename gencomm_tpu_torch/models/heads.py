"""Detection heads: cls/reg/dir 1x1 convs, NHWC.

Counterpart of ``gencomm_tpu/models/heads.py`` (single class).
"""

from __future__ import annotations

from torch import nn

from gencomm_tpu_torch.models.layers import Conv


class DetectionHeads(nn.Module):
    def __init__(self, in_ch: int, anchor_number: int = 2, dir_bins: int = 2):
        super().__init__()
        self.cls_head = Conv(in_ch, anchor_number, 1)
        self.reg_head = Conv(in_ch, 7 * anchor_number, 1)
        self.dir_head = Conv(in_ch, dir_bins * anchor_number, 1)

    def forward(self, x):
        return self.cls_head(x), self.reg_head(x), self.dir_head(x)
