"""Detection heads: cls/reg/dir 1x1 convs, NHWC.

Counterpart of ``gencomm_tpu/models/heads.py``. Outputs (B, H', W', A*C*C),
(B, H', W', 7*A*C), (B, H', W', bins*A): with ``num_class`` C > 1
(V2X-Real) each cell carries A anchors per class, class-major, and every
anchor-class slot predicts C class scores.
"""

from __future__ import annotations

from torch import nn

from gencomm_tpu_torch.models.layers import Conv


class DetectionHeads(nn.Module):
    def __init__(self, in_ch: int, anchor_number: int = 2, dir_bins: int = 2,
                 num_class: int = 1):
        super().__init__()
        self.cls_head = Conv(in_ch, anchor_number * num_class * num_class, 1)
        self.reg_head = Conv(in_ch, 7 * anchor_number * num_class, 1)
        self.dir_head = Conv(in_ch, dir_bins * anchor_number, 1)

    def forward(self, x):
        return self.cls_head(x), self.reg_head(x), self.dir_head(x)
