"""HEAL feature aligners and the ConvNeXt block.

Counterpart of ``gencomm_tpu/models/aligners.py``: ``AlignNet`` for its
``identity`` method, the one every ``aligner_args`` block under
``configs/`` names (the trainable aligners, ``convnext``, ``resnet1x1``,
``resnet3x3``, ``sdta``, ``cbam``, ``fanet`` and ``scaligner``, reach no
config and raise ``NotImplementedError``), and ``ConvNeXtBlock``, the body
of STAMP's ``adapterconvnext`` adapters.
"""

from __future__ import annotations

import torch
from torch import nn

from gencomm_tpu_torch.models.layers import Conv, Dense, LayerNorm


class AlignNet(nn.Module):
    def __init__(self, core_method: str = "identity"):
        super().__init__()
        if core_method != "identity":
            raise NotImplementedError(
                f"aligner {core_method!r} is not ported yet (ROADMAP item 16)")
        self.core_method = core_method

    @staticmethod
    def from_config(cfg: dict) -> "AlignNet":
        return AlignNet(cfg.get("core_method", "identity"))

    def forward(self, x):
        return x


class ConvNeXtBlock(nn.Module):
    """NHWC: depthwise k x k conv -> LayerNorm (eps 1e-6) -> Linear to 4
    dim -> exact (erf) GELU -> Linear back -> times the layer scale
    ``gamma`` (dim,) -> plus the input."""

    # random_state_dict draws the layer scale small, as its init is 1e-6
    PARAM_STD = {"gamma": 0.1}

    def __init__(self, dim: int, kernel_size: int = 7,
                 layer_scale_init_value: float = 1e-6):
        super().__init__()
        self.dwconv = Conv(dim, dim, kernel_size, groups=dim)
        self.LayerNorm_0 = LayerNorm(dim)
        self.pwconv1 = Dense(dim, 4 * dim)
        self.pwconv2 = Dense(4 * dim, dim)
        self.gamma = (nn.Parameter(torch.full((dim,), layer_scale_init_value))
                      if layer_scale_init_value > 0 else None)

    def forward(self, x):
        y = self.pwconv1(self.LayerNorm_0(self.dwconv(x)))
        y = self.pwconv2(nn.functional.gelu(y))
        if self.gamma is not None:
            y = self.gamma * y
        return x + y
