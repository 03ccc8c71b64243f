"""HEAL feature aligners.

Counterpart of ``gencomm_tpu/models/aligners.py:AlignNet`` for its
``identity`` method, the one every ``aligner_args`` block under
``configs/`` names; the trainable aligners (``convnext``, ``resnet1x1``,
``resnet3x3``, ``sdta``, ``cbam``, ``fanet``, ``scaligner``) belong to the
BackAlign baselines and raise ``NotImplementedError``.
"""

from __future__ import annotations

from torch import nn


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
