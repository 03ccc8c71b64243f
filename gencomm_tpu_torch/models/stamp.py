"""STAMP's adapters and reverters: each modality's feature to the shared
protocol space and back.

Counterpart of ``gencomm_tpu/models/stamp.py``: ``_resize_and_fit``
rescales a feature so that its pixels per meter match the protocol grid's
(``layers.resize_bilinear``, ``jax.image.resize``'s antialiased bilinear)
and centre-pads or crops it to the protocol's (H, W); ``StampAdapter`` is
one direction (modality to protocol as an adapter, protocol to modality as
a reverter) with the methods ``identity``, ``adapterconvnext`` (resize, a
1x1 channel convert, ``num_of_blocks`` ConvNeXt blocks, a 1x1 convert; the
3x3 smoothing conv the reference builds is never applied, so none is
built), ``adapterconv`` and ``adapterfc``. Every adapter and reverter block
under ``configs/`` names ``adapterconvnext``. ``adapterdsa`` (deformable
spatial attention with 2D sinusoidal encodings) reaches no config and
raises ``NotImplementedError``.

The grid a feature is fitted to is the ego's, known only when the model
runs, so ``forward`` takes it (``out_hw``); the parameters do not depend on
it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch.nn.functional as F
from torch import nn

from gencomm_tpu_torch.models.aligners import ConvNeXtBlock
from gencomm_tpu_torch.models.layers import Conv, Dense, gelu, resize_bilinear


def _resize_and_fit(x, in_range: Sequence[float], out_range: Sequence[float],
                    out_hw: Tuple[int, int]):
    """x (N, H, W, C) rescaled to the protocol grid's meters per pixel, then
    centre-padded with zeros or cropped to ``out_hw``."""
    n, h, w, c = x.shape
    out_h, out_w = out_hw
    ratio_y = (out_h / (out_range[4] - out_range[1])) / (
        h / (in_range[4] - in_range[1]))
    ratio_x = (out_w / (out_range[3] - out_range[0])) / (
        w / (in_range[3] - in_range[0]))
    nh = max(1, int(round(h * ratio_y)))
    nw = max(1, int(round(w * ratio_x)))
    if (nh, nw) != (h, w):
        x = resize_bilinear(x, (n, nh, nw, c))
    dh, dw = out_h - nh, out_w - nw
    if dh > 0 or dw > 0:
        x = F.pad(x, (0, 0, max(dw // 2, 0), max(dw - dw // 2, 0),
                      max(dh // 2, 0), max(dh - dh // 2, 0)))
    nh, nw = x.shape[1:3]
    if nh > out_h or nw > out_w:
        top, left = (nh - out_h) // 2, (nw - out_w) // 2
        x = x[:, top:top + out_h, left:left + out_w, :]
    return x


class StampAdapter(nn.Module):
    """One translation direction: x (N, H, W, in_channels) on ``in_range``
    -> (N, out_hw, out_channels) on ``out_range``."""

    def __init__(self, in_channels: int, out_channels: int,
                 in_range: Sequence[float], out_range: Sequence[float],
                 core_method: str = "adapterconvnext", hidden_dim: int = 64,
                 num_of_blocks: int = 3, kernel_size: int = 7):
        super().__init__()
        self.method = core_method.lower()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.in_range, self.out_range = tuple(in_range), tuple(out_range)
        self.num_of_blocks = num_of_blocks
        if self.method == "adapterconvnext":
            self.channel_convert1 = Conv(in_channels, hidden_dim, 1)
            for i in range(num_of_blocks):
                self.add_module(f"convnext_{i}", ConvNeXtBlock(
                    hidden_dim, kernel_size=kernel_size))
            self.channel_convert2 = Conv(hidden_dim, out_channels, 1)
        elif self.method == "adapterconv":
            self.conv1 = Conv(in_channels, hidden_dim, 3)
            self.conv2 = Conv(hidden_dim, out_channels, 3)
        elif self.method == "adapterfc":
            self.fc1 = Dense(in_channels, hidden_dim)
            self.fc2 = Dense(hidden_dim, out_channels)
        elif self.method == "adapterdsa":
            raise NotImplementedError(
                "the adapterdsa STAMP adapter is not ported yet (ROADMAP item "
                "16); no config names it")
        elif self.method != "identity":
            raise ValueError(f"unknown stamp adapter {core_method}")

    def forward(self, x, out_hw: Tuple[int, int]):
        x = _resize_and_fit(x, self.in_range, self.out_range, out_hw)
        if self.method == "identity":
            if self.out_channels != self.in_channels:
                x = resize_bilinear(x, x.shape[:3] + (self.out_channels,))
            return x
        if self.method == "adapterconvnext":
            x = self.channel_convert1(x)
            for i in range(self.num_of_blocks):
                x = getattr(self, f"convnext_{i}")(x)
            return self.channel_convert2(x)
        if self.method == "adapterconv":
            return self.conv2(self.conv1(x).relu())
        return self.fc2(gelu(self.fc1(x)))

    @staticmethod
    def from_config(cfg: dict, in_range, out_range) -> "StampAdapter":
        """An ``adapter`` or ``reverter`` block of a modality's config, read
        as the JAX package's ``StampAdapter.from_config`` reads it."""
        a = cfg.get("args", {})
        return StampAdapter(
            in_channels=a.get("in_channels", 128),
            out_channels=a.get("out_channels", 128),
            in_range=in_range, out_range=out_range,
            core_method=cfg.get("core_method", "adapterconvnext"),
            hidden_dim=a.get("dim", 64),
            num_of_blocks=a.get("n_layers", a.get("num_of_blocks", 3)),
            kernel_size=a.get("kernel_size", 7))
