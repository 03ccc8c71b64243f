"""PointPillars BEV encoder, host-decorated path.

Counterpart of ``gencomm_tpu/models/encoders/point_pillar.py``
(``PFNLayer``, ``MaskedBatchNorm`` at eval, ``_from_decorated``): the 10-dim
decorated points go through the PFN (Linear without bias, batch norm from
running statistics, ReLU), are masked and cast to bf16, and kernel K2 builds
the per-agent canvas. The raw-point and voxel-list paths are not ported.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from gencomm_tpu_torch.models.layers import Dense
from gencomm_tpu_torch.ops.pillar_canvas import pillar_canvas


class MaskedBatchNorm(nn.Module):
    """Batch norm over points; at eval it reads the running statistics
    (eps 1e-3): y = (x - mean) * rsqrt(var + eps) * scale + bias."""

    def __init__(self, num_features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return y * self.weight + self.bias


class PFNLayer(nn.Module):
    def __init__(self, in_ch: int, features: int, use_norm: bool = True):
        super().__init__()
        self.Dense_0 = Dense(in_ch, features, bias=not use_norm)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features) if use_norm else None

    def forward(self, x):
        x = self.Dense_0(x)
        if self.MaskedBatchNorm_0 is not None:
            x = self.MaskedBatchNorm_0(x)
        return torch.relu(x)


class PointPillarEncoder(nn.Module):
    def __init__(self, voxel_size: Tuple[float, float, float],
                 lidar_range: Tuple[float, ...], num_filters: Sequence[int] = (64,),
                 use_norm: bool = True):
        super().__init__()
        self.nx = int(round((lidar_range[3] - lidar_range[0]) / voxel_size[0]))
        self.ny = int(round((lidar_range[4] - lidar_range[1]) / voxel_size[1]))
        in_ch = 10
        for i, f in enumerate(num_filters):
            self.add_module(f"PFNLayer_{i}", PFNLayer(in_ch, f, use_norm))
            in_ch = f
        self.out_channels = in_ch

    def forward(self, decorated, gids, dvalid):
        """decorated (B, L, P, 10) fp32, gids (B, L, P) int32 sorted within
        each agent (invalid ids >= nx*ny), dvalid (B, L, P) bool ->
        canvas (B, L, ny, nx, C) bf16."""
        b, l, p, d = decorated.shape
        ncell = self.nx * self.ny
        x = decorated.reshape(b * l * p, d)
        for layer in self.children():
            x = layer(x)
        valid = dvalid.reshape(b * l * p, 1)
        rows = torch.where(valid, x, torch.zeros_like(x)).to(torch.bfloat16)
        flat_gids = gids.reshape(-1).clamp_max(ncell - 1).to(torch.int32)
        canvas = pillar_canvas(rows.contiguous(), flat_gids.contiguous(),
                               b * l, ncell)
        return canvas.reshape(b, l, self.ny, self.nx, x.shape[-1])
