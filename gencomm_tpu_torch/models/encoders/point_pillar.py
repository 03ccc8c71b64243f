"""PointPillars BEV encoder, host-decorated and raw-point paths.

Counterpart of ``gencomm_tpu/models/encoders/point_pillar.py``
(``PFNLayer``, ``MaskedBatchNorm``, ``_from_decorated`` and the raw-point
``__call__``). Host-decorated (``forward``): the 10-dim decorated points go
through the PFN (Linear without bias, masked batch norm, ReLU), are masked
and cast to bf16, and kernel K2 builds the per-agent canvas (K2b its
gradient in training); the canvas is bf16. Raw points (``from_points``):
the points are decorated on the device (``ops/voxel.py``), go through the
same PFN and are max-reduced onto a canvas of the PFN's dtype, as the JAX
raw path does. With ``dtype=bfloat16`` (``half``) the PFN's Linear runs in
bf16 and its norm in fp32, returning bf16. The voxel-list path is not
ported.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from gencomm_tpu_torch.models.layers import Dense, update_running_stats
from gencomm_tpu_torch.ops import voxel as vox
from gencomm_tpu_torch.ops.pillar_canvas import pillar_canvas


class MaskedBatchNorm(nn.Module):
    """Batch norm over points (eps 1e-3, momentum 0.99): y = (x - mean) *
    rsqrt(var + eps) * scale + bias. At eval it reads the running
    statistics. In training the statistics are taken over the valid rows
    only, the variance in two passes, ((x - mean)^2 * valid).sum() / n with
    n = max(#valid, 1), and update the running statistics. The statistics
    and the normalization run in fp32; the result has the input's type.
    Built in eval mode, like ``BatchNorm``."""

    def __init__(self, num_features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.eval()

    def forward(self, x, valid):
        in_dtype, x = x.dtype, x.float()
        if self.training:
            vf = valid.to(x.dtype)[:, None]
            n = vf.sum().clamp_min(1.0)
            mean = (x * vf).sum(dim=0) / n
            var = ((x - mean) ** 2 * vf).sum(dim=0) / n
            update_running_stats(self, mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(in_dtype)


class PFNLayer(nn.Module):
    def __init__(self, in_ch: int, features: int, use_norm: bool = True,
                 dtype=None):
        super().__init__()
        self.Dense_0 = Dense(in_ch, features, bias=not use_norm, dtype=dtype)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features) if use_norm else None

    def forward(self, x, valid):
        x = self.Dense_0(x)
        if self.MaskedBatchNorm_0 is not None:
            x = self.MaskedBatchNorm_0(x, valid)
        return torch.relu(x)


class PointPillarEncoder(nn.Module):
    # the pipeline decorates its points on the host (``from_points`` is the
    # raw path of a batch without the decorated fields)
    takes_raw_points = False

    def __init__(self, voxel_size: Tuple[float, float, float],
                 lidar_range: Tuple[float, ...], num_filters: Sequence[int] = (64,),
                 use_norm: bool = True, dtype=None):
        super().__init__()
        # the host decoration's grid (data/decorate.py) is this one
        self.voxel_size, self.lidar_range = tuple(voxel_size), tuple(lidar_range)
        self.nx = int(round((lidar_range[3] - lidar_range[0]) / voxel_size[0]))
        self.ny = int(round((lidar_range[4] - lidar_range[1]) / voxel_size[1]))
        in_ch = 10
        for i, f in enumerate(num_filters):
            self.add_module(f"PFNLayer_{i}", PFNLayer(in_ch, f, use_norm,
                                                      dtype))
            in_ch = f
        self.out_channels = in_ch

    def forward(self, decorated, gids, dvalid):
        """decorated (B, L, P, 10) fp32, gids (B, L, P) int32 sorted within
        each agent (invalid ids >= nx*ny), dvalid (B, L, P) bool ->
        canvas (B, L, ny, nx, C) bf16."""
        b, l, p, d = decorated.shape
        ncell = self.nx * self.ny
        x = decorated.reshape(b * l * p, d)
        valid = dvalid.reshape(b * l * p)
        for layer in self.children():
            x = layer(x, valid)
        rows = torch.where(valid[:, None], x, torch.zeros_like(x)).to(
            torch.bfloat16)
        flat_gids = gids.reshape(-1).clamp_max(ncell - 1).to(torch.int32)
        canvas = pillar_canvas(rows.contiguous(), flat_gids.contiguous(),
                               b * l, ncell)
        return canvas.reshape(b, l, self.ny, self.nx, x.shape[-1])

    def from_points(self, points, point_mask):
        """points (B, L, P, 4), point_mask (B, L, P) -> canvas (B, L, ny,
        nx, C) of the PFN's dtype: the JAX encoder's raw-point path."""
        b, l, p, d = points.shape
        x, gids, valid, _ = vox.pillar_decorate_flat(
            points.reshape(b * l, p, d), point_mask.reshape(b * l, p),
            self.lidar_range, self.voxel_size, self.nx, self.ny)
        for layer in self.children():
            x = layer(x, valid)
        canvas = vox.scatter_pillar_max_flat(x, gids, valid, b * l, self.nx,
                                             self.ny)
        return canvas.reshape(b, l, self.ny, self.nx, x.shape[-1])
