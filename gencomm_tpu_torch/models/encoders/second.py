"""SECOND encoder: MeanVFE -> VoxelBackBone8x -> height compression.

Counterpart of ``gencomm_tpu/models/encoders/second.py`` (``SubMConvBlock``,
``SpConvDownBlock``, ``SECONDEncoder``) on the port's sparse convolution
(``ops/sparse.py``). The channel and stride plan is VoxelBackBone8x's:
submanifold 16 x 2 -> strided 32 + submanifold x 2 -> strided 64 + x 2 ->
strided p(0, 1, 1) 64 + x 2 -> (3, 1, 1) s(2, 1, 1) ``out_ch``, each conv
followed by the masked batch norm (eps 1e-3, momentum 0.99, statistics over
the valid rows) and ReLU, with list capacities cap, cap, cap // 2, cap // 4
and cap // 4 for cap = ``voxel_capacity_per_agent`` x agent slots. The
final (D, H, W) volume is flattened to a BEV map of D x ``out_ch``
channels. The encoder has no dtype: it runs in fp32 under ``half`` too,
and the neck casts its map to bf16.

Parameter names are flax's: ``subm1_0`` .. ``subm4_1``, ``down2``,
``down3``, ``down4``, ``down_out``, each holding its ``kernel`` in flax's
(kz, ky, kx, Cin, Cout) layout and ``MaskedBatchNorm_0``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from gencomm_tpu_torch.models.encoders.point_pillar import MaskedBatchNorm
from gencomm_tpu_torch.ops import sparse as sp

POINT_FEATURES = 4  # x, y, z, intensity


class SubMConvBlock(nn.Module):
    FAN_IN_AXES = {"kernel": (0, 1, 2, 3)}

    def __init__(self, in_ch: int, out_ch: int,
                 kernel: Tuple[int, int, int] = (3, 3, 3)):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(*kernel, in_ch, out_ch))
        nn.init.normal_(self.kernel, std=(kernel[0] * kernel[1] * kernel[2]
                                          * in_ch) ** -0.5)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(out_ch)

    def forward(self, feats, coords, valid, grid, sorted_keys, sorted_idx):
        out = sp.subm_conv3d(feats, coords, valid, self.kernel, grid,
                             sorted_keys=sorted_keys, sorted_idx=sorted_idx)
        return torch.relu(self.MaskedBatchNorm_0(out, valid)) * valid[:, None]


class SpConvDownBlock(SubMConvBlock):
    """A strided sparse conv into a list of ``out_capacity`` sites."""

    def __init__(self, in_ch: int, out_ch: int, stride, padding,
                 kernel: Tuple[int, int, int] = (3, 3, 3)):
        super().__init__(in_ch, out_ch, kernel)
        self.stride, self.padding = tuple(stride), tuple(padding)

    def forward(self, feats, coords, valid, grid, out_capacity: int):
        out, ocoords, ovalid, ogrid = sp.spconv3d_downsample(
            feats, coords, valid, self.kernel, grid, self.stride,
            self.padding, out_capacity)
        out = torch.relu(self.MaskedBatchNorm_0(out, ovalid))
        return out * ovalid[:, None], ocoords, ovalid, ogrid


def _down_grid(grid, kernel, stride, padding):
    return tuple((grid[i] + 2 * padding[i] - kernel[i]) // stride[i] + 1
                 for i in range(3))


class SECONDEncoder(nn.Module):
    """Points (B, L, P, 4) with their mask -> BEV (B, L, H/8, W/8, D x
    out_ch), fp32. The list capacities follow the batch's B x L agent
    slots."""

    # the pipeline leaves its modality's raw points undecorated
    takes_raw_points = True

    def __init__(self, voxel_size: Tuple[float, float, float],
                 lidar_range: Tuple[float, ...],
                 voxel_capacity_per_agent: int = 32000, out_ch: int = 128):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.lidar_range = tuple(lidar_range)
        self.voxel_capacity_per_agent = voxel_capacity_per_agent
        # (name, out channels, stride, padding, kernel, capacity divisor)
        self.plan = (("down2", 32, (2, 2, 2), (1, 1, 1), (3, 3, 3), 1),
                     ("down3", 64, (2, 2, 2), (1, 1, 1), (3, 3, 3), 2),
                     ("down4", 64, (2, 2, 2), (0, 1, 1), (3, 3, 3), 4),
                     ("down_out", out_ch, (2, 1, 1), (0, 0, 0), (3, 1, 1), 4))
        ch = POINT_FEATURES
        for i in range(2):
            self.add_module(f"subm1_{i}", SubMConvBlock(ch, 16))
            ch = 16
        grid = self.grid
        for j, (name, out, stride, pad, kernel, _) in enumerate(self.plan):
            self.add_module(name, SpConvDownBlock(ch, out, stride, pad,
                                                  kernel))
            grid, ch = _down_grid(grid, kernel, stride, pad), out
            if name != "down_out":
                for i in range(2):
                    self.add_module(f"subm{j + 2}_{i}", SubMConvBlock(ch, ch))
        self.bev_grid = grid
        self.out_channels = grid[0] * out_ch

    @property
    def grid(self) -> Tuple[int, int, int]:
        """(nz + 1, ny, nx): spconv's sparse z extent is the grid's + 1, so
        points with z in [z_max, z_max + vz) are kept in plane nz."""
        r, v = self.lidar_range, self.voxel_size
        nx, ny, nz = (int(round((r[3 + i] - r[i]) / v[i])) for i in range(3))
        return (nz + 1, ny, nx)

    def _subm_stack(self, j, feats, coords, valid, grid):
        sorted_keys, sorted_idx = sp.build_index(
            sp.linear_key(coords, grid, valid))
        for i in range(2):
            feats = getattr(self, f"subm{j}_{i}")(feats, coords, valid, grid,
                                                  sorted_keys, sorted_idx)
        return feats

    def forward(self, points, point_mask):
        b, l, p, _ = points.shape
        cap = self.voxel_capacity_per_agent * b * l
        grid = self.grid
        feats, coords, valid = sp.voxelize_mean(
            points.reshape(b * l, p, -1).float(),
            point_mask.reshape(b * l, p), self.lidar_range, self.voxel_size,
            grid, cap)
        feats = self._subm_stack(1, feats, coords, valid, grid)
        for j, (name, _, _, _, _, div) in enumerate(self.plan):
            feats, coords, valid, grid = getattr(self, name)(
                feats, coords, valid, grid, cap // div)
            if name != "down_out":
                feats = self._subm_stack(j + 2, feats, coords, valid, grid)
        # height compression: (A, D, H, W, C) -> (B, L, H, W, D * C)
        dense = sp.scatter_to_dense(feats, coords, valid, grid, b * l)
        a, d, h, w, c = dense.shape
        return dense.permute(0, 2, 3, 1, 4).reshape(b, l, h, w, d * c)
