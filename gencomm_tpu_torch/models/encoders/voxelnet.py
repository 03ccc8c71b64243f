"""VoxelNet encoder on raw points.

Counterpart of ``gencomm_tpu/models/encoders/voxelnet.py``: points get 3D
voxel ids (``(iz * ny + iy) * nx + ix``, an agent's block of ``nx * ny *
nz`` cells, the last id the dump of an invalid point), are decorated with
their voxel's cluster offset (7 dims: xyzi, xyz - voxel mean), pass two VFE
layers (a Linear without bias, the masked batch norm on its running
statistics, ReLU, and the voxel's max broadcast back and concatenated),
are max-reduced onto the dense ``(nz, ny, nx, C)`` grid, and three Conv3D
middle layers of ``mid_ch`` channels (kernel 3, padding 1, z-strides 2 / 1
/ 2, no bias, each with a batch norm and ReLU) run on it; the remaining z
planes are stacked onto the channels of a BEV map. fp32, as the JAX encoder
has no dtype.

The voxel sums and maxima are ``ops/voxel.py``'s (a sequential segment sum,
``scatter_reduce`` amax; no kernel of the port takes fp32 rows). The Conv3D
layers run on cuDNN in channels-last 3D memory, so the NDHWC grid reaches
them without a copy. Parameter names are flax's: ``vfe_<f>`` (``Dense_0``,
``MaskedBatchNorm_0``), ``mid_<i>`` holding its ``kernel`` in flax's (kz,
ky, kx, Cin, Cout) layout, and ``BatchNorm_<i>``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gencomm_tpu_torch.models.encoders.point_pillar import MaskedBatchNorm
from gencomm_tpu_torch.models.layers import BatchNorm, Dense
from gencomm_tpu_torch.ops import voxel as vox
from gencomm_tpu_torch.ops.sparse import segment_sum_sorted, voxel_index

MIDDLE_Z_STRIDES = (2, 1, 2)


class _RunningStatsNorm(MaskedBatchNorm):
    """The VFE layer's masked batch norm: the JAX layer calls it with
    ``train=False``, so it reads its running statistics in training too."""

    def train(self, mode: bool = True):
        return super().train(False)


class VFELayer(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.Dense_0 = Dense(in_ch, out_ch // 2, bias=False)
        self.MaskedBatchNorm_0 = _RunningStatsNorm(out_ch // 2)

    def forward(self, x, gids, valid, num_segments: int):
        h = torch.relu(self.MaskedBatchNorm_0(self.Dense_0(x), valid))
        seg = gids.long()
        vmax = vox.segment_max(h, seg, valid, num_segments)
        return torch.cat([h, vmax[seg]], dim=-1) * valid[:, None]


class Conv3d(nn.Module):
    """A 3D convolution without bias on NDHWC maps; ``kernel`` in flax's
    (kz, ky, kx, Cin, Cout) layout."""

    FAN_IN_AXES = {"kernel": (0, 1, 2, 3)}

    def __init__(self, in_ch: int, out_ch: int, stride: Tuple[int, int, int]):
        super().__init__()
        self.stride = tuple(stride)
        self.kernel = nn.Parameter(torch.empty(3, 3, 3, in_ch, out_ch))
        nn.init.normal_(self.kernel, std=(27 * in_ch) ** -0.5)

    def forward(self, x):
        # an NDHWC tensor permuted to NCDHW is channels-last 3D memory
        y = F.conv3d(x.permute(0, 4, 1, 2, 3),
                     self.kernel.permute(4, 3, 0, 1, 2), None, self.stride, 1)
        return y.permute(0, 2, 3, 4, 1)


class VoxelNetEncoder(nn.Module):
    """Points (B, L, P, 4) with their mask -> BEV (B, L, ny, nx, dz *
    mid_ch), fp32."""

    # the pipeline leaves its modality's raw points undecorated
    takes_raw_points = True

    def __init__(self, voxel_size: Tuple[float, float, float],
                 lidar_range: Tuple[float, ...],
                 vfe_filters: Sequence[int] = (32, 128), mid_ch: int = 64):
        super().__init__()
        self.voxel_size, self.lidar_range = tuple(voxel_size), tuple(lidar_range)
        r, v = self.lidar_range, self.voxel_size
        self.nx, self.ny, self.nz = (int(round((r[3 + i] - r[i]) / v[i]))
                                     for i in range(3))
        ch = 7
        for f in vfe_filters:
            self.add_module(f"vfe_{f}", VFELayer(ch, f))
            ch = f
        self.vfe_filters = tuple(vfe_filters)
        dz = self.nz
        for i, sz in enumerate(MIDDLE_Z_STRIDES):
            self.add_module(f"mid_{i}", Conv3d(ch, mid_ch, (sz, 1, 1)))
            self.add_module(f"BatchNorm_{i}", BatchNorm(mid_ch))
            ch, dz = mid_ch, (dz - 1) // sz + 1
        self.out_channels = dz * mid_ch

    def forward(self, points, point_mask):
        b, l, p, d = points.shape
        nx, ny, nz = self.nx, self.ny, self.nz
        ncell = nx * ny * nz
        pts = points.reshape(b * l * p, d)
        r, v = self.lidar_range, self.voxel_size
        ix, iy, iz = (voxel_index(pts[:, i], r[i], v[i]) for i in range(3))
        inb = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & (iz >= 0)
               & (iz < nz))
        valid = inb & point_mask.reshape(-1).bool()
        agent = torch.arange(b * l, dtype=torch.int32,
                             device=points.device).repeat_interleave(p)
        cell = (iz * ny + iy) * nx + ix
        gids = torch.where(valid, agent * ncell + cell.clamp(0, ncell - 1),
                           torch.full_like(cell, b * l * ncell))
        nseg = b * l * ncell + 1

        # decorate: xyzi and the offset from the voxel's mean
        vf = valid[:, None].to(pts.dtype)
        sums4 = segment_sum_sorted(
            torch.cat([pts[:, :3], torch.ones_like(vf)], -1) * vf,
            gids.long(), nseg)
        mean = sums4[:, :3] / sums4[:, 3:4].clamp_min(1.0)
        feat = torch.cat([pts, pts[:, :3] - mean[gids.long()]], -1) * vf
        for f in self.vfe_filters:
            feat = getattr(self, f"vfe_{f}")(feat, gids, valid, nseg)
        # the voxel's feature: the max over its points
        h = vox.segment_max(feat, gids.long(), valid, b * l * ncell).reshape(
            b * l, nz, ny, nx, -1)
        for i in range(len(MIDDLE_Z_STRIDES)):
            h = torch.relu(getattr(self, f"BatchNorm_{i}")(
                getattr(self, f"mid_{i}")(h)))
        # the remaining z planes onto the channels
        bl, dz, hy, wx, c = h.shape
        return h.permute(0, 2, 3, 1, 4).reshape(b, l, hy, wx, dz * c)
