"""Lift-Splat-Shoot camera BEV encoder.

Counterpart of ``gencomm_tpu/models/encoders/lss.py`` (``bin_depth_indices``,
``ResBlock``, ``CamEncoder`` with the ``tpu`` patchify trunk, ``LSSEncoder``,
``center_crop_or_pad``): a frustum of (depth bin x feature pixel) points is
carried into the agent frame, the image trunk gives each feature pixel a
categorical depth distribution and a feature vector, and the splat sums
depth-weighted features into the BEV cells the frustum points fall in.

The splat always goes through ``ops.splat.splat_topk`` (kernels K4 and K4b
on the card): the top-K path with the K kept depth bins of each pixel, the
dense path (``depth_topk == 0``) with all D bins as K = D. The
``splat_impl`` key of the JAX package, which chooses between its
``segment_sum`` and its kernel, is accepted and ignored. ``splat_bf16``
follows the kernel's contract (bf16 product rows, fp32 sum; see
``ops/splat.py``). ``trunk_bf16`` runs the image trunk and its two 1x1
heads in bf16 (the images cast at entry) and casts the heads' outputs back
to fp32, so the splat gets fp32 depths and features. The
``efficientnet-b0`` and ``resnet101`` trunks are not ported yet and raise.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gencomm_tpu_torch.models.layers import BatchNorm, Conv, ConvBNReLU
from gencomm_tpu_torch.ops.splat import splat_topk
from gencomm_tpu_torch.utils.camera_utils import (
    depth_discretization, gen_dx_bx,
)


def bin_depth_indices(depth_map: torch.Tensor, mode: str, d_min: float,
                      d_max: float, num_bins: int) -> torch.Tensor:
    """Metric depth -> int32 depth-bin indices; out-of-range and non-finite
    depths are clamped into the valid bins."""
    if mode == "UD":
        bin_size = (d_max - d_min) / num_bins
        idx = (depth_map - d_min) / bin_size
    elif mode == "LID":
        bin_size = 2.0 * (d_max - d_min) / (num_bins * (1 + num_bins))
        idx = -0.5 + 0.5 * torch.sqrt(
            1.0 + 8.0 * (depth_map - d_min) / bin_size)
    else:
        raise NotImplementedError(mode)
    idx = torch.where(torch.isfinite(idx), idx,
                      torch.full_like(idx, float(num_bins - 1)))
    return idx.clamp(0, num_bins - 1).to(torch.int32)


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, ch: int, stride: int = 1, dtype=None):
        super().__init__()
        self.ConvBNReLU_0 = ConvBNReLU(in_ch, ch, 3, stride, dtype=dtype)
        self.Conv_0 = Conv(ch, ch, 3, bias=False, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(ch, dtype=dtype)
        self.Conv_1 = (Conv(in_ch, ch, 1, stride, bias=False, dtype=dtype)
                       if in_ch != ch or stride != 1 else None)

    def forward(self, x):
        h = self.BatchNorm_0(self.Conv_0(self.ConvBNReLU_0(x)))
        if self.Conv_1 is not None:
            x = self.Conv_1(x)
        return torch.relu(x + h)


class CamEncoder(nn.Module):
    """Images (N, H, W, 3) -> (depth distribution (N, fH, fW, D), features
    (N, fH, fW, C), depth logits) at stride 8. The patchify trunk: a 4x4
    stride-4 stem, ``trunk_blocks`` residual blocks at 128 channels,
    ``trunk_blocks`` at 256 (the first with stride 2) and a 3x3 conv to 512
    channels; two 1x1 heads. ``bf16``: the trunk and the heads in bf16,
    their outputs cast back to fp32."""

    def __init__(self, depth_bins: int, feat_ch: int, trunk_blocks: int = 2,
                 downsample: int = 8, bf16: bool = False, trunk: str = "tpu"):
        super().__init__()
        if trunk in ("efficientnet-b0", "resnet101"):
            raise NotImplementedError(
                f"img_trunk {trunk!r} is not ported yet (ROADMAP item 15); "
                "ported: 'tpu'")
        if trunk != "tpu":
            raise ValueError(f"unknown img_trunk {trunk!r}")
        if downsample != 8:
            raise ValueError("the tpu patchify trunk is stride-8 only; got "
                             f"img_downsample={downsample}")
        dt = torch.bfloat16 if bf16 else None
        self.dtype = dt
        self.ConvBNReLU_0 = ConvBNReLU(3, 64, kernel=4, stride=4, dtype=dt)
        chans = [(64, 128, 1)] + [(128, 128, 1)] * (trunk_blocks - 1)
        chans += [(128, 256, 2)] + [(256, 256, 1)] * (trunk_blocks - 1)
        for i, (cin, cout, stride) in enumerate(chans):
            self.add_module(f"ResBlock_{i}", ResBlock(cin, cout, stride, dt))
        self.num_blocks = len(chans)
        self.ConvBNReLU_1 = ConvBNReLU(256, 512, kernel=3, dtype=dt)
        self.depth_head = Conv(512, depth_bins, 1, dtype=dt)
        self.image_head = Conv(512, feat_ch, 1, dtype=dt)

    def forward(self, imgs):
        if self.dtype is not None:
            imgs = imgs.to(self.dtype)
        x = self.ConvBNReLU_0(imgs)
        for i in range(self.num_blocks):
            x = getattr(self, f"ResBlock_{i}")(x)
        x = self.ConvBNReLU_1(x)
        depth_logits = self.depth_head(x).float()
        # depth and features stay factored; the categorical-depth outer
        # product is only formed, sparsely, inside the splat
        return torch.softmax(depth_logits, dim=-1), \
            self.image_head(x).float(), depth_logits


class LSSEncoder(nn.Module):
    """Camera agents -> BEV features over the padded agent grid.

    ``camera_inputs`` holds ``imgs (B, L, Ncam, H, W, 3)``, ``rots`` /
    ``intrins`` / ``post_rots (B, L, Ncam, 3, 3)``, ``trans`` /
    ``post_trans (B, L, Ncam, 3)`` and optionally GT ``depths (B, L, Ncam,
    H, W)``. Returns ``(canvas (B, L, ny, nx, C * nz), depth_logits)``, or
    with GT depths ``(canvas, (depth_logits, gt_idx))``.
    """

    def __init__(self, grid_conf: Dict, final_dim: Sequence[int],
                 downsample: int = 8, feat_ch: int = 128,
                 trunk_blocks: int = 2, trunk: str = "tpu",
                 depth_topk: int = 0, trunk_bf16: bool = False,
                 splat_bf16: bool = False):
        super().__init__()
        self.grid_conf = grid_conf
        self.final_dim = tuple(final_dim)
        self.downsample = downsample
        self.depth_topk = depth_topk
        self.splat_bf16 = splat_bf16
        self.dx, self.bx, self.nx_grid = gen_dx_bx(
            grid_conf["xbound"], grid_conf["ybound"], grid_conf["zbound"])
        d_min, d_max, n_bins = grid_conf["ddiscr"]
        self.depth_centers = np.asarray(
            depth_discretization(d_min, d_max, n_bins, grid_conf["mode"]),
            np.float32)
        self.cam_encode = CamEncoder(
            depth_bins=len(self.depth_centers), feat_ch=feat_ch,
            trunk_blocks=trunk_blocks, bf16=trunk_bf16, trunk=trunk,
            downsample=downsample)
        self.out_channels = feat_ch * int(self.nx_grid[2])
        self.register_buffer("frustum", torch.from_numpy(self._frustum()),
                             persistent=False)

    def _frustum(self) -> np.ndarray:
        """(D, fH, fW, 3) image-plane points (u, v, depth)."""
        ogf_h, ogf_w = self.final_dim
        fh, fw = ogf_h // self.downsample, ogf_w // self.downsample
        d = len(self.depth_centers)
        ds = np.broadcast_to(self.depth_centers[:, None, None], (d, fh, fw))
        xs = np.broadcast_to(
            np.linspace(0, ogf_w - 1, fw, dtype=np.float32)[None, None, :],
            (d, fh, fw))
        ys = np.broadcast_to(
            np.linspace(0, ogf_h - 1, fh, dtype=np.float32)[None, :, None],
            (d, fh, fw))
        return np.stack([xs, ys, ds], axis=-1)

    def _geometry(self, rots, trans, intrins, post_rots, post_trans):
        """(A, N, D, fH, fW, 3) agent-frame xyz of every frustum point.
        ``inv_ex`` gives ``inv``'s values without its check for singular
        matrices, which reads a flag on the host (and so cannot be captured
        in a CUDA graph)."""
        pts = self.frustum[None, None] - post_trans[:, :, None, None, None, :]
        pts = torch.einsum("anij,andhwj->andhwi",
                           torch.linalg.inv_ex(post_rots).inverse, pts)
        # (u, v, d) -> (du, dv, d)
        pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], dim=-1)
        combine = rots @ torch.linalg.inv_ex(intrins).inverse
        pts = torch.einsum("anij,andhwj->andhwi", combine, pts)
        return pts + trans[:, :, None, None, None, :]

    def forward(self, camera_inputs: Dict[str, torch.Tensor]):
        imgs = camera_inputs["imgs"]
        b, l, n, h, w, _ = imgs.shape
        a = b * l

        def flat(x):
            return x.reshape((a,) + x.shape[2:]).to(torch.float32)

        geom = self._geometry(*(flat(camera_inputs[k]) for k in (
            "rots", "trans", "intrins", "post_rots", "post_trans")))
        depth, feats, depth_logits = self.cam_encode(
            imgs.reshape(a * n, h, w, 3))
        d_bins = len(self.depth_centers)
        fh, fw = h // self.downsample, w // self.downsample
        canvas = self.splat(geom, depth.reshape(a, n, fh, fw, d_bins),
                            feats.reshape(a, n, fh, fw, -1))
        out = canvas.reshape((b, l) + canvas.shape[1:])
        depth_logits = depth_logits.reshape(b, l, n, fh, fw, d_bins)
        if "depths" in camera_inputs:
            # GT depth maps (B, L, N, H, W): the centre sample of every
            # downsample x downsample patch, binned, pairs with the logits
            # for the depth loss
            ds = self.downsample
            d_min, d_max, n_bins = self.grid_conf["ddiscr"]
            gt = camera_inputs["depths"][..., ds // 2::ds, ds // 2::ds]
            gt_idx = bin_depth_indices(
                gt.clamp_max(float(d_max)), self.grid_conf["mode"],
                float(d_min), float(d_max), int(n_bins))
            return out, (depth_logits, gt_idx)
        return out, depth_logits

    def cell_ids(self, geom):
        """Flat canvas cell of every frustum point, (A, N, D, fH, fW) int64
        in the per-agent (z, y, x) layout, and whether it lies in the grid."""
        nx, ny, nz = (int(v) for v in self.nx_grid)
        g = [torch.floor((geom[..., i] - float(self.bx[i] - self.dx[i] / 2))
                         / float(self.dx[i])).long() for i in range(3)]
        inb = ((g[0] >= 0) & (g[0] < nx) & (g[1] >= 0) & (g[1] < ny)
               & (g[2] >= 0) & (g[2] < nz))
        return (g[2] * ny + g[1]) * nx + g[0], inb

    def select_topk(self, depth, cell, inb):
        """The K most probable depth bins of every pixel, by K argmax passes
        (first index on ties), renormalised to sum to 1 (floor 1e-6), with
        their cells. depth (A, N, fH, fW, D); cell, inb (A, N, D, fH, fW).
        Returns dvals, cell_k, inb_k, each (A, N, fH, fW, K). With
        ``depth_topk == 0`` all D bins are kept as they are."""
        cell_px = cell.permute(0, 1, 3, 4, 2)
        inb_px = inb.permute(0, 1, 3, 4, 2)
        if self.depth_topk <= 0:
            return depth, cell_px, inb_px
        picks = self.topk_picks(depth)
        dvals = depth.gather(-1, picks)
        dvals = dvals / dvals.sum(dim=-1, keepdim=True).clamp_min(1e-6)
        return dvals, cell_px.gather(-1, picks), inb_px.gather(-1, picks)

    def topk_picks(self, depth):
        """The bins ``select_topk`` keeps, (A, N, fH, fW, K) int64, most
        probable first: K argmax passes, the first index on ties."""
        remaining, picks = depth.detach(), []
        for _ in range(min(self.depth_topk, depth.shape[-1])):
            idx = remaining.argmax(dim=-1, keepdim=True)
            picks.append(idx)
            remaining = remaining.scatter(-1, idx, float("-inf"))
        return torch.cat(picks, dim=-1)

    def splat(self, geom, depth, feats):
        """Categorical-depth splat: geometry (A, N, D, fH, fW, 3), depth
        (A, N, fH, fW, D) and features (A, N, fH, fW, C) -> BEV canvas
        (A, ny, nx, C * nz). No parameters."""
        a = geom.shape[0]
        nx, ny, nz = (int(v) for v in self.nx_grid)
        per_agent = nz * ny * nx
        dvals, cell_k, inb_k = self.select_topk(depth, *self.cell_ids(geom))
        k = dvals.shape[-1]
        agent = torch.arange(a, device=geom.device).reshape(a, 1, 1, 1, 1)
        ids = torch.where(inb_k, agent * per_agent + cell_k,
                          torch.full_like(cell_k, a * per_agent))
        canvas = splat_topk(
            dvals.reshape(-1, k).contiguous(),
            feats.reshape(-1, feats.shape[-1]).contiguous(),
            ids.reshape(-1, k).to(torch.int32).contiguous(), a * per_agent,
            self.splat_bf16)
        canvas = canvas.reshape(a, nz, ny, nx, -1)
        # collapse z by channel concatenation (nz = 1 in the OPV2V configs)
        return torch.cat([canvas[:, i] for i in range(nz)], dim=-1)


def center_crop_or_pad(x: torch.Tensor, target_hw: Tuple[int, int]):
    """Center crop or zero-pad the spatial dims of (..., H, W, C) to
    ``target_hw`` (torchvision ``CenterCrop`` semantics), the camera ->
    lidar range alignment."""
    h, w = x.shape[-3], x.shape[-2]
    th, tw = target_hw
    ph, pw = max(th - h, 0), max(tw - w, 0)
    if ph or pw:
        x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        h, w = x.shape[-3], x.shape[-2]
    oh, ow = (h - th) // 2, (w - tw) // 2
    return x[..., oh:oh + th, ow:ow + tw, :]
