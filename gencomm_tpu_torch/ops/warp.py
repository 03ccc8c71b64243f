"""Affine BEV feature warp: kernel K3 and its plain version.

Counterpart of ``gencomm_tpu/ops/warp.py`` (the gather warp) and
``gencomm_tpu/ops/warp_pallas.py`` (``warp_affine_mxu``, the TPU kernel).
Bilinear sampling with zero padding in torch ``affine_grid`` convention
(align_corners=False), NHWC, output H x W equal to the input's. Forward
only: the backward comes with training.
"""

from __future__ import annotations

import torch

from gencomm_tpu_torch.ops import _cuda


def warp_affine_plain(src: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """src (N, H, W, C), theta (N, 2, 3) -> (N, H, W, C): the four-corner
    gather. Coordinates stay in fp32 and are never rounded to a pixel."""
    n, h, w, c = src.shape
    dev = src.device
    ys = (2.0 * torch.arange(h, dtype=torch.float32, device=dev) + 1.0) / h - 1.0
    xs = (2.0 * torch.arange(w, dtype=torch.float32, device=dev) + 1.0) / w - 1.0
    gy, gx = ys[None, :, None], xs[None, None, :]
    th = theta.to(torch.float32)[:, :, :, None, None]  # (N, 2, 3, 1, 1)
    sx = th[:, 0, 0] * gx + th[:, 0, 1] * gy + th[:, 0, 2]  # (N, H, W)
    sy = th[:, 1, 0] * gx + th[:, 1, 1] * gy + th[:, 1, 2]
    x = (sx + 1.0) * w / 2.0 - 0.5
    y = (sy + 1.0) * h / 2.0 - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    flat = src.reshape(n, h * w, c)
    bidx = torch.arange(n, device=dev)[:, None, None]

    def corner(ix, iy, wgt):
        inb = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).long()
        return flat[bidx, idx] * (wgt * inb)[..., None].to(src.dtype)

    return (corner(x0, y0, wx0 * wy0) + corner(x0 + 1, y0, wx1 * wy0)
            + corner(x0, y0 + 1, wx0 * wy1) + corner(x0 + 1, y0 + 1, wx1 * wy1))


def warp_affine(src: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Exact bilinear affine warp. src (N, H, W, C) fp32, theta (N, 2, 3)
    fp32 -> (N, H, W, C). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel."""
    if not src.is_cuda:
        return warp_affine_plain(src, theta)
    n, h, w, c = src.shape
    _cuda.check_cuda_tensor(src, "src", torch.float32)
    _cuda.check_cuda_tensor(theta, "theta", torch.float32, (n, 2, 3))
    out = torch.empty_like(src)
    _cuda.launch("warp_affine", src.data_ptr(), theta.data_ptr(),
                 out.data_ptr(), n, h, w, c)
    _cuda.LAUNCHES["warp_affine"] += 1
    return out

