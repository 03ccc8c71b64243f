"""Affine BEV feature warp: kernels K3 (forward) and K3b (backward) and
their plain versions.

Counterpart of ``gencomm_tpu/ops/warp.py`` (the gather warp) and
``gencomm_tpu/ops/warp_pallas.py`` (``warp_affine_mxu``, the TPU kernel,
whose VJP differentiates the gather). Bilinear sampling with zero padding
in torch ``affine_grid`` convention (align_corners=False), NHWC, output
H x W equal to the input's. The backward scatters each output cotangent
into the four source corners with their bilinear weights; theta gets no
gradient (it comes from poses), and a theta that requires one is refused.
"""

from __future__ import annotations

import torch

from gencomm_tpu_torch.ops import _cuda


def _sample_grid(theta: torch.Tensor, n: int, h: int, w: int):
    """Source coordinates of every output pixel: floor corners (x0, y0) and
    bilinear factors (wx0, wx1, wy0, wy1), (N, H, W) each, in fp32 and
    never rounded to a pixel."""
    dev = theta.device
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
    return x0, y0, 1.0 - wx1, wx1, 1.0 - wy1, wy1


def _corners(n: int, h: int, w: int, theta: torch.Tensor):
    """(flat source index into (N*H*W, C), clamped; in-map mask; bilinear
    weight) of the corners (x0,y0), (x1,y0), (x0,y1), (x1,y1)."""
    x0, y0, wx0, wx1, wy0, wy1 = _sample_grid(theta, n, h, w)
    bidx = torch.arange(n, device=theta.device)[:, None, None] * (h * w)
    out = []
    for k in range(4):
        ix, iy = x0 + (k & 1), y0 + (k >> 1)
        inb = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        idx = bidx + (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).long()
        wgt = (wx1 if k & 1 else wx0) * (wy1 if k >> 1 else wy0)
        out.append((idx, inb, wgt))
    return out


def warp_affine_plain(src: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """src (N, H, W, C), theta (N, 2, 3) -> (N, H, W, C): the four-corner
    gather."""
    n, h, w, c = src.shape
    flat = src.reshape(n * h * w, c)
    return sum(flat[idx] * (wgt * inb)[..., None].to(src.dtype)
               for idx, inb, wgt in _corners(n, h, w, theta))


def warp_affine_bwd_plain(g: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """d src (N, H, W, C) for the output cotangent g (N, H, W, C): the
    four-corner scatter-add, nothing from samples outside the source."""
    n, h, w, c = g.shape
    dflat = torch.zeros(n * h * w, c, dtype=g.dtype, device=g.device)
    for idx, inb, wgt in _corners(n, h, w, theta):
        dflat.index_add_(0, idx.reshape(-1), (
            g * (wgt * inb)[..., None].to(g.dtype)).reshape(-1, c))
    return dflat.reshape(n, h, w, c)


def _check_args(t, theta, name):
    n = t.shape[0]
    _cuda.check_cuda_tensor(t, name, torch.float32)
    _cuda.check_cuda_tensor(theta, "theta", torch.float32, (n, 2, 3))
    return t.shape


def warp_affine_fwd(src: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """The forward of ``warp_affine`` without autograd: the plain version
    for a CPU tensor, kernel K3 for a CUDA tensor."""
    if not src.is_cuda:
        return warp_affine_plain(src, theta)
    n, h, w, c = _check_args(src, theta, "src")
    out = torch.empty_like(src)
    _cuda.launch("warp_affine", src.data_ptr(), theta.data_ptr(),
                 out.data_ptr(), n, h, w, c)
    _cuda.LAUNCHES["warp_affine"] += 1
    return out


def warp_affine_bwd(g: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """d src for the cotangent g: the plain version for a CPU tensor,
    kernel K3b for a CUDA tensor."""
    if not g.is_cuda:
        return warp_affine_bwd_plain(g, theta)
    n, h, w, c = _check_args(g, theta, "g")
    dsrc = torch.empty_like(g)
    _cuda.launch("warp_affine_bwd", g.data_ptr(), theta.data_ptr(),
                 dsrc.data_ptr(), n, h, w, c)
    _cuda.LAUNCHES["warp_affine_bwd"] += 1
    return dsrc


class _WarpAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, theta):
        ctx.save_for_backward(theta)
        return warp_affine_fwd(src, theta)

    @staticmethod
    def backward(ctx, g):
        (theta,) = ctx.saved_tensors
        return warp_affine_bwd(g.contiguous(), theta), None


def warp_affine(src: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Exact bilinear affine warp. src (N, H, W, C) fp32, theta (N, 2, 3)
    fp32 -> (N, H, W, C). A CPU tensor takes the plain versions; a CUDA
    tensor launches K3 and, in the backward, K3b. theta must not require a
    gradient."""
    if theta.requires_grad and torch.is_grad_enabled():
        raise ValueError("warp_affine gives theta no gradient; pass a theta "
                         "that does not require one")
    return _WarpAffine.apply(src, theta)
