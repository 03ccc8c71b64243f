"""Deformable 3x3 convolution: kernel K1 and its plain version.

Counterpart of ``gencomm_tpu/ops/deform.py`` (the gather formulation) and
``gencomm_tpu/ops/deform_pallas.py`` (``deform_conv3x3_mxu``, the TPU
kernel). Stride 1, padding 1, bilinear sampling with zero padding,
torchvision (dy, dx)-per-tap offset layout. Offsets are clamped to
±``MAX_OFFSET`` by the caller (``deform_conv3x3_clamped``), as on the TPU.
Forward only: the backward (K1b) comes with training.
"""

from __future__ import annotations

import torch

from gencomm_tpu_torch.ops import _cuda

MAX_OFFSET = 4  # px, the clamp of gencomm_tpu/ops/deform_pallas.py


def deform_conv3x3_plain(x: torch.Tensor, offsets: torch.Tensor,
                         weight: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, Cin), offsets (B, H, W, 18), weight (3, 3, Cin, Cout) ->
    (B, H, W, Cout): bilinear gathers of the 9 taps, then one matmul."""
    b, h, w, cin = x.shape
    cout = weight.shape[-1]
    dev, dt = x.device, x.dtype
    off = offsets.reshape(b, h, w, 9, 2)
    base_y = torch.arange(h, dtype=dt, device=dev)[None, :, None, None]
    base_x = torch.arange(w, dtype=dt, device=dev)[None, None, :, None]
    k = torch.arange(9, device=dev)
    tap_y = (k // 3 - 1).to(dt)
    tap_x = (k % 3 - 1).to(dt)
    y = base_y + tap_y + off[..., 0]  # (B, H, W, 9)
    xx = base_x + tap_x + off[..., 1]
    y0, x0 = torch.floor(y), torch.floor(xx)
    wy1, wx1 = y - y0, xx - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    flat = x.reshape(b, h * w, cin)
    bidx = torch.arange(b, device=dev)[:, None, None, None]

    def corner(iy, ix, wgt):
        inb = (iy >= 0) & (iy <= h - 1) & (ix >= 0) & (ix <= w - 1)
        idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).long()
        return flat[bidx, idx] * (wgt * inb)[..., None]

    samples = (corner(y0, x0, wy0 * wx0) + corner(y0, x0 + 1, wy0 * wx1)
               + corner(y0 + 1, x0, wy1 * wx0)
               + corner(y0 + 1, x0 + 1, wy1 * wx1))  # (B, H, W, 9, Cin)
    return samples.reshape(b, h, w, 9 * cin) @ weight.reshape(9 * cin, cout)


def deform_conv3x3(x: torch.Tensor, offsets: torch.Tensor,
                   weight: torch.Tensor) -> torch.Tensor:
    """Deformable 3x3 conv without bias. x (B, H, W, Cin) fp32, offsets
    (B, H, W, 18) fp32, weight (3, 3, Cin, Cout) fp32 -> (B, H, W, Cout).
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel."""
    if not x.is_cuda:
        return deform_conv3x3_plain(x, offsets, weight)
    b, h, w, cin = x.shape
    cout = weight.shape[-1]
    _cuda.check_cuda_tensor(x, "x", torch.float32)
    _cuda.check_cuda_tensor(offsets, "offsets", torch.float32, (b, h, w, 18))
    _cuda.check_cuda_tensor(weight, "weight", torch.float32, (3, 3, cin, cout))
    out = torch.empty(b, h, w, cout, dtype=torch.float32, device=x.device)
    _cuda.launch("deform_conv", x.data_ptr(), offsets.data_ptr(),
                 weight.data_ptr(), out.data_ptr(), b, h, w, cin, cout)
    _cuda.LAUNCHES["deform_conv3x3"] += 1
    return out


def deform_conv3x3_clamped(x, offsets, weight, bias=None):
    """The message extractor's call: clamp offsets to ±MAX_OFFSET, run the
    deformable conv, add the bias (gencomm_tpu deform_conv3x3_auto)."""
    out = deform_conv3x3(x, offsets.clamp(-MAX_OFFSET, MAX_OFFSET).contiguous(),
                         weight)
    return out + bias if bias is not None else out
