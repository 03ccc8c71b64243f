"""Where2comm: confidence-masked communication and per-pixel multi-head
attention fusion.

Counterpart of ``gencomm_tpu/models/fuse/where2comm.py`` (``gaussian_kernel``,
``Communication``, ``Where2commFusion``; ``where2comm_multi_scale`` belongs
to the CenterPoint core and is not ported):

- ``Communication``: each agent's confidence is the max over anchors of the
  sigmoid of the shared head's class map, smoothed by a 5 x 5 Gaussian with
  zero "SAME" padding; cells above ``thre`` are sent, the ego's always. The
  rate is the share of sent cells over the whole batch's valid neighbours.
- ``Where2commFusion``: per pixel, the ego queries every warped agent
  through 8-head attention, then residual + LayerNorm, a ReLU MLP and
  residual + LayerNorm. Its projections keep flax's ``DenseGeneral``
  layouts: ``q_proj`` / ``k_proj`` / ``v_proj`` ``kernel`` (C, heads, d)
  with ``bias`` (heads, d); ``out_proj`` ``kernel`` (heads, d, C) with
  ``bias`` (C,).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gencomm_tpu_torch.models.fuse.fusion import _masked, warp_to_ego
from gencomm_tpu_torch.models.layers import Dense, LayerNorm, sigmoid, softmax


def gaussian_kernel(k_size: int = 5, sigma: float = 1.0) -> np.ndarray:
    """The JAX package's numpy helper, copied."""
    center = k_size // 2
    x, y = np.mgrid[-center: k_size - center, -center: k_size - center]
    g = 1 / (2 * np.pi * sigma) * np.exp(-(x ** 2 + y ** 2) / (2 * sigma ** 2))
    return g.astype(np.float32)


class Communication(nn.Module):
    """confidence maps (B, L, H, W, A) and agent_mask (B, L) -> (masks (B,
    L, H, W, 1), rate). No parameters; the Gaussian is a buffer outside the
    state_dict."""

    def __init__(self, thre: float = 0.01, smooth: bool = True,
                 kernel_size: int = 5, c_sigma: float = 1.0):
        super().__init__()
        self.thre, self.smooth, self.kernel_size = thre, smooth, kernel_size
        self.register_buffer("gaussian", torch.from_numpy(
            gaussian_kernel(kernel_size, c_sigma))[None, None],
            persistent=False)

    def forward(self, confidence_maps, agent_mask):
        b, l, h, w, _ = confidence_maps.shape
        conf = sigmoid(confidence_maps).amax(dim=-1, keepdim=True)
        if self.smooth:
            conf = F.conv2d(conf.reshape(b * l, 1, h, w),
                            self.gaussian.to(conf.dtype),
                            padding=self.kernel_size // 2).reshape(b, l, h, w, 1)
        mask = (conf > self.thre).to(conf.dtype)
        mask[:, 0] = 1.0  # the ego's own map is never masked
        valid = agent_mask[:, :, None, None, None].to(conf.dtype)
        n_neighbors = agent_mask[:, 1:].sum().clamp_min(1)
        rate = (mask[:, 1:] * valid[:, 1:]).sum() / (h * w * n_neighbors)
        return mask, rate


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral`` over the last ``n_in`` axes into the
    ``out_shape`` axes, parameters in flax's layout: ``kernel`` (*in,
    *out), ``bias`` (*out)."""

    def __init__(self, in_shape, out_shape):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        n_in = int(np.prod(self.in_shape))
        self.kernel = nn.Parameter(
            torch.randn(self.in_shape + self.out_shape) * n_in ** -0.5)
        self.bias = nn.Parameter(torch.zeros(self.out_shape))
        self.FAN_IN_AXES = {"kernel": tuple(range(len(self.in_shape)))}

    def forward(self, x):
        # flax promotes a bf16 input and the fp32 parameters to fp32
        dt = torch.promote_types(x.dtype, self.kernel.dtype)
        lead = x.shape[:x.dim() - len(self.in_shape)]
        k = self.kernel.reshape(int(np.prod(self.in_shape)), -1).to(dt)
        y = x.to(dt).reshape(lead + (-1,)) @ k + self.bias.reshape(-1).to(dt)
        return y.reshape(lead + self.out_shape)


class Where2commFusion(nn.Module):
    """Per-pixel multi-head attention: the ego pixel queries the warped
    agents. ``feat_dim`` is the config's, held and unused as in the JAX
    package (the channels are the input's)."""

    def __init__(self, in_ch: int, feat_dim: int | None = None,
                 n_head: int = 8):
        super().__init__()
        self.feat_dim, self.n_head = feat_dim, n_head
        d = in_ch // n_head
        for name in ("q_proj", "k_proj", "v_proj"):
            self.add_module(name, DenseGeneral((in_ch,), (n_head, d)))
        self.out_proj = DenseGeneral((n_head, d), (in_ch,))
        self.norm1 = LayerNorm(in_ch)
        self.linear1 = Dense(in_ch, in_ch)
        self.linear2 = Dense(in_ch, in_ch)
        self.norm2 = LayerNorm(in_ch)

    def forward(self, x, affine, agent_mask):
        w = warp_to_ego(x, affine)  # (B, L, H, W, C)
        b, l, hh, ww, c = w.shape
        d = c // self.n_head
        kv = w.permute(0, 2, 3, 1, 4).reshape(b, hh * ww, l, c)
        qq = w[:, 0].reshape(b, hh * ww, 1, c)
        qp, kp, vp = self.q_proj(qq), self.k_proj(kv), self.v_proj(kv)
        scores = torch.einsum("bpqhd,bplhd->bphql", qp, kp) / math.sqrt(d)
        scores = _masked(scores, agent_mask[:, None, None, None, :])
        ctx = torch.einsum("bphql,bplhd->bpqhd", softmax(scores, dim=-1), vp)
        out1 = self.norm1(qq + self.out_proj(ctx))
        ff = self.linear2(torch.relu(self.linear1(out1)))
        return self.norm2(out1 + ff).reshape(b, hh, ww, c)
