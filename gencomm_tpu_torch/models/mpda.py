"""MPDA: multi-modal perception domain adaption.

Counterpart of ``gencomm_tpu/models/mpda.py``:

- ``LearnableResizer``: a 1x1 channel selector, a window + grid
  self-attention encoder (``WindowGridEncoder``), a bilinear resize to the
  ego's (H, W), two leaky residual blocks, a second window + grid encoder
  and the resized selector output added back;
- ``CrossDomainFusionEncoder``: per depth a window cross-attention (queries
  from the collaborator, keys and values from the ego) and a grid
  cross-attention, each followed by a pre-normed MLP, then a post-norm;
  a LayerNorm and a Linear head;
- ``DAImgHead``: per-pixel domain logits behind ``gradient_scale``, which
  passes its input forward and multiplies its gradient by the GRL weight
  (-9.1), so the features are trained to fool the domain classifier.

Windows and grids are the JAX package's reshapes (``_window_part``,
``_grid_part``); H and W must be divisible by the window size. The MLPs'
GELU is flax's tanh approximation (``layers.gelu``). ``rel_pos_bias``
((2 ws - 1)^2, heads) keeps flax's layout.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gencomm_tpu_torch.models.layers import (
    BatchNorm, Conv, Dense, LayerNorm, gelu, resize_bilinear,
)

GRL_WEIGHT = -9.1


class _GradientScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight):
        ctx.weight = weight
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.weight * g, None


def gradient_scale(x: torch.Tensor, weight: float) -> torch.Tensor:
    """x forward; the gradient times ``weight`` backward."""
    return _GradientScale.apply(x, weight)


def _window_part(a, ws):
    """(N, H, W, C) -> (N*hh*ww, ws*ws, C), local windows."""
    n, h, w, c = a.shape
    hh, ww = h // ws, w // ws
    a = a.reshape(n, hh, ws, ww, ws, c).permute(0, 1, 3, 2, 4, 5)
    return a.reshape(n * hh * ww, ws * ws, c)


def _window_unpart(a, n, h, w, ws):
    c = a.shape[-1]
    hh, ww = h // ws, w // ws
    a = a.reshape(n, hh, ww, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return a.reshape(n, h, w, c)


def _grid_part(a, ws):
    """(N, H, W, C) -> (N*hh*ww, ws*ws, C), dilated (grid) windows."""
    n, h, w, c = a.shape
    hh, ww = h // ws, w // ws
    a = a.reshape(n, ws, hh, ws, ww, c).permute(0, 2, 4, 1, 3, 5)
    return a.reshape(n * hh * ww, ws * ws, c)


def _grid_unpart(a, n, h, w, ws):
    c = a.shape[-1]
    hh, ww = h // ws, w // ws
    a = a.reshape(n, hh, ww, ws, ws, c).permute(0, 3, 1, 4, 2, 5)
    return a.reshape(n, h, w, c)


def _rel_pos_index(ws):
    """(ws^2, ws^2) index into the (2ws-1)^2 bias table, pos_i - pos_j +
    ws - 1 (the JAX package's numpy helper, copied)."""
    pos = np.stack(
        np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")
    ).reshape(2, -1)
    rel = pos[:, :, None] - pos[:, None, :] + ws - 1
    return rel[0] * (2 * ws - 1) + rel[1]


def _check_windows(h, w, ws):
    if h % ws or w % ws:
        raise ValueError(f"MPDA's windows of {ws} do not divide the "
                         f"{h} x {w} map")


def _heads(a, heads, dim_head):
    return a.reshape(a.shape[0], a.shape[1], heads, dim_head).permute(
        0, 2, 1, 3)


class WindowMHSA(nn.Module):
    """MaxViT window (or, with ``grid``, grid) attention: packed bias-free
    QKV, the relative-position bias, a bias-free output projection."""

    PARAM_STD = {"rel_pos_bias": 0.02}  # flax's normal(0.02)

    def __init__(self, dim: int, dim_head: int = 32, window_size: int = 8,
                 grid: bool = False):
        super().__init__()
        self.dim, self.dim_head, self.ws, self.grid = (
            dim, dim_head, window_size, grid)
        self.heads = dim // dim_head
        self.to_qkv = Dense(dim, dim * 3, bias=False)
        self.rel_pos_bias = nn.Parameter(
            0.02 * torch.randn((2 * window_size - 1) ** 2, self.heads))
        self.to_out = Dense(dim, dim, bias=False)
        self.register_buffer("rel_index", torch.from_numpy(
            _rel_pos_index(window_size)), persistent=False)

    def forward(self, x):
        n, h, w, _ = x.shape
        ws = self.ws
        _check_windows(h, w, ws)
        t = _grid_part(x, ws) if self.grid else _window_part(x, ws)
        q, k, v = self.to_qkv(t).chunk(3, dim=-1)
        q = _heads(q, self.heads, self.dim_head) * self.dim_head ** -0.5
        k, v = (_heads(a, self.heads, self.dim_head) for a in (k, v))
        sim = torch.einsum("bhid,bhjd->bhij", q, k)
        sim = sim + self.rel_pos_bias[self.rel_index].permute(2, 0, 1)
        o = torch.einsum("bhij,bhjd->bhid", torch.softmax(sim, dim=-1), v)
        o = self.to_out(o.permute(0, 2, 1, 3).reshape(t.shape[0], t.shape[1],
                                                      self.dim))
        return (_grid_unpart(o, n, h, w, ws) if self.grid
                else _window_unpart(o, n, h, w, ws))


class WindowGridEncoder(nn.Module):
    """depth x [pre-normed window attention -> pre-normed FFN -> pre-normed
    grid attention -> pre-normed FFN], then LayerNorm + Linear head."""

    def __init__(self, dim: int, depth: int = 1, dim_head: int = 32,
                 window_size: int = 8, mlp_dim: int = 0):
        super().__init__()
        self.depth = depth
        mlp = mlp_dim or dim
        for i in range(depth):
            for kind in ("win", "grid"):
                self.add_module(f"{kind}_norm_{i}", LayerNorm(dim))
                self.add_module(f"{kind}_{i}", WindowMHSA(
                    dim, dim_head, window_size, grid=kind == "grid"))
                self.add_module(f"{kind}_ffn_{i}_norm", LayerNorm(dim))
                self.add_module(f"{kind}_ffn_{i}_fc1", Dense(dim, mlp))
                self.add_module(f"{kind}_ffn_{i}_fc2", Dense(mlp, dim))
        self.head_norm = LayerNorm(dim)
        self.head = Dense(dim, dim)

    def _ffn(self, x, name):
        h = getattr(self, f"{name}_fc1")(getattr(self, f"{name}_norm")(x))
        return x + getattr(self, f"{name}_fc2")(gelu(h))

    def forward(self, x):
        for i in range(self.depth):
            for kind in ("win", "grid"):
                x = x + getattr(self, f"{kind}_{i}")(
                    getattr(self, f"{kind}_norm_{i}")(x))
                x = self._ffn(x, f"{kind}_ffn_{i}")
        return self.head(self.head_norm(x))


class WindowCrossAttention(nn.Module):
    """Queries from x, keys and values from ctx, each projection behind its
    own LayerNorm, biased linears, an output projection and the query as
    skip."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 32,
                 window_size: int = 2, grid: bool = False):
        super().__init__()
        self.heads, self.dim_head, self.ws, self.grid = (
            heads, dim_head, window_size, grid)
        inner = heads * dim_head
        for name in ("q", "k", "v"):
            self.add_module(f"norm_{name}", LayerNorm(dim))
            self.add_module(f"to_{name}", Dense(dim, inner))
        self.proj = Dense(inner, dim)

    def forward(self, x, ctx):
        n, h, w, _ = x.shape
        ws = self.ws
        _check_windows(h, w, ws)
        part = _grid_part if self.grid else _window_part
        unpart = _grid_unpart if self.grid else _window_unpart
        tq, tk = part(x, ws), part(ctx, ws)
        q = self.to_q(self.norm_q(tq))
        k = self.to_k(self.norm_k(tk))
        v = self.to_v(self.norm_v(tk))
        q, k, v = (_heads(a, self.heads, self.dim_head) for a in (q, k, v))
        attn = torch.softmax(torch.einsum("bhid,bhjd->bhij", q, k)
                             * self.dim_head ** -0.5, dim=-1)
        o = torch.einsum("bhij,bhjd->bhid", attn, v)
        o = o.permute(0, 2, 1, 3).reshape(tq.shape[0], tq.shape[1],
                                          self.heads * self.dim_head)
        return unpart(self.proj(o) + tq, n, h, w, ws)


class ResidualBlockLeaky(nn.Module):
    """conv-BN-leaky ReLU-conv-BN plus the input; BN momentum 0.99, eps
    1e-3."""

    def __init__(self, dim: int):
        super().__init__()
        self.Conv_0 = Conv(dim, dim, 3)
        self.BatchNorm_0 = BatchNorm(dim)
        self.Conv_1 = Conv(dim, dim, 3)
        self.BatchNorm_1 = BatchNorm(dim)

    def forward(self, x):
        y = nn.functional.leaky_relu(self.BatchNorm_0(self.Conv_0(x)), 0.01)
        return x + self.BatchNorm_1(self.Conv_1(y))


class LearnableResizer(nn.Module):
    """(ego, cav) (N, H, W, C) -> cav resized to the ego's (H, W) and
    ``out_channel`` channels."""

    def __init__(self, in_channel: int, out_channel: int, wg_depth: int = 1,
                 wg_dim_head: int = 32, window_size: int = 8,
                 res_depth: int = 2, wg_mlp_dim: int = 0):
        super().__init__()
        self.res_depth = res_depth
        self.channel_selector = Conv(in_channel, out_channel, 1)
        self.wg_att_1 = WindowGridEncoder(out_channel, wg_depth, wg_dim_head,
                                          window_size, wg_mlp_dim)
        for i in range(res_depth):
            self.add_module(f"res_{i}", ResidualBlockLeaky(out_channel))
        self.wg_att_2 = WindowGridEncoder(out_channel, wg_depth, wg_dim_head,
                                          window_size, wg_mlp_dim)

    def forward(self, ego, cav):
        h, w = ego.shape[1:3]
        cav = self.channel_selector(cav)
        c1 = resize_bilinear(self.wg_att_1(cav),
                             (cav.shape[0], h, w, cav.shape[-1]))
        c2 = c1
        for i in range(self.res_depth):
            c2 = getattr(self, f"res_{i}")(c2)
        c2 = self.wg_att_2(c2 + c1)
        return resize_bilinear(cav, (cav.shape[0], h, w, cav.shape[-1])) + c2


class CrossDomainFusionEncoder(nn.Module):
    """(ego, cav) -> cav aligned to the ego's domain."""

    def __init__(self, dim: int, depth: int = 1, dim_head: int = 32,
                 heads: int = 8, window_size: int = 2):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"cross_win_{i}", WindowCrossAttention(
                dim, heads, dim_head, window_size, grid=False))
            self.add_module(f"cross_grid_{i}", WindowCrossAttention(
                dim, heads, dim_head, window_size, grid=True))
            for m in ("mlp1", "mlp2"):
                self.add_module(f"{m}_{i}_norm", LayerNorm(dim))
                self.add_module(f"{m}_{i}_fc1", Dense(dim, 2 * dim))
                self.add_module(f"{m}_{i}_fc2", Dense(2 * dim, dim))
            self.add_module(f"post_norm_{i}", LayerNorm(dim))
        self.head_norm = LayerNorm(dim)
        self.head = Dense(dim, dim)

    def _mlp(self, x, name):
        h = getattr(self, f"{name}_fc1")(getattr(self, f"{name}_norm")(x))
        return x + getattr(self, f"{name}_fc2")(gelu(h))

    def forward(self, ego, cav):
        x = cav
        for i in range(self.depth):
            x = self._mlp(getattr(self, f"cross_win_{i}")(x, ego), f"mlp1_{i}")
            x = self._mlp(getattr(self, f"cross_grid_{i}")(x, ego),
                          f"mlp2_{i}")
            x = getattr(self, f"post_norm_{i}")(x)
        return self.head(self.head_norm(x))


class DAImgHead(nn.Module):
    """Per-pixel domain logits (N, H, W, 1) behind the gradient reversal."""

    def __init__(self, in_ch: int, grl_weight: float = GRL_WEIGHT):
        super().__init__()
        self.grl_weight = grl_weight
        self.conv1_da = Conv(in_ch, 512, 1)
        self.conv2_da = Conv(512, 1, 1)

    def forward(self, x):
        x = gradient_scale(x, self.grl_weight)
        return self.conv2_da(torch.relu(self.conv1_da(x)))
