"""V2X-ViT fusion: heterogeneous multi-agent self-attention (HMSA) and
multi-scale window attention (MSwin).

Counterpart of ``gencomm_tpu/models/fuse/v2xvit.py`` (``TypedDense``,
``HGTCavAttention``, ``WindowAttention``, ``SplitAttn3``,
``PyramidWindowAttention``, ``V2XViTFusion``), with JAX's order of
operations: attention is an einsum, a bias, a mask and a softmax, never a
library attention call. The agents are warped into the ego frame (K3)
before the transformer; agent types are all 0 (``v2xvit.py:257``), so
every relation index picks table entry 0.

Parameters keep flax's layouts where flax's are not a plain Dense:
``TypedDense`` holds ``kernel`` (C, num_types, out) and ``bias``
(num_types, out); HMSA holds ``relation_att`` / ``relation_msg``
(num_types^2, heads, d, d); each window attention holds its (2ws-1, 2ws-1)
``rel_pos`` table, expanded to the (ws^2, ws^2) bias through an index
buffer built once (``bias[(yi, xi), (yj, xj)] = table[yi - yj + ws - 1,
xi - xj + ws - 1]``, the bias of ``v2xvit.py:168-182``).

``half`` follows the JAX package's casts (``v2xvit.py:78, 119, 141,
186``): HMSA casts its input to bf16, computes in bf16 (its scores masked
and soft-maxed in fp32, the weights cast back) and returns fp32; a window
attention casts its fp32 qkv to bf16, adds the bias and takes the softmax
and the weighted sum in bf16, and returns fp32 before ``to_out``. Python
constants are rounded to bf16 where JAX applies them to a bf16 array.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from gencomm_tpu_torch.models.fuse.fusion import _masked, warp_to_ego
from gencomm_tpu_torch.models.layers import (
    Dense, LayerNorm, as_dtype, gelu, softmax,
)


class TypedDense(nn.Module):
    """Per-agent-type linear: the (C, num_types, out) weight bank gathered
    by the (B, L) type index, one matmul an agent."""

    FAN_IN_AXES = {"kernel": (0,)}

    def __init__(self, in_dim: int, num_types: int, out_dim: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim, num_types, out_dim))
        self.bias = nn.Parameter(torch.zeros(num_types, out_dim))
        nn.init.normal_(self.kernel, std=in_dim ** -0.5)

    def forward(self, x, agent_types):
        # x (B, H, W, L, C), agent_types (B, L)
        w_sel = self.kernel.permute(1, 0, 2)[agent_types]  # (B, L, C, o)
        b_sel = self.bias[agent_types]  # (B, L, o)
        y = torch.einsum("bhwlc,blco->bhwlo", x, w_sel.to(x.dtype))
        return y + b_sel[:, None, None].to(x.dtype)


class HGTCavAttention(nn.Module):
    """Heterogeneous graph-transformer attention over the agent axis."""

    FAN_IN_AXES = {"relation_att": (2,), "relation_msg": (2,)}

    def __init__(self, dim: int, heads: int, dim_head: int = 64,
                 num_types: int = 2, half: bool = False):
        super().__init__()
        self.heads, self.dim_head, self.num_types = heads, dim_head, num_types
        self.half = half
        inner = heads * dim_head
        self.q_typed = TypedDense(dim, num_types, inner)
        self.k_typed = TypedDense(dim, num_types, inner)
        self.v_typed = TypedDense(dim, num_types, inner)
        self.out_typed = TypedDense(inner, num_types, dim)
        shape = (num_types * num_types, heads, dim_head, dim_head)
        self.relation_att = nn.Parameter(torch.empty(shape))
        self.relation_msg = nn.Parameter(torch.empty(shape))
        for p in (self.relation_att, self.relation_msg):
            nn.init.normal_(p, std=dim_head ** -0.5)

    def forward(self, x, agent_types, mask):
        # x (B, H, W, L, C); agent_types (B, L) int64; mask (B, L) bool
        b, h, w, l, _ = x.shape
        nt, m, d = self.num_types, self.heads, self.dim_head
        if self.half:
            x = x.to(torch.bfloat16)
        q, k, v = (t(x, agent_types).reshape(b, h, w, l, m, d)
                   for t in (self.q_typed, self.k_typed, self.v_typed))
        rel_idx = agent_types[:, :, None] * nt + agent_types[:, None, :]
        w_att = self.relation_att[rel_idx].to(q.dtype)  # (B, L, L, m, d, d)
        w_msg = self.relation_msg[rel_idx].to(q.dtype)
        # score_ij = (q_i W_att[ij]) . k_j
        qw = torch.einsum("bhwimd,bijmde->bhwijme", q, w_att)
        scores = torch.einsum("bhwijme,bhwjme->bhwmij", qw, k) * as_dtype(
            d ** -0.5, q.dtype)
        vmsg = torch.einsum("bhwjmd,bijmde->bhwijme", v, w_msg)
        scores = _masked(scores.float(), mask[:, None, None, None, None, :])
        attn = torch.softmax(scores, dim=-1).to(vmsg.dtype)
        out = torch.einsum("bhwmij,bhwijme->bhwime", attn, vmsg)
        out = self.out_typed(out.reshape(b, h, w, l, m * d), agent_types)
        return out.float()


def _window_bias_index(ws: int) -> np.ndarray:
    """(ws^2, ws^2) flat indices into the (2ws-1, 2ws-1) table: token (yi,
    xi) against (yj, xj) reads table[yi - yj + ws - 1, xi - xj + ws - 1]."""
    y, x = np.divmod(np.arange(ws * ws), ws)
    dy = y[:, None] - y[None, :] + ws - 1
    dx = x[:, None] - x[None, :] + ws - 1
    return dy * (2 * ws - 1) + dx


class WindowAttention(nn.Module):
    """Per-agent windowed multi-head attention with a relative position
    bias; the window partition keeps the full inner dim minor."""

    PARAM_STD = {"rel_pos": 1.0}  # flax's normal(1.0)

    def __init__(self, dim: int, heads: int, dim_head: int, window_size: int,
                 half: bool = False):
        super().__init__()
        self.heads, self.dim_head, self.ws, self.half = (
            heads, dim_head, window_size, half)
        inner = heads * dim_head
        self.to_qkv = Dense(dim, inner * 3, bias=False)
        self.to_out = Dense(inner, dim)
        self.rel_pos = nn.Parameter(
            torch.randn(2 * window_size - 1, 2 * window_size - 1))
        self.register_buffer("bias_index", torch.from_numpy(
            _window_bias_index(window_size)), persistent=False)

    def forward(self, x):
        # x (B, L, H, W, C)
        ws, m, d = self.ws, self.heads, self.dim_head
        inner = m * d
        qkv = self.to_qkv(x)
        if self.half:
            qkv = qkv.to(torch.bfloat16)
        b, l, hh, ww = x.shape[:4]
        nh, nw = hh // ws, ww // ws

        def windows(t):
            t = t.reshape(b, l, nh, ws, nw, ws, inner)
            t = t.permute(0, 1, 2, 4, 3, 5, 6)
            return t.reshape(b * l, nh * nw, ws * ws, m, d)

        q, k, v = (windows(t) for t in qkv.chunk(3, dim=-1))
        dots = torch.einsum("bwimc,bwjmc->bwmij", q, k) * as_dtype(
            d ** -0.5, q.dtype)
        bias = self.rel_pos.reshape(-1)[self.bias_index]
        attn = softmax(dots + bias.to(dots.dtype), dim=-1)
        out = torch.einsum("bwmij,bwjmc->bwimc", attn, v).float()
        out = out.reshape(b, l, nh, nw, ws, ws, inner)
        out = out.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, l, hh, ww, inner)
        return self.to_out(out)


class SplitAttn3(nn.Module):
    """Radix-3 split attention over the three window scales: the mean of
    their sum -> fc1 -> LayerNorm -> ReLU -> fc2 (3C) -> a softmax over the
    scales per channel -> the weighted sum."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.fc1 = Dense(dim, dim, bias=False)
        self.ln = LayerNorm(dim)
        self.fc2 = Dense(dim, dim * 3, bias=False)

    def forward(self, windows):
        sw, mw, bw = windows
        gap = (sw + mw + bw).mean(dim=(2, 3), keepdim=True)  # (B, L, 1, 1, C)
        y = self.fc2(torch.relu(self.ln(self.fc1(gap))))
        w = softmax(y.reshape(y.shape[:-1] + (3, self.dim)), dim=-2)
        return sw * w[..., 0, :] + mw * w[..., 1, :] + bw * w[..., 2, :]


class PyramidWindowAttention(nn.Module):
    """Window attention at each window size, fused by ``SplitAttn3`` when
    there are three (the shipped ``split_attn``), else averaged."""

    def __init__(self, dim: int, heads: Sequence[int],
                 dim_heads: Sequence[int], window_sizes: Sequence[int],
                 half: bool = False):
        super().__init__()
        self.n = len(window_sizes)
        for i, (h, dh, ws) in enumerate(zip(heads, dim_heads, window_sizes)):
            self.add_module(f"wmsa{i}", WindowAttention(dim, h, dh, ws, half))
        if self.n == 3:
            self.split_attn = SplitAttn3(dim)

    def forward(self, x):
        outs = [getattr(self, f"wmsa{i}")(x) for i in range(self.n)]
        if self.n == 3:
            return self.split_attn(outs)
        return sum(outs) / len(outs)


class V2XViTFusion(nn.Module):
    """``depth`` x [``num_blocks`` x (HMSA, MSwin), feed-forward] over the
    warped agents; the ego's slot is the output. Submodules are named as
    flax names them: ``d{d}b{nb}_cav_norm``, ``d{d}b{nb}_hmsa``,
    ``d{d}b{nb}_win_norm``, ``d{d}b{nb}_mswin``, ``d{d}_ff_norm``,
    ``d{d}_ff1``, ``d{d}_ff2``."""

    def __init__(self, dim: int, depth: int = 3, num_blocks: int = 1,
                 cav_heads: int = 8, cav_dim_head: int = 32,
                 window_sizes: Sequence[int] = (4, 8, 16),
                 pwindow_heads: Sequence[int] = (16, 8, 4),
                 pwindow_dim_heads: Sequence[int] = (8, 16, 32),
                 mlp_dim: int = 256, half: bool = False):
        super().__init__()
        self.depth, self.num_blocks = depth, num_blocks
        self.window_sizes = tuple(window_sizes)
        for d in range(depth):
            for nb in range(num_blocks):
                p = f"d{d}b{nb}_"
                self.add_module(p + "cav_norm", LayerNorm(dim))
                self.add_module(p + "hmsa", HGTCavAttention(
                    dim, cav_heads, cav_dim_head, half=half))
                self.add_module(p + "win_norm", LayerNorm(dim))
                self.add_module(p + "mswin", PyramidWindowAttention(
                    dim, pwindow_heads, pwindow_dim_heads, window_sizes,
                    half=half))
            self.add_module(f"d{d}_ff_norm", LayerNorm(dim))
            self.add_module(f"d{d}_ff1", Dense(dim, mlp_dim))
            self.add_module(f"d{d}_ff2", Dense(mlp_dim, dim))

    def forward(self, x, affine, agent_mask):
        h, w = x.shape[2:4]
        if any(h % ws or w % ws for ws in self.window_sizes):
            # the JAX package fails here too, in a reshape (suspected
            # reference fault k, ROADMAP section 3)
            raise ValueError(f"v2xvit's windows {self.window_sizes} must "
                             f"divide the fused map, {h} x {w}")
        feats = warp_to_ego(x, affine)  # (B, L, H, W, C)
        b, l = feats.shape[:2]
        agent_types = torch.zeros((b, l), dtype=torch.int64,
                                  device=feats.device)
        for d in range(self.depth):
            for nb in range(self.num_blocks):
                p = f"d{d}b{nb}_"
                norm = getattr(self, p + "cav_norm")(feats.permute(0, 2, 3, 1, 4))
                att = getattr(self, p + "hmsa")(norm, agent_types, agent_mask)
                feats = feats + att.permute(0, 3, 1, 2, 4)
                feats = feats + getattr(self, p + "mswin")(
                    getattr(self, p + "win_norm")(feats))
            ff = getattr(self, f"d{d}_ff1")(getattr(self, f"d{d}_ff_norm")(feats))
            feats = feats + getattr(self, f"d{d}_ff2")(gelu(ff))
        return feats[:, 0]
