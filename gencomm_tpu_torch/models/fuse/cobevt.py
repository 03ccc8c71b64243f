"""CoBEVT fused-axial ("swap") attention fusion.

Counterpart of ``gencomm_tpu/models/fuse/cobevt.py``: ``depth`` x [local
window attention -> FFN -> grid (dilated) attention -> FFN] over (agent x
window) token groups with a 3D relative-position bias, masked for empty
agent slots, then the masked mean over agents, a LayerNorm and a Linear
head. The window and grid partitions are the JAX package's ``einops``
patterns (``cobevt.py:97-123``).

The relative-position table ``rel_pos_bias`` ((2L-1)(2ws-1)^2, heads) is
sized by the agent-slot count L of the batch, not by the config's
``agent_size``, which the JAX package reads and never uses
(``cobevt.py:142-145``: flax sizes it from the batch that initialises the
model). The port takes L when it is built (``num_agents``) and refuses a
batch of another L, as flax refuses a parameter of another shape
(suspected reference fault j, ``ROADMAP.md`` section 3).
"""

from __future__ import annotations

import numpy as np
import torch
from einops import rearrange
from torch import nn

from gencomm_tpu_torch.models.fuse.fusion import _masked, warp_to_ego
from gencomm_tpu_torch.models.layers import Dense, LayerNorm, gelu, softmax


def _relative_position_index(ws3) -> np.ndarray:
    """3D relative-position index table over (agents, wh, ww): the JAX
    package's numpy helper, copied."""
    d, h, w = ws3
    coords = np.stack(
        np.meshgrid(np.arange(d), np.arange(h), np.arange(w), indexing="ij")
    ).reshape(3, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += d - 1
    rel[:, :, 1] += h - 1
    rel[:, :, 2] += w - 1
    rel[:, :, 0] *= (2 * h - 1) * (2 * w - 1)
    rel[:, :, 1] *= 2 * w - 1
    return rel.sum(-1)


class SwapAttention(nn.Module):
    """Multi-head attention inside one (L, ws, ws) token group, with the 3D
    relative-position bias and the agent mask."""

    PARAM_STD = {"rel_pos_bias": 0.02}  # flax's normal(0.02)

    def __init__(self, dim: int, dim_head: int, agent_size: int,
                 window_size: int):
        super().__init__()
        self.dim, self.dim_head = dim, dim_head
        self.heads = dim // dim_head
        self.ws3 = (agent_size, window_size, window_size)
        self.to_qkv = Dense(dim, dim * 3, bias=False)
        self.to_out = Dense(dim, dim, bias=False)
        n_rel = ((2 * agent_size - 1) * (2 * window_size - 1)
                 * (2 * window_size - 1))
        self.rel_pos_bias = nn.Parameter(0.02 * torch.randn(n_rel, self.heads))
        self.register_buffer("rel_index", torch.from_numpy(
            _relative_position_index(self.ws3)), persistent=False)

    def forward(self, x, mask):
        # x (b, gx, gy, L, w1, w2, c) token groups; mask (b, gx, gy, L, w1, w2)
        if tuple(x.shape[3:6]) != self.ws3:
            raise ValueError(
                f"cobevt was built for token groups {self.ws3} (agents, "
                f"window, window) and got {tuple(x.shape[3:6])}: its "
                "relative-position table is sized by the agent count of the "
                "batch it was built for")
        b, gx, gy = x.shape[:3]
        n = int(np.prod(self.ws3))
        tokens = x.reshape(b * gx * gy, n, self.dim)
        q, k, v = (t.reshape(t.shape[0], n, self.heads, self.dim_head)
                   .permute(0, 2, 1, 3)
                   for t in self.to_qkv(tokens).chunk(3, dim=-1))
        sim = torch.einsum("bhid,bhjd->bhij", q * self.dim_head ** -0.5, k)
        sim = sim + self.rel_pos_bias[self.rel_index].permute(2, 0, 1)[None]
        sim = _masked(sim, mask.reshape(b * gx * gy, 1, 1, n))
        out = torch.einsum("bhij,bhjd->bhid", softmax(sim, dim=-1), v)
        out = out.permute(0, 2, 1, 3).reshape((b, gx, gy) + self.ws3
                                              + (self.dim,))
        return self.to_out(out)


class SwapBlock(nn.Module):
    """Local window attention and FFN, then grid attention and FFN."""

    def __init__(self, dim: int, mlp_dim: int, dim_head: int,
                 window_size: int, agent_size: int):
        super().__init__()
        self.ws = window_size
        for name in ("window", "grid"):
            self.add_module(f"{name}_norm", LayerNorm(dim))
            self.add_module(name, SwapAttention(dim, dim_head, agent_size,
                                                window_size))
            self.add_module(f"{name}_ffn_norm", LayerNorm(dim))
            self.add_module(f"{name}_ffn_fc1", Dense(dim, mlp_dim))
            self.add_module(f"{name}_ffn_fc2", Dense(mlp_dim, dim))

    def _attend(self, x, mask, pattern_in, pattern_out, name):
        ws = self.ws
        xt = rearrange(x, pattern_in, w1=ws, w2=ws)
        mt = rearrange(mask, pattern_in.replace(" c", ""), w1=ws, w2=ws)
        xt = xt + getattr(self, name)(getattr(self, f"{name}_norm")(xt), mt)
        h = getattr(self, f"{name}_ffn_fc1")(getattr(self, f"{name}_ffn_norm")(xt))
        xt = xt + getattr(self, f"{name}_ffn_fc2")(gelu(h))
        return rearrange(xt, pattern_out, w1=ws, w2=ws)

    def forward(self, x, mask):
        # x (B, L, H, W, C); mask (B, L, H, W) bool
        x = self._attend(x, mask, "b l (x w1) (y w2) c -> b x y l w1 w2 c",
                         "b x y l w1 w2 c -> b l (x w1) (y w2) c", "window")
        return self._attend(x, mask, "b l (w1 x) (w2 y) c -> b x y l w1 w2 c",
                            "b x y l w1 w2 c -> b l (w1 x) (w2 y) c", "grid")


class CoBEVTFusion(nn.Module):
    """``depth`` swap blocks over the warped agents, then the masked mean
    over agents, ``head_norm`` and ``head_fc``. ``num_agents`` is the batch's
    agent-slot count L, kept as ``fixed_agent_slots`` for the callers that
    trim batches; ``agent_size`` is the config's, held and unused as in the
    JAX package."""

    def __init__(self, input_dim: int, num_agents: int, mlp_dim: int = 256,
                 dim_head: int = 32, window_size: int = 8,
                 agent_size: int = 5, depth: int = 1):
        super().__init__()
        self.depth, self.agent_size = depth, agent_size
        self.fixed_agent_slots = num_agents
        for i in range(depth):
            self.add_module(f"block{i}", SwapBlock(
                input_dim, mlp_dim, dim_head, window_size, num_agents))
        self.head_norm = LayerNorm(input_dim)
        self.head_fc = Dense(input_dim, input_dim)

    def forward(self, x, affine, agent_mask):
        w = warp_to_ego(x, affine)  # (B, L, H, W, C)
        b, l, h, wd, _ = w.shape
        mask = agent_mask[:, :, None, None].expand(b, l, h, wd)
        for i in range(self.depth):
            w = getattr(self, f"block{i}")(w, mask)
        mf = agent_mask[:, :, None, None, None].to(w.dtype)
        pooled = (w * mf).sum(dim=1) / mf.sum(dim=1).clamp_min(1.0)
        return self.head_fc(self.head_norm(pooled))
