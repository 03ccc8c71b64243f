"""Intermediate fusion over the padded agent axis.

Counterpart of ``gencomm_tpu/models/fuse/fusion.py``: ``warp_to_ego`` and
the fusions ``att`` (per-pixel scaled-dot attention with the ego as the only
query), ``max`` (F-Cooper's elementwise max), ``disconet`` (a per-pixel
softmax weight over agents from ``PixelWeightLayer``) and ``who2com`` (one
global score per agent, then a 1x1 decode), with ``build_fusion``, which
also builds ``v2xvit``, ``cobevt``, ``where2comm`` and ``v2vnet`` from their
own modules (the HEAL pyramid is built by its models,
``models/heter_pyramid.py``). Every fusion takes ``(x (B, L, H, W, C),
affine (B, L, L, 2, 3), agent_mask (B, L))``, warps the agents into the ego
frame with kernel K3 (its gradient by K3b), masks empty slots at -1e9 and
returns (B, H, W, C'); the train-mode norms of ``disconet`` follow
``self.training``.

On a bf16 feature (``half``) the warp runs in bf16 and each layer computes
in the promoted type of its input and its fp32 parameters, as flax does:
``att`` scales its bf16 scores by ``np.sqrt(c)``, a float32 numpy scalar
that promotes them, so its softmax and sum are fp32; ``max`` stays bf16;
``disconet`` and ``who2com`` are fp32 after their first layer.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gencomm_tpu_torch.models.layers import Conv, ConvBNReLU, Dense, softmax
from gencomm_tpu_torch.ops.warp import warp_affine, warp_affine_pair

_NEG = -1e9


def warp_to_ego(x: torch.Tensor, affine: torch.Tensor) -> torch.Tensor:
    """x (B, L, H, W, C), affine (B, L, L, 2, 3) -> every agent's feature
    warped into the ego frame with ``affine[:, 0]``."""
    return warp_all_to(x, affine, 0)


def warp_all_to(x: torch.Tensor, affine: torch.Tensor, target: int
                ) -> torch.Tensor:
    """Every agent's map of x (B, L, H, W, C) warped into agent
    ``target``'s frame with ``affine[:, target]``: one K3 launch."""
    b, l, h, w, c = x.shape
    theta = affine[:, target].reshape(b * l, 2, 3).contiguous()
    out = warp_affine(x.reshape(b * l, h, w, c).contiguous(), theta)
    return out.reshape(b, l, h, w, c)


def warp_pair_to_ego(x: torch.Tensor, s: torch.Tensor, affine: torch.Tensor):
    """x (B, L, H, W, C) and s (B, L, H, W, C_s) warped into the ego frame
    with ``affine[:, 0]`` in one K3 launch: ``(warp_to_ego(x, affine),
    warp_to_ego(s, affine))`` bit for bit."""
    b, l, h, w, c = x.shape
    theta = affine[:, 0].reshape(b * l, 2, 3).contiguous()
    out, out_s = warp_affine_pair(
        x.reshape(b * l, h, w, c).contiguous(),
        s.reshape((b * l, h, w) + s.shape[4:]).contiguous(), theta)
    return out.reshape(x.shape), out_s.reshape(s.shape)


def _masked(t: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``jnp.where(mask, t, -1e9)``, in t's type."""
    return torch.where(mask, t, torch.full_like(t, _NEG))


class AttFusion(nn.Module):
    def forward(self, x, affine, agent_mask):
        w = warp_to_ego(x, affine)
        c = w.shape[-1]
        q = w[:, 0]
        scores = torch.einsum("bhwc,blhwc->blhw", q, w).float() / math.sqrt(c)
        scores = _masked(scores, agent_mask[:, :, None, None])
        attn = torch.softmax(scores, dim=1)
        return torch.einsum("blhw,blhwc->bhwc", attn, w.float())


class MaxFusion(nn.Module):
    """F-Cooper's elementwise max over the valid agents; ties share the
    gradient equally, as JAX's max does (``amax``)."""

    def forward(self, x, affine, agent_mask):
        w = warp_to_ego(x, affine)
        return _masked(w, agent_mask[:, :, None, None, None]).amax(dim=1)


class PixelWeightLayer(nn.Module):
    """DiscoNet's pixel-weight net: three 1x1 ConvBNReLU, then a 1x1 conv
    to one logit."""

    def __init__(self, in_ch: int):
        super().__init__()
        self.ConvBNReLU_0 = ConvBNReLU(in_ch, 128, kernel=1)
        self.ConvBNReLU_1 = ConvBNReLU(128, 32, kernel=1)
        self.ConvBNReLU_2 = ConvBNReLU(32, 8, kernel=1)
        self.Conv_0 = Conv(8, 1, 1)

    def forward(self, x):
        for m in (self.ConvBNReLU_0, self.ConvBNReLU_1, self.ConvBNReLU_2):
            x = m(x)
        return self.Conv_0(x)


class DiscoFusion(nn.Module):
    """DiscoNet: softmax over agents of a per-pixel weight computed from
    each warped map beside the ego's own, unwarped, feature
    (``fusion.py:99``)."""

    def __init__(self, in_ch: int):
        super().__init__()
        self.PixelWeightLayer_0 = PixelWeightLayer(2 * in_ch)

    def forward(self, x, affine, agent_mask):
        b, l, h, wd, c = x.shape
        w = warp_to_ego(x, affine)
        ego = x[:, 0:1].expand(w.shape)
        cat = torch.cat([w, ego], dim=-1).reshape(b * l, h, wd, 2 * c)
        logits = self.PixelWeightLayer_0(cat).reshape(b, l, h, wd, 1)
        logits = _masked(logits, agent_mask[:, :, None, None, None])
        return (softmax(logits, dim=1) * w).sum(dim=1)


class Who2comFusion(nn.Module):
    """Who2com: one score per agent from the spatial means of its key and
    the ego's query projections, a softmax-weighted sum of the warped maps,
    then a 1x1 decode of [ego feature, fused]."""

    def __init__(self, in_ch: int, feat_dim: int):
        super().__init__()
        self.feat_dim = feat_dim
        self.key_proj = Dense(in_ch, feat_dim)
        self.query_proj = Dense(in_ch, feat_dim)
        self.decode = Conv(2 * in_ch, feat_dim, 1)

    def forward(self, x, affine, agent_mask):
        w = warp_to_ego(x, affine)
        key = self.key_proj(w).mean(dim=(2, 3))
        query = self.query_proj(w[:, 0]).mean(dim=(1, 2))
        scores = torch.einsum("bc,blc->bl", query, key) / math.sqrt(
            self.feat_dim)
        attn = softmax(_masked(scores, agent_mask), dim=1)
        # jnp.einsum promotes the bf16 map to the fp32 weights' type
        fused = torch.einsum("bl,blhwc->bhwc", attn, w.to(attn.dtype))
        return self.decode(torch.cat(
            [x[:, 0].to(fused.dtype), fused], dim=-1))


def build_fusion(method: str, args: dict | None = None, half: bool = False,
                 in_ch: int = 128, num_agents: int | None = None
                 ) -> nn.Module:
    """The fusion ``method`` from the hypes ``model.args`` (its block
    ``args[method]``), reading the keys and defaults of
    ``gencomm_tpu/models/fuse/fusion.py:build_fusion``; ``half`` goes to
    ``v2xvit`` only. ``in_ch`` is the fused feature's channel count, which
    torch needs to size the parameters that flax infers from the input;
    ``num_agents`` is the batch's agent-slot count L, which sizes CoBEVT's
    relative-position table (``cobevt.py:142-145``)."""
    cfg = (args or {}).get(method, {})
    if method == "att":
        return AttFusion()
    if method == "max":
        return MaxFusion()
    if method == "disconet":
        return DiscoFusion(in_ch)
    if method == "who2com":
        return Who2comFusion(in_ch, cfg["feat_dim"])
    if method == "where2comm":
        from gencomm_tpu_torch.models.fuse.where2comm import Where2commFusion

        return Where2commFusion(in_ch, feat_dim=cfg["feat_dim"])
    if method == "v2vnet":
        from gencomm_tpu_torch.models.fuse.v2vnet import V2VNetFusion

        return V2VNetFusion(in_ch, in_channels=cfg["in_channels"],
                            num_iteration=cfg.get("num_iteration", 2),
                            gru_flag=cfg.get("gru_flag", True),
                            agg_operator=cfg.get("agg_operator", "avg"))
    if method == "cobevt":
        from gencomm_tpu_torch.models.fuse.cobevt import CoBEVTFusion

        if num_agents is None:
            raise ValueError("cobevt sizes its relative-position table by "
                             "the batch's agent count: pass num_agents")
        return CoBEVTFusion(cfg["input_dim"], num_agents,
                            mlp_dim=cfg.get("mlp_dim", 256),
                            dim_head=cfg.get("dim_head", 32),
                            window_size=cfg.get("window_size", 8),
                            agent_size=cfg.get("agent_size", 5),
                            depth=cfg.get("depth", 1))
    if method == "v2xvit":
        from gencomm_tpu_torch.models.fuse.v2xvit import V2XViTFusion

        return V2XViTFusion(
            dim=cfg.get("dim", cfg.get("feat_dim", 128)),
            depth=cfg.get("depth", 3),
            num_blocks=cfg.get("num_blocks", 1),
            window_sizes=tuple(cfg.get("window_sizes", (4, 8, 16))),
            pwindow_heads=tuple(cfg.get("pwindow_heads", (16, 8, 4))),
            pwindow_dim_heads=tuple(cfg.get("pwindow_dim_heads", (8, 16, 32))),
            mlp_dim=cfg.get("mlp_dim", 256),
            half=half or cfg.get("half", False))
    if method == "pyramid":
        raise ValueError("the pyramid fusion runs inside the HEAL pyramid "
                         "models (heter_pyramid_collab / _single, "
                         "models/heter_pyramid.py)")
    raise KeyError(f"unknown fusion {method!r}")
