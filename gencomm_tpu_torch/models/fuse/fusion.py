"""Attentive intermediate fusion over the padded agent axis.

Counterpart of ``gencomm_tpu/models/fuse/fusion.py`` (``warp_to_ego``,
``AttFusion``): every agent's feature is warped into the ego frame by kernel
K3 (its gradient by K3b), then a per-pixel scaled-dot attention with the
ego as the only query, masked at -1e9 for empty slots. The other fusions
are not ported.

On a bf16 feature (``half``) the warp and the scores' einsum run in bf16;
the scaling, the softmax over agents and the weighted sum run in fp32 and
the fused map is fp32, as in the JAX package, where ``np.sqrt(c)`` is a
float32 numpy scalar that promotes the bf16 scores.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gencomm_tpu_torch.ops.warp import warp_affine

_NEG = -1e9


def warp_to_ego(x: torch.Tensor, affine: torch.Tensor) -> torch.Tensor:
    """x (B, L, H, W, C), affine (B, L, L, 2, 3) -> every agent's feature
    warped into the ego frame with ``affine[:, 0]``."""
    b, l, h, w, c = x.shape
    theta = affine[:, 0].reshape(b * l, 2, 3).contiguous()
    out = warp_affine(x.reshape(b * l, h, w, c).contiguous(), theta)
    return out.reshape(b, l, h, w, c)


class AttFusion(nn.Module):
    def forward(self, x, affine, agent_mask):
        w = warp_to_ego(x, affine)
        c = w.shape[-1]
        q = w[:, 0]
        scores = torch.einsum("bhwc,blhwc->blhw", q, w).float() / math.sqrt(c)
        scores = torch.where(agent_mask[:, :, None, None], scores,
                             torch.full_like(scores, _NEG))
        attn = torch.softmax(scores, dim=1)
        return torch.einsum("blhw,blhwc->bhwc", attn, w.float())


def build_fusion(method: str) -> nn.Module:
    if method != "att":
        raise NotImplementedError(
            f"fusion {method!r} is not ported yet (ROADMAP item 17)")
    return AttFusion()
