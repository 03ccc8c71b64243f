"""CodeFilling's UMGM multi-stage vector quantizer.

Counterpart of ``gencomm_tpu/models/codebook.py`` (``UMGMQuantizer``): each
pixel's channel vector is split into ``seg_num`` segments, each quantized
against its own ``k``-entry codebook, level after level on the residual;
the restore runs the levels backwards with side heads that add the coarser
level's context. At eval a segment takes its nearest code (``argmin`` of
the squared distance); in training a Gumbel-softmax sample with a learned
temperature (floored at ``EPS``), made hard by a straight-through one-hot.
The codebook loss is the MSE of the restored feature against the detached
input.

Parameters keep flax's layouts: ``codebook_<i>`` (seg, k, d) and
``temperature_<i>`` (seg, 1) are raw; the heads are ``Dense`` layers named
as flax names them.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from gencomm_tpu_torch.models.layers import Dense

EPS = 1e-6


def one_hot(idx: torch.Tensor, k: int, dtype) -> torch.Tensor:
    """(..., k) one-hot rows by comparison, with no host check of the
    indices (a CUDA graph captures it)."""
    return (idx[..., None] == torch.arange(k, device=idx.device)).to(dtype)


def hard_index(soft: torch.Tensor) -> torch.Tensor:
    """The straight-through sample's code: the argmax over the last axis
    (first index on ties)."""
    return soft.argmax(-1)


def gumbel(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) of u uniform in [tiny, 1), drawn
    from ``generator`` as ``jax.random.gumbel`` draws it from its key."""
    if generator is None:
        raise ValueError("the codebook's training sample draws Gumbel noise "
                         "from a generator; none was given")
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp_min(tiny)
    return -torch.log(-torch.log(u))


class UMGMQuantizer(nn.Module):
    """x (n, channel) -> (restored (n, channel), [codes (n, seg)] per level,
    codebook loss)."""

    def __init__(self, channel: int, seg_num: int, dict_sizes: Sequence[int]):
        super().__init__()
        self.channel, self.seg_num = channel, seg_num
        self.dict_sizes = tuple(int(k) for k in dict_sizes)
        d = channel // seg_num
        std = (2.0 / (5.0 * channel / seg_num)) ** 0.5
        n_levels = len(self.dict_sizes)
        # random_state_dict draws the tables at flax's init std and the
        # temperatures near their init of 1
        self.PARAM_STD = {f"codebook_{i}": std for i in range(n_levels)}
        self.PARAM_NEAR_ONE = tuple(f"temperature_{i}"
                                    for i in range(n_levels))
        for i, k in enumerate(self.dict_sizes):
            setattr(self, f"codebook_{i}",
                    nn.Parameter(torch.randn(seg_num, k, d) * std))
            setattr(self, f"temperature_{i}",
                    nn.Parameter(torch.ones(seg_num, 1)))
            self.add_module(f"latent_enc_{i}", Dense(channel, channel))
            self.add_module(f"q_head_{i}", Dense(channel, channel))
            if i < n_levels - 1:
                self.add_module(f"latent_head_{i}", Dense(channel, channel))
                self.add_module(f"side_head_{i}", Dense(channel, channel))
            self.add_module(f"deq_head_{i}", Dense(channel, channel))
            self.add_module(f"restore_head_{i}", Dense(channel, channel))

    def _distance(self, x, codebook):
        """x (n, c) -> (n, m, k) squared distances, in flax's order."""
        xs = x.reshape(x.shape[0], self.seg_num, -1)
        x2 = (xs ** 2).sum(-1, keepdim=True)
        c2 = (codebook ** 2).sum(-1)
        inter = torch.einsum("nmd,mkd->nmk", xs, codebook)
        return x2 + c2[None] - 2 * inter

    def forward(self, x, generator: torch.Generator | None = None):
        x_gt = x.detach()
        n_levels = len(self.dict_sizes)
        quantizeds, codes = [], []
        h = x
        for i, k in enumerate(self.dict_sizes):
            codebook = getattr(self, f"codebook_{i}")
            z = getattr(self, f"latent_enc_{i}")(h)
            q_in = getattr(self, f"q_head_{i}")(z)
            dist = self._distance(q_in, codebook)
            logit = -dist / (float(k) ** 0.5)
            temp = getattr(self, f"temperature_{i}").clamp_min(EPS)
            logit = logit * temp[None]
            if self.training:
                soft = torch.softmax(
                    logit + gumbel(logit.shape, generator, logit.device), -1)
                hard = one_hot(hard_index(soft), k, soft.dtype)
                sample = hard + soft - soft.detach()  # straight through
            else:
                sample = one_hot(dist.argmin(-1), k, x.dtype)
            codes.append(sample.argmax(-1))
            q = torch.einsum("nmk,mkd->nmd", sample, codebook).reshape(
                x.shape[0], -1)
            quantizeds.append(q)
            if i < n_levels - 1:
                h = getattr(self, f"latent_head_{i}")(z) - q
        former = None
        for i in range(n_levels - 1, -1, -1):
            dq = getattr(self, f"deq_head_{i}")(quantizeds[i])
            if i < n_levels - 1:
                dq = dq + getattr(self, f"side_head_{i}")(former)
            former = getattr(self, f"restore_head_{i}")(dq)
        return former, codes, torch.mean((former - x_gt) ** 2)
