"""HEAL pyramid fusion and the multiscale max / attentive fusion.

Counterpart of ``gencomm_tpu/models/fuse/pyramid.py``:

``weighted_fuse``  one pyramid level: every agent's feature and its
                   1-channel occupancy score warped into the ego frame (one
                   K3 launch), a softmax of the warped scores over the
                   agents where the score is positive and the agent present
                   (-1e9 elsewhere; a pixel with no valid agent gets weight
                   0), the weighted sum.
``PyramidFusion``  the ResNeXt levels (``resnext``) with a 1x1 occupancy
                   head per level (``single_head_{i}``), each level fused by
                   ``weighted_fuse``, then the deconv decode. Its
                   ``single=True`` mode, the same parameters, encodes and
                   decodes every agent alone. Camera field-of-view score
                   masks come in at the input's resolution and are resized
                   to each level as ``jax.image.resize(method="nearest")``
                   does, with half-pixel centres (``nearest-exact``).
``MsFusion``       level 0 the per-agent input, each further level a
                   ResNet level on the previous per-agent map, each level
                   fused by max or attentive fusion, the deconv decode.

Inputs are NHWC over the padded agent axis: x (B, L, H, W, C), affine
(B, L, L, 2, 3), agent_mask (B, L). The norms follow ``self.training``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gencomm_tpu_torch.models.backbones.resnet_bev import (
    BasicBlock, Bottleneck, add_deblocks, add_levels, decode_levels,
)
from gencomm_tpu_torch.models.fuse.fusion import (
    AttFusion, MaxFusion, warp_pair_to_ego,
)
from gencomm_tpu_torch.models.layers import Conv

_NEG = -1e9


def weighted_fuse(feat: torch.Tensor, score: torch.Tensor,
                  affine: torch.Tensor, agent_mask: torch.Tensor
                  ) -> torch.Tensor:
    """feat (B, L, H, W, C), score (B, L, H, W, 1) positive, affine (B, L,
    L, 2, 3), agent_mask (B, L) -> (B, H, W, C). The JAX package warps the
    two concatenated in one launch; here ``warp_affine_pair`` warps them in
    one launch without the concatenation (the feature on K3's rows route,
    the score from the same samples), with the bits of the two warped apart:
    the warp is per channel (PERF.md section 6)."""
    warped, warped_s = warp_pair_to_ego(feat, score, affine)
    valid = (warped_s > 0) & agent_mask.bool()[:, :, None, None, None]
    logits = torch.where(valid, warped_s, torch.full_like(warped_s, _NEG))
    attn = torch.softmax(logits, dim=1)
    attn = torch.where(valid.any(dim=1, keepdim=True), attn,
                       torch.zeros_like(attn))
    return (attn * warped).sum(dim=1)


def resize_nearest(mask: torch.Tensor, hw) -> torch.Tensor:
    """(B, L, H, W, 1) -> (B, L, h, w, 1) by ``jax.image.resize``'s
    "nearest": the source pixel under each output pixel's centre."""
    b, l, h, w, c = mask.shape
    out = F.interpolate(mask.reshape(b * l, h, w, c).permute(0, 3, 1, 2),
                        size=tuple(hw), mode="nearest-exact")
    return out.permute(0, 2, 3, 1).reshape((b, l) + tuple(hw) + (c,))


class PyramidFusion(nn.Module):
    def __init__(self, in_ch: int, layer_nums: Sequence[int],
                 layer_strides: Sequence[int], num_filters: Sequence[int],
                 upsample_strides: Sequence[int] = (),
                 num_upsample_filters: Sequence[int] = (),
                 resnext: bool = True):
        super().__init__()
        self.layer_nums = tuple(max(n, 1) for n in layer_nums)
        add_levels(self, in_ch, layer_nums, layer_strides, num_filters,
                   Bottleneck if resnext else BasicBlock)
        for i, f in enumerate(num_filters):
            self.add_module(f"single_head_{i}", Conv(f, 1, 1))
        self.out_channels = add_deblocks(self, num_filters, upsample_strides,
                                         num_upsample_filters)

    @staticmethod
    def from_config(cfg: dict, in_ch: int) -> "PyramidFusion":
        return PyramidFusion(
            in_ch, cfg["layer_nums"], cfg["layer_strides"], cfg["num_filters"],
            cfg.get("upsample_strides", ()),
            cfg.get("num_upsample_filter", ()),
            resnext=bool(cfg.get("resnext", True)))

    def _encode(self, x):
        feats = []
        for i, n in enumerate(self.layer_nums):
            for k in range(n):
                x = getattr(self, f"layer{i}_{k}")(x)
            feats.append(x)
        return feats

    def forward(self, x, affine=None, agent_mask=None,
                score_mask: Optional[torch.Tensor] = None,
                single: bool = False):
        """Collab: x (B, L, H, W, C) -> (fused (B, H', W', C'), occupancy
        logits [(B * L, Hi, Wi, 1)]). Single: x (N, H, W, C) -> (decoded
        (N, H', W', C'), occupancy logits [(N, Hi, Wi, 1)])."""
        if single:
            feats = self._encode(x)
            occ = [getattr(self, f"single_head_{i}")(f)
                   for i, f in enumerate(feats)]
            return decode_levels(self, feats), occ
        b, l = x.shape[:2]
        feats = self._encode(x.reshape((b * l,) + x.shape[2:]))
        occ_maps, fused = [], []
        for i, f in enumerate(feats):
            occ = getattr(self, f"single_head_{i}")(f)
            occ_maps.append(occ)
            score = (torch.sigmoid(occ) + 1e-4).reshape(
                (b, l) + occ.shape[1:])
            if score_mask is not None:
                score = score * resize_nearest(score_mask, f.shape[1:3])
            fused.append(weighted_fuse(f.reshape((b, l) + f.shape[1:]),
                                       score, affine, agent_mask))
        return decode_levels(self, fused), occ_maps


class MsFusion(nn.Module):
    """``multiscale_ms``: the fusion backbone's level 0 is never run (the
    reference omits it), so it has no parameters."""

    def __init__(self, in_ch: int, layer_nums: Sequence[int],
                 layer_strides: Sequence[int], num_filters: Sequence[int],
                 upsample_strides: Sequence[int] = (),
                 num_upsample_filters: Sequence[int] = (),
                 fusion_method: str = "att"):
        super().__init__()
        self.layer_nums = tuple(max(n, 1) for n in layer_nums)
        add_levels(self, in_ch, layer_nums, layer_strides, num_filters,
                   BasicBlock, first=1)
        for i in range(len(layer_nums)):
            self.add_module(f"fuse{i}", MaxFusion() if fusion_method == "max"
                            else AttFusion())
        widths = [in_ch] + list(num_filters[1:])
        self.out_channels = add_deblocks(self, widths, upsample_strides,
                                         num_upsample_filters)

    @staticmethod
    def from_config(cfg: dict, in_ch: int,
                    fusion_method: str = "att") -> "MsFusion":
        return MsFusion(
            in_ch, cfg["layer_nums"], cfg["layer_strides"], cfg["num_filters"],
            cfg.get("upsample_strides", ()),
            cfg.get("num_upsample_filter", ()), fusion_method)

    def forward(self, x, affine, agent_mask):
        b, l = x.shape[:2]
        flat = x.reshape((b * l,) + x.shape[2:])
        feats = [flat]
        for i in range(1, len(self.layer_nums)):
            for k in range(self.layer_nums[i]):
                flat = getattr(self, f"layer{i}_{k}")(flat)
            feats.append(flat)
        fused = [getattr(self, f"fuse{i}")(f.reshape((b, l) + f.shape[1:]),
                                           affine, agent_mask)
                 for i, f in enumerate(feats)]
        return decode_levels(self, fused)
