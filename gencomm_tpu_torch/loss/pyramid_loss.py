"""Depth-supervised and HEAL pyramid losses.

Counterpart of ``gencomm_tpu/loss/pyramid_loss.py``:
``categorical_depth_focal`` and ``PointPillarDepthLoss`` (the detection
loss plus a focal cross entropy over the LSS depth bins), and
``PointPillarPyramidLoss`` (the detection and depth losses plus the
per-level occupancy focal loss of the HEAL pyramid, ``occ_loss``).

``PointPillarDepthLoss`` extends ``PointPillarLoss``, not the GenComm loss,
as in the reference: a ``generate_weight`` in its args is read by nothing,
so a camera stage-1 run trains the diffusion through the detection loss
only.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from gencomm_tpu_torch.loss.point_pillar_loss import (
    PointPillarLoss, per_agent_targets, sigmoid_focal_loss,
)


def categorical_depth_focal(logits, gt_indices, alpha: float = 0.25,
                            gamma: float = 2.0):
    """Focal cross entropy over the depth-bin axis. logits (..., D)
    channel-last, gt_indices (...) int -> per-pixel loss (...)."""
    logp = torch.log_softmax(logits, dim=-1)
    focal = -alpha * (1.0 - torch.softmax(logits, dim=-1)) ** gamma * logp
    return focal.gather(-1, gt_indices.long()[..., None]).squeeze(-1)


def _maxpool2d(x: torch.Tensor, k: int) -> torch.Tensor:
    """(N, H, W, C) max pool with kernel = stride = k ("VALID")."""
    if k == 1:
        return x
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, k).permute(0, 2, 3, 1)


class PointPillarDepthLoss(PointPillarLoss):
    """Detection loss plus ``depth.weight`` x the depth focal loss of every
    ``depth_items_<m>`` = (logits, gt_indices[, weight]) in the output. With
    a weight (the modality mask over the padded agent slots) the mean runs
    over the weighted pixels only. Entries without GT (bare logits, at
    inference) are skipped. A pass with a ``suffix`` reads only the items
    named ``depth_items<suffix>...``."""

    def __init__(self, args: dict):
        super().__init__(args)
        self.depth_weight = args.get("depth", {}).get("weight", 1.0)

    def __call__(self, output: dict, target: dict,
                 suffix: str = "") -> Dict[str, torch.Tensor]:
        losses = super().__call__(output, target, suffix)
        depth_loss = None
        for key, item in output.items():
            if not (key.startswith(f"depth_items{suffix}")
                    or (suffix == "" and key.startswith("depth_items_"))):
                continue
            if not isinstance(item, (tuple, list)) or len(item) < 2:
                continue
            per_px = categorical_depth_focal(item[0], item[1])
            if len(item) >= 3:
                w = item[2].expand(per_px.shape)
                mean = (per_px * w).sum() / w.sum().clamp_min(1.0)
            else:
                mean = per_px.mean()
            term = mean * self.depth_weight
            depth_loss = term if depth_loss is None else depth_loss + term
        if depth_loss is not None:
            losses["depth_loss"] = depth_loss
            losses["total_loss"] = losses["total_loss"] + depth_loss
        return losses


class PointPillarPyramidLoss(PointPillarDepthLoss):
    """Detection (and depth) loss plus the pyramid's per-level occupancy
    supervision. ``pyramid.mode`` ("collab" or "single", injected by
    ``create_loss`` from the model's ``core_method``) picks the case:
    collab, no suffix: the fused heads' detection loss; collab, "_single":
    the occupancy loss alone (``pyramid_loss`` and ``total_loss``) over
    every agent's maps; single: the detection loss over every agent's heads
    (B * L) plus the occupancy loss."""

    def __init__(self, args: dict):
        super().__init__(args)
        pyr = args["pyramid"]
        self.relative_downsample = pyr["relative_downsample"]
        self.pyramid_weight = pyr["weight"]
        self.mode = pyr.get("mode", "collab")

    def occ_loss(self, occ_list, pos_equal_one, neg_equal_one):
        """occ_list: [(N, Hi, Wi, 1)]; pos / neg_equal_one (N, H, W, A). A
        level's targets are the anchor map max-pooled by its
        ``relative_downsample``: occupied where any anchor is positive,
        negative where every anchor of every pooled cell is."""
        n = pos_equal_one.shape[0]
        occ_pos = (pos_equal_one > 0).any(dim=-1, keepdim=True).float()
        occ_neg = (neg_equal_one > 0).all(dim=-1, keepdim=True).float()
        total = 0.0
        for i, occ_pred in enumerate(occ_list):
            k = self.relative_downsample[i]
            pos_l = _maxpool2d(occ_pos, k).reshape(n, -1, 1)
            neg_l = (1.0 - _maxpool2d(1.0 - occ_neg, k)).reshape(n, -1, 1)
            pos_norm = pos_l.sum(dim=1, keepdim=True).clamp_min(1.0)
            weights = (pos_l * self.pos_cls_weight + neg_l * 1.0) / pos_norm
            loss = sigmoid_focal_loss(
                occ_pred.reshape(n, -1, 1), pos_l, weights,
                alpha=self.cls["alpha"], gamma=self.cls["gamma"]).sum() / n
            total = total + loss * self.pyramid_weight[i]
        return total

    def __call__(self, output: dict, target: dict,
                 suffix: str = "") -> Dict[str, torch.Tensor]:
        if self.mode == "collab" and suffix == "":
            return super().__call__(output, target, suffix)
        tgt = per_agent_targets(target)
        occ = self.occ_loss(output["occ_single_list"], tgt["pos_equal_one"],
                            tgt["neg_equal_one"])
        if self.mode == "collab":
            return {"pyramid_loss": occ, "total_loss": occ}
        losses = super().__call__(output, tgt, suffix)
        losses["pyramid_loss"] = occ
        losses["total_loss"] = losses["total_loss"] + occ
        return losses
