"""Depth-supervised detection loss of the camera models.

Counterpart of ``gencomm_tpu/loss/pyramid_loss.py`` l.32-82
(``categorical_depth_focal``, ``PointPillarDepthLoss``): the detection loss
plus a focal cross entropy over the LSS depth bins.
``PointPillarPyramidLoss`` is not ported yet.

``PointPillarDepthLoss`` extends ``PointPillarLoss``, not the GenComm loss,
as in the reference: a ``generate_weight`` in its args is read by nothing,
so a camera stage-1 run trains the diffusion through the detection loss
only.
"""

from __future__ import annotations

from typing import Dict

import torch

from gencomm_tpu_torch.loss.point_pillar_loss import PointPillarLoss


def categorical_depth_focal(logits, gt_indices, alpha: float = 0.25,
                            gamma: float = 2.0):
    """Focal cross entropy over the depth-bin axis. logits (..., D)
    channel-last, gt_indices (...) int -> per-pixel loss (...)."""
    logp = torch.log_softmax(logits, dim=-1)
    focal = -alpha * (1.0 - torch.softmax(logits, dim=-1)) ** gamma * logp
    return focal.gather(-1, gt_indices.long()[..., None]).squeeze(-1)


class PointPillarDepthLoss(PointPillarLoss):
    """Detection loss plus ``depth.weight`` x the depth focal loss of every
    ``depth_items_<m>`` = (logits, gt_indices[, weight]) in the output. With
    a weight (the modality mask over the padded agent slots) the mean runs
    over the weighted pixels only. Entries without GT (bare logits, at
    inference) are skipped."""

    def __init__(self, args: dict):
        super().__init__(args)
        self.depth_weight = args.get("depth", {}).get("weight", 1.0)

    def __call__(self, output: dict, target: dict) -> Dict[str, torch.Tensor]:
        losses = super().__call__(output, target)
        depth_loss = None
        for key, item in output.items():
            if not key.startswith("depth_items_"):
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
