"""V2X-Real's multi-class detection losses.

Counterpart of ``gencomm_tpu/loss/v2xreal_loss.py``: a per-anchor
multi-class sigmoid focal loss (alpha 0.25, gamma 2) against one-hot
super-class targets (the label map holds -1 ignore, 0 negative, 1..C
positive), plus the smooth-L1 regression (sigma 3) with the sin-difference
yaw. No direction term: the multi-class labels have no ``neg_equal_one``
and the decode no direction head. The GenComm, codebook and MPDA variants
add the same terms as their single-class counterparts.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from gencomm_tpu_torch.loss.point_pillar_loss import (
    add_codebook_loss, add_domain_loss, add_generation_loss,
    add_sin_difference, weighted_smooth_l1,
)


class PointPillarV2XRealLoss:
    """Configured with the hypes ``loss.args`` dict: ``num_class``, the
    classification weight (``cls.weight`` or ``cls_weight``) and the
    regression weight (``reg.weight`` or ``reg``)."""

    alpha = 0.25
    gamma = 2.0

    def __init__(self, args: dict):
        self.num_class = int(args["num_class"])
        cls = args.get("cls")
        self.cls_weight = (float(cls.get("weight", 1.0))
                           if isinstance(cls, dict)
                           else float(args.get("cls_weight", 1.0)))
        reg = args.get("reg", 2.0)
        self.reg_coe = (float(reg.get("weight", 2.0))
                        if isinstance(reg, dict) else float(reg))

    def __call__(self, output: dict, target: dict,
                 suffix: str = "") -> Dict[str, torch.Tensor]:
        """output: cls_preds (B, H, W, A*C*C), reg_preds (B, H, W, A*C*7);
        target: pos_equal_one (B, H, W, A*C) of -1 / 0 / class ids, targets
        (B, H, W, A*C*7)."""
        C = self.num_class
        cls_preds = output[f"cls_preds{suffix}"]
        b = cls_preds.shape[0]
        dt = cls_preds.dtype

        labels = target["pos_equal_one"].reshape(b, -1)  # (B, N)
        positives = labels > 0
        pos_norm = positives.sum(dim=1, keepdim=True).to(dt).clamp_min(1.0)
        cls_weights = ((labels == 0) | positives).to(dt) / pos_norm
        reg_weights = positives.to(dt) / pos_norm

        # the class index of a positive, 0 for the rest; column 0 (the
        # background) dropped
        one_hot = F.one_hot((labels * (labels >= 0)).to(torch.int64),
                            C + 1)[..., 1:].to(dt)
        logits = cls_preds.reshape(b, -1, C)
        prob = torch.sigmoid(logits)
        alpha_w = one_hot * self.alpha + (1 - one_hot) * (1 - self.alpha)
        pt = one_hot * (1.0 - prob) + (1.0 - one_hot) * prob
        bce = (logits.clamp_min(0) - logits * one_hot
               + torch.log1p(torch.exp(-logits.abs())))
        cls_loss = (alpha_w * pt ** self.gamma * bce
                    * cls_weights[..., None]).sum() / b * self.cls_weight

        reg_enc, tgt_enc = add_sin_difference(
            output[f"reg_preds{suffix}"].reshape(b, -1, 7),
            target["targets"].reshape(b, -1, 7))
        reg_loss = weighted_smooth_l1(reg_enc, tgt_enc, reg_weights[..., None],
                                      sigma=3.0).sum() / b * self.reg_coe
        return {"cls_loss": cls_loss, "reg_loss": reg_loss,
                "total_loss": cls_loss + reg_loss}


class PointPillarV2XRealGenCommLoss(PointPillarV2XRealLoss):
    """Plus ``generate_weight`` x the generation MSE."""

    def __init__(self, args: dict):
        super().__init__(args)
        self.generate_weight = float(args.get("generate_weight", 1.0))

    def __call__(self, output: dict, target: dict,
                 suffix: str = "") -> Dict[str, torch.Tensor]:
        return add_generation_loss(super().__call__(output, target, suffix),
                                   output, self.generate_weight)


class PointPillarV2XRealCodebookLoss(PointPillarV2XRealLoss):
    """Plus CodeFilling's codebook loss."""

    def __call__(self, output: dict, target: dict,
                 suffix: str = "") -> Dict[str, torch.Tensor]:
        return add_codebook_loss(super().__call__(output, target, suffix),
                                 output)


class PointPillarV2XRealMPDALoss(PointPillarV2XRealLoss):
    """Plus MPDA's domain BCE."""

    def __call__(self, output: dict, target: dict,
                 suffix: str = "") -> Dict[str, torch.Tensor]:
        return add_domain_loss(super().__call__(output, target, suffix),
                               output, target)
