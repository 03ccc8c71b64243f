"""PointPillars detection loss and its GenComm and DiscoNet variants.

Counterpart of ``gencomm_tpu/loss/point_pillar_loss.py``
(``sigmoid_focal_loss``, ``weighted_smooth_l1``, ``add_sin_difference``,
``direction_targets``, ``PointPillarLoss``, ``PointPillarGenCommLoss``,
``PointPillarDiscoNetLoss``, ``PointPillarCodebookLoss``,
``PointPillarMPDALoss``, ``AdapterLoss``): sigmoid focal classification,
weighted smooth-L1 regression with the sin-difference yaw, softmax
direction-bin cross entropy, the GenComm generation MSE, DiscoNet's
distillation KL, CodeFilling's codebook MSE, MPDA's domain BCE and STAMP's
adapter cycle loss.
Prediction maps are channel-last (B, H', W', C).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gencomm_tpu_torch.utils.box_utils import limit_period


def sigmoid_focal_loss(logits, targets, weights, alpha: float, gamma: float):
    """Elementwise focal loss on logits."""
    per_entry = (logits.clamp_min(0) - logits * targets
                 + torch.log1p(torch.exp(-logits.abs())))
    prob = torch.sigmoid(logits)
    p_t = targets * prob + (1 - targets) * (1 - prob)
    modulating = (1.0 - p_t) ** gamma
    alpha_w = targets * alpha + (1 - targets) * (1 - alpha)
    return modulating * alpha_w * per_entry * weights


def weighted_smooth_l1(preds, targets, weights, sigma: float = 3.0):
    abs_diff = (preds - targets).abs()
    lt = (abs_diff <= 1.0 / sigma ** 2).to(preds.dtype)
    loss = (lt * 0.5 * (abs_diff * sigma) ** 2
            + (abs_diff - 0.5 / sigma ** 2) * (1 - lt))
    return loss * weights


def add_sin_difference(preds, targets):
    """Encode the yaw channel as the two halves of sin(a - b)."""
    rad_pred = torch.sin(preds[..., 6:7]) * torch.cos(targets[..., 6:7])
    rad_tg = torch.cos(preds[..., 6:7]) * torch.sin(targets[..., 6:7])
    return (torch.cat([preds[..., :6], rad_pred], dim=-1),
            torch.cat([targets[..., :6], rad_tg], dim=-1))


def direction_targets(reg_targets, anchor_yaw_deg, dir_offset: float,
                      num_bins: int):
    """One-hot direction-bin targets. reg_targets (B, N, 7) with N =
    H' * W' * A; anchor_yaw_deg (A,) in degrees."""
    anchor_yaw = torch.as_tensor(
        np.radians(np.asarray(anchor_yaw_deg)).astype(np.float32),
        device=reg_targets.device)
    n = reg_targets.shape[1]
    anchor_map = anchor_yaw.repeat(n // anchor_yaw.shape[0])
    rot_gt = reg_targets[..., 6] + anchor_map[None, :]
    offset_rot = limit_period(rot_gt - dir_offset, 0.0, 2 * np.pi)
    bins = torch.floor(offset_rot / (2 * np.pi / num_bins)).long()
    bins = bins.clamp(0, num_bins - 1)
    return torch.nn.functional.one_hot(bins, num_bins).to(reg_targets.dtype)


def per_agent_targets(target: dict) -> dict:
    """The target with the per-agent labels (``<label>_single``, (B, L,
    ...)) as its labels, flattened to the B * L agents of per-agent heads,
    where it has them."""
    if "pos_equal_one_single" not in target:
        return target
    return dict(target, **{
        k: target[f"{k}_single"].reshape(
            (-1,) + tuple(target[f"{k}_single"].shape[2:]))
        for k in ("pos_equal_one", "neg_equal_one", "targets")})


class PointPillarLoss:
    """Configured with the hypes ``loss.args`` dict."""

    def __init__(self, args: dict):
        self.pos_cls_weight = args["pos_cls_weight"]
        self.cls = args["cls"]
        self.reg = args["reg"]
        self.dir = args.get("dir")

    def __call__(self, output: dict, target: dict,
                 suffix: str = "") -> Dict[str, torch.Tensor]:
        """output: cls_preds (B, H, W, A), reg_preds (B, H, W, A*7),
        dir_preds (B, H, W, A*nb); target: pos/neg_equal_one (B, H, W, A),
        targets (B, H, W, A*7). Returns the scalar losses. With ``suffix``
        the heads ``<key><suffix>`` are read; a "_single" pass (per-agent
        heads over B * L) reads the per-agent labels ``<label>_single``
        where the target has them, their (B, L) lead flattened."""
        if suffix == "_single":
            target = per_agent_targets(target)
        cls_preds = output[f"cls_preds{suffix}"]
        b = cls_preds.shape[0]
        dt = cls_preds.dtype

        cls_labels = target["pos_equal_one"].reshape(b, -1, 1)
        positives = cls_labels > 0
        negatives = target["neg_equal_one"].reshape(b, -1, 1) > 0
        pos_norm = positives.sum(dim=1, keepdim=True).to(dt).clamp_min(1.0)

        cls_weights = (positives.to(dt) * self.pos_cls_weight
                       + negatives.to(dt) * 1.0) / pos_norm
        cls_loss = sigmoid_focal_loss(
            cls_preds.reshape(b, -1, 1), cls_labels.to(dt), cls_weights,
            alpha=self.cls["alpha"], gamma=self.cls["gamma"],
        ).sum() * self.cls["weight"] / b

        reg_weights = positives.to(dt) / pos_norm
        reg_targets = target["targets"].reshape(b, -1, 7)
        reg_enc, tgt_enc = add_sin_difference(
            output[f"reg_preds{suffix}"].reshape(b, -1, 7), reg_targets)
        reg_loss = weighted_smooth_l1(
            reg_enc, tgt_enc, reg_weights, sigma=self.reg["sigma"],
        ).sum() * self.reg["weight"] / b

        losses = {"cls_loss": cls_loss, "reg_loss": reg_loss}
        total = cls_loss + reg_loss
        if self.dir is not None:
            num_bins = self.dir["args"]["num_bins"]
            dir_logits = output[f"dir_preds{suffix}"].reshape(b, -1, num_bins)
            dir_tgt = direction_targets(
                reg_targets, self.dir["args"]["anchor_yaw"],
                self.dir["args"]["dir_offset"], num_bins)
            ce = -(dir_tgt * torch.log_softmax(dir_logits, dim=-1)).sum(-1)
            dir_loss = ((ce * reg_weights.squeeze(-1)).sum()
                        * self.dir["weight"] / b)
            losses["dir_loss"] = dir_loss
            total = total + dir_loss
        losses["total_loss"] = total
        return losses


class PointPillarGenCommLoss(PointPillarLoss):
    """Detection loss plus ``generate_weight`` x the generation MSE between
    the encoder's feature and the generated one. ``gt_feature`` is not
    detached (the reference's gradients reach the encoder through it too);
    with ``feature_mask`` (valid agent slots) the MSE is normalized by the
    valid slots times H * W * C."""

    def __init__(self, args: dict):
        super().__init__(args)
        self.generate_weight = args.get("generate_weight", 1.0)

    def __call__(self, output: dict, target: dict,
                 suffix: str = "") -> Dict[str, torch.Tensor]:
        losses = super().__call__(output, target, suffix)
        if "pred_feature" in output and "gt_feature" in output:
            pred = output["pred_feature"].to(torch.float32)
            gt = output["gt_feature"].to(torch.float32)
            err = (pred - gt) ** 2
            mask = output.get("feature_mask")
            if mask is not None:
                m = mask.reshape(mask.shape + (1,) * (err.dim() - mask.dim()))
                err = err * m.to(err.dtype)
                per_slot = int(np.prod(err.shape[mask.dim():]))
                denom = (m.to(err.dtype).sum() * per_slot).clamp_min(1.0)
                gen_loss = err.sum() / denom
            else:
                gen_loss = err.mean()
            gen_loss = gen_loss * self.generate_weight
            losses["gen_loss"] = gen_loss
            losses["total_loss"] = losses["total_loss"] + gen_loss
        return losses


class PointPillarDiscoNetLoss(PointPillarLoss):
    """DiscoNet distillation: the detection loss plus ``kd`` weight x
    KL(softmax(teacher) || softmax(student)) over the channel axis of the
    fused feature, with the teacher detached and ``q + 1e-12`` inside the
    log. The reduction is torch ``KLDivLoss``'s elementwise mean, over N * H
    * W * C (``gencomm_tpu/loss/point_pillar_loss.py:197-200``)."""

    def __init__(self, args: dict):
        super().__init__(args)
        kd = args.get("kd")
        self.kd_weight = (kd.get("weight", 1.0) if isinstance(kd, dict)
                          else args.get("kd", 1.0))

    def __call__(self, output: dict, target: dict,
                 suffix: str = "") -> Dict[str, torch.Tensor]:
        losses = super().__call__(output, target, suffix)
        if "teacher_feature" in output and "student_feature" in output:
            c = output["teacher_feature"].shape[-1]
            t = output["teacher_feature"].reshape(-1, c).detach()
            s = output["student_feature"].reshape(-1, c)
            q = torch.softmax(t, dim=-1)
            kd = (q * (torch.log(q + 1e-12) - torch.log_softmax(s, dim=-1))
                  ).mean() * self.kd_weight
            losses["kd_loss"] = kd
            losses["total_loss"] = losses["total_loss"] + kd
        return losses


class PointPillarCodebookLoss(PointPillarLoss):
    """Detection loss plus CodeFilling's codebook reconstruction MSE
    (``codebook_loss`` of the output), unit weight."""

    def __call__(self, output: dict, target: dict,
                 suffix: str = "") -> Dict[str, torch.Tensor]:
        losses = super().__call__(output, target, suffix)
        if "codebook_loss" in output:
            losses["codebook_loss"] = output["codebook_loss"]
            losses["total_loss"] = losses["total_loss"] + output["codebook_loss"]
        return losses


class PointPillarMPDALoss(PointPillarLoss):
    """Detection loss plus MPDA's domain BCE on the per-pixel logits
    ``da_feature`` (B, L, H, W, 1): target 1 on the ego's slot, 0 on the
    collaborators', averaged over the valid slots (``agent_mask`` of the
    target) times H * W, else over every entry. The gradient reversal in
    ``DAImgHead`` makes it adversarial for the features."""

    def __call__(self, output: dict, target: dict,
                 suffix: str = "") -> Dict[str, torch.Tensor]:
        losses = super().__call__(output, target, suffix)
        if "da_feature" in output:
            logits = output["da_feature"]
            l = logits.shape[1]
            labels = (torch.arange(l, device=logits.device) == 0).to(
                logits.dtype)[None, :, None, None, None].expand(logits.shape)
            bce = (logits.clamp_min(0) - logits * labels
                   + torch.log1p(torch.exp(-logits.abs())))
            mask = target.get("agent_mask")
            if mask is not None:
                m = mask[:, :, None, None, None].to(logits.dtype)
                per_slot = int(np.prod(logits.shape[2:]))
                da = (bce * m).sum() / (m.sum() * per_slot).clamp_min(1.0)
            else:
                da = bce.mean()
            losses["da_loss"] = da
            losses["total_loss"] = losses["total_loss"] + da
        return losses


class AdapterLoss:
    """STAMP's cycle-consistency loss, summed over the non-ego modalities
    m: alpha_P2M MSE(FM, P2M) + alpha_M2P2M MSE(FM, M2P2M) + alpha_M2P
    MSE(FP, M2P), from the output's ``stamp_*`` tensors. The weights are
    read as ``alpha_P2M`` / ``alpha_M2P2M`` / ``alpha_M2P`` (default 1), as
    the JAX package reads them."""

    def __init__(self, args: dict):
        self.alpha_p2m = args.get("alpha_P2M", 1.0)
        self.alpha_m2p2m = args.get("alpha_M2P2M", 1.0)
        self.alpha_m2p = args.get("alpha_M2P", 1.0)

    def __call__(self, output: dict, target: dict,
                 suffix: str = "") -> Dict[str, torch.Tensor]:
        fp = output["stamp_FP"]
        total = 0.0
        losses = {}
        for key in output:
            if not key.startswith("stamp_FM_"):
                continue
            m = key[len("stamp_FM_"):]
            fm = output[key]
            p2m = torch.mean((fm - output[f"stamp_P2M_{m}"]) ** 2)
            m2p2m = torch.mean((fm - output[f"stamp_M2P2M_{m}"]) ** 2)
            m2p = torch.mean((fp - output[f"stamp_M2P_{m}"]) ** 2)
            losses[f"P2M_{m}"] = p2m
            losses[f"M2P2M_{m}"] = m2p2m
            losses[f"M2P_{m}"] = m2p
            total = total + (self.alpha_p2m * p2m + self.alpha_m2p2m * m2p2m
                             + self.alpha_m2p * m2p)
        losses["total_loss"] = total
        return losses
