"""Heterogeneous collaboration model, GenComm stage-1 eval path.

Counterpart of ``gencomm_tpu/models/heter_baseline.py`` (``ModalityBranch``,
``HeterModel.__call__``) restricted to: host-decorated point_pillar
modalities, ``use_gencomm`` (message extractor + conditional DDPM),
``use_enhancer`` and ``att`` fusion, fp32 activations. Every other branch
raises ``NotImplementedError``. Inputs are padded ``(B, L, ...)`` tensors with
masks, agent slot 0 the ego; submodule names follow the flax auto-names so
``weights.py`` can carry JAX parameters across.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
from torch import nn

from gencomm_tpu_torch import resolve_device
from gencomm_tpu_torch.models.backbones.bev_backbone import BEVBackbone
from gencomm_tpu_torch.models.encoders.point_pillar import PointPillarEncoder
from gencomm_tpu_torch.models.fuse.fusion import build_fusion
from gencomm_tpu_torch.models.gencomm.diffusion import GenCommDiffusion
from gencomm_tpu_torch.models.gencomm.enhancer import Enhancer
from gencomm_tpu_torch.models.gencomm.message_extractor import MessageExtractor
from gencomm_tpu_torch.models.heads import DetectionHeads
from gencomm_tpu_torch.models.layers import DownsampleConv
from gencomm_tpu_torch.utils.transformation_utils import normalize_pairwise_tfm


class ModalityBranch(nn.Module):
    """encoder -> backbone -> shrinker for one lidar modality."""

    def __init__(self, encoder_args: Dict[str, Any],
                 backbone_args: Dict[str, Any], shrink_args: Dict[str, Any],
                 core_method: str = "point_pillar"):
        super().__init__()
        if core_method != "point_pillar":
            raise NotImplementedError(
                f"encoder {core_method!r} is not ported yet")
        self.encoder = PointPillarEncoder(
            voxel_size=tuple(encoder_args["voxel_size"]),
            lidar_range=tuple(encoder_args["lidar_range"]),
            num_filters=tuple(encoder_args["pillar_vfe"]["num_filters"]),
            use_norm=encoder_args["pillar_vfe"].get("use_norm", True))
        self.backbone = BEVBackbone(
            self.encoder.out_channels,
            layer_nums=backbone_args["layer_nums"],
            layer_strides=backbone_args["layer_strides"],
            num_filters=backbone_args["num_filters"],
            upsample_strides=backbone_args.get("upsample_strides", ()),
            num_upsample_filters=backbone_args.get("num_upsample_filter", ()))
        self.shrinker = DownsampleConv(
            self.backbone.out_channels, dims=shrink_args["dim"],
            kernels=shrink_args["kernal_size"], strides=shrink_args["stride"])
        self.out_channels = shrink_args["dim"][-1]

    def forward(self, decorated, gids, dvalid):
        canvas = self.encoder(decorated, gids, dvalid)  # (B, L, ny, nx, C) bf16
        b, l = canvas.shape[:2]
        # the neck runs in fp32 on the bf16 canvas values, as flax promotes
        feat = self.shrinker(self.backbone(
            canvas.reshape((b * l,) + canvas.shape[2:]).float()))
        return feat.reshape((b, l) + feat.shape[1:])


class HeterModel(nn.Module):
    """Stage-1 GenComm model; runs on ``device`` (default ``cuda``)."""

    def __init__(self, modality_args: Dict[str, Dict[str, Any]],
                 fusion_method: str, lidar_range: Tuple[float, ...],
                 anchor_number: int = 2, num_class: int = 1, dir_bins: int = 2,
                 use_gencomm: bool = False, use_enhancer: bool = False,
                 enhancer_use_attn: bool = False, message_ch: int = 2,
                 gencomm_timesteps: int = 3, unet_ch: int = 8,
                 unet_ch_mult: Sequence[int] = (1, 1),
                 unet_num_res_blocks: int = 2, half: bool = False,
                 device=None):
        super().__init__()
        if half:
            raise NotImplementedError("bf16 activations (half=True) are not "
                                      "ported yet")
        if num_class != 1:
            raise NotImplementedError("multi-class heads are not ported yet")
        if use_enhancer and not use_gencomm:
            raise NotImplementedError("the Enhancer runs only after GenComm")
        device = resolve_device(device)
        self.lidar_range = tuple(lidar_range)
        self.use_gencomm, self.use_enhancer = use_gencomm, use_enhancer
        self.message_ch = message_ch
        self.modalities = list(modality_args)
        feat_ch = None
        for mname, margs in modality_args.items():
            if margs.get("sensor_type", "lidar") != "lidar":
                raise NotImplementedError("camera modalities are not ported yet")
            branch = ModalityBranch(margs["encoder_args"], margs["backbone_args"],
                                    margs["shrink_header"],
                                    margs.get("core_method", "point_pillar"))
            self.add_module(f"branch_{mname}", branch)
            feat_ch = branch.out_channels
            if use_gencomm:
                self.add_module(f"message_extractor_{mname}",
                                MessageExtractor(feat_ch, message_ch))
        if use_gencomm:
            self.gencomm = GenCommDiffusion(
                feat_ch=feat_ch, msg_ch=message_ch,
                num_timesteps=gencomm_timesteps, unet_ch=unet_ch,
                unet_ch_mult=unet_ch_mult,
                unet_num_res_blocks=unet_num_res_blocks)
        if use_enhancer:
            self.enhancer = Enhancer(feat_ch, use_attn=enhancer_use_attn)
        self.fusion_net = build_fusion(fusion_method)
        self.heads = DetectionHeads(feat_ch, anchor_number, dir_bins)
        self.eval()
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.heads.cls_head.weight.device

    def forward(self, batch: Dict[str, torch.Tensor], noises=None,
                generator: torch.Generator | None = None) -> Dict[str, Any]:
        """batch: tensors on the model's device (``agent_mask``,
        ``pairwise_t_matrix``, ``modality_mask_<m>`` and the decorated
        fields ``decorated_<m>``, ``gids_<m>``, ``dvalid_<m>``). ``noises``
        or ``generator`` feed the diffusion (see GenCommDiffusion)."""
        out: Dict[str, Any] = {}
        agent_mask = batch["agent_mask"].bool()
        b, l = agent_mask.shape
        hm = self.lidar_range[4] - self.lidar_range[1]
        wm = self.lidar_range[3] - self.lidar_range[0]
        affine = normalize_pairwise_tfm(
            batch["pairwise_t_matrix"].to(torch.float32), hm, wm, 1.0)

        feature = message = None
        for mname in self.modalities:
            if f"decorated_{mname}" not in batch:
                raise NotImplementedError(
                    "raw-point input is not ported; decorate the points on "
                    "the host (gencomm_tpu_torch.data.decorate)")
            feat = getattr(self, f"branch_{mname}")(
                batch[f"decorated_{mname}"], batch[f"gids_{mname}"],
                batch[f"dvalid_{mname}"].bool())
            mmask = batch[f"modality_mask_{mname}"].to(feat.dtype)[
                ..., None, None, None]
            contrib = feat * mmask
            feature = contrib if feature is None else feature + contrib
            if self.use_gencomm:
                flat = feat.reshape((b * l,) + feat.shape[2:])
                msg = getattr(self, f"message_extractor_{mname}")(flat)
                msg = msg.reshape((b, l) + feat.shape[2:-1] + (self.message_ch,))
                mcontrib = msg * mmask
                message = mcontrib if message is None else message + mcontrib

        hw = tuple(feature.shape[2:4])
        if self.use_gencomm:
            out["message"] = message
            # only `message` crosses agents; generation starts from the ego
            ego_bc = feature[:, 0:1].expand(feature.shape).reshape(
                (b * l,) + feature.shape[2:])
            cond = message.reshape((b * l,) + hw + (self.message_ch,))
            pred = self.gencomm(ego_bc, cond, noises=noises, generator=generator)
            out["gt_feature"] = feature.reshape(pred.shape)
            out["pred_feature"] = pred
            out["feature_mask"] = agent_mask.reshape(-1)
            fused_in = self.enhancer(pred) if self.use_enhancer else pred
            feature = fused_in.reshape((b, l) + hw + (pred.shape[-1],))

        fused = self.fusion_net(feature, affine, agent_mask)
        out["feature"] = fused
        cls_preds, reg_preds, dir_preds = self.heads(fused.to(torch.float32))
        out.update(cls_preds=cls_preds, reg_preds=reg_preds,
                   dir_preds=dir_preds)
        return out
