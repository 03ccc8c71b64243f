"""The legacy SECOND detectors, ``second`` and ``second_intermediate``.

Counterpart of ``SecondModel`` and ``_SecondTrunk`` in
``gencomm_tpu/models/ciassd.py`` (the reference's second.py and
second_intermediate.py): the SECOND encoder on modality ``m1``'s raw points
(``models/encoders/second.py``, ``out_ch`` 128), the multiscale BEV
backbone and two 1x1 heads, classification and regression (no direction
head). ``second`` runs every agent slot as a sample of its own, so its
heads are (B * L, H, W, .); ``second_intermediate`` fuses the agents at
every backbone level by attentive fusion (kernel K3's warp) before that
level's decode, the unfused maps going on through the levels, so its heads
are (B, H, W, .). CIA-SSD and SECOND-SSFA (the SSFA neck) are not ported.
The model keeps ``HeterModel``'s interface for the pipeline and the
trainer (``device``, ``modalities``, ``heads_single``, ``use_gencomm``,
``agent_buckets``, ``lidar_encoder``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from gencomm_tpu_torch import resolve_device
from gencomm_tpu_torch.data.bucketing import AGENT_BUCKETS
from gencomm_tpu_torch.models.backbones.bev_backbone import BEVBackbone
from gencomm_tpu_torch.models.encoders.second import SECONDEncoder
from gencomm_tpu_torch.models.fuse.fusion import AttFusion
from gencomm_tpu_torch.models.layers import Conv
from gencomm_tpu_torch.utils.transformation_utils import normalize_pairwise_tfm


class _SecondTrunk(nn.Module):
    """The SECOND voxel branch -> flat (B * L, H, W, C) BEV features."""

    def __init__(self, voxel_size, lidar_range, max_voxels: int = 32000,
                 out_ch: int = 128):
        super().__init__()
        self.encoder = SECONDEncoder(voxel_size, lidar_range,
                                     voxel_capacity_per_agent=max_voxels,
                                     out_ch=out_ch)

    def forward(self, batch):
        canvas = self.encoder(batch["points_m1"], batch["point_mask_m1"])
        b, l = canvas.shape[:2]
        return canvas.reshape((b * l,) + canvas.shape[2:]), (b, l)


class SecondModel(nn.Module):
    """SECOND, the BEV backbone and cls / reg heads; runs on ``device``
    (default ``cuda``)."""

    use_gencomm = False
    heads_single = None
    modalities = ("m1",)
    agent_buckets = AGENT_BUCKETS

    def __init__(self, voxel_size: Tuple[float, float, float],
                 lidar_range: Tuple[float, ...], backbone_args: Dict[str, Any],
                 anchor_num: int = 2, max_voxels: int = 32000,
                 intermediate: bool = False, device=None):
        super().__init__()
        self.lidar_range = tuple(lidar_range)
        self.intermediate = intermediate
        self.trunk = _SecondTrunk(voxel_size, lidar_range, max_voxels)
        self.backbone = BEVBackbone(
            self.trunk.encoder.out_channels,
            layer_nums=backbone_args["layer_nums"],
            layer_strides=backbone_args["layer_strides"],
            num_filters=backbone_args["num_filters"],
            upsample_strides=backbone_args.get("upsample_strides", ()),
            num_upsample_filters=backbone_args.get("num_upsample_filter", ()))
        # the per-level fusion has no parameters
        self.level_fusion = AttFusion() if intermediate else None
        ch = self.backbone.out_channels
        self.cls_head = Conv(ch, anchor_num, 1)
        self.reg_head = Conv(ch, 7 * anchor_num, 1)
        self.eval()
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.cls_head.weight.device

    def lidar_encoder(self, mname: str):
        return self.trunk.encoder

    def forward(self, batch, noises=None, generator=None):
        """``points_m1``, ``point_mask_m1`` (and, intermediate,
        ``pairwise_t_matrix`` and ``agent_mask``) -> cls_preds, reg_preds.
        ``noises`` and ``generator`` are accepted for the pipeline's and
        the trainer's calls; nothing is drawn."""
        flat, (b, l) = self.trunk(batch)
        level_fuse = None
        if self.intermediate:
            hm = self.lidar_range[4] - self.lidar_range[1]
            wm = self.lidar_range[3] - self.lidar_range[0]
            affine = normalize_pairwise_tfm(
                batch["pairwise_t_matrix"].to(torch.float32), hm, wm, 1.0)
            agent_mask = batch["agent_mask"].bool()

            def level_fuse(i, f):
                return self.level_fusion(f.reshape((b, l) + f.shape[1:]),
                                         affine, agent_mask)

        feat = self.backbone(flat, level_fuse=level_fuse)
        return {"cls_preds": self.cls_head(feat),
                "reg_preds": self.reg_head(feat)}


def build_second_model(hypes: dict, device=None) -> SecondModel:
    """``SecondModel`` from a hypes dict, as the JAX ``create_model`` builds
    it for a ``second`` or ``second_intermediate`` core."""
    args = hypes["model"]["args"]
    core = hypes["model"]["core_method"].lower()
    return SecondModel(
        voxel_size=tuple(args["voxel_size"]),
        lidar_range=tuple(args["lidar_range"]),
        backbone_args=args["base_bev_backbone"],
        anchor_num=args.get("anchor_number", args.get("anchor_num", 2)),
        max_voxels=args.get("max_voxels", 32000),
        intermediate="intermediate" in core, device=device)
