"""HEAL pyramid models: collaborative and single, and the multiscale
baseline.

Counterpart of ``gencomm_tpu/models/heter_pyramid.py``. Each modality's
branch is its encoder (``enc_branch_<m>``, the lidar ``ModalityBranch``
with ``encode_only``; ``encoder_<m>``, the LSS camera encoder), a ResNet
BEV backbone (``backbone_<m>``) and an aligner (``aligner_<m>``, the
identity); a camera's map is centre-cropped or padded to the lidar range.
The branches' features are combined by the modality masks over the padded
(B, L) agent slots.

``HeterPyramidModel`` (``heter_pyramid_collab`` / ``heter_pyramid_single``)
then optionally compresses the feature (``compressor``), runs the HEAL
pyramid (``pyramid_backbone``): collab, every agent's levels fused in the
ego frame with occupancy weights, a camera agent's scores masked to its
field of view at eval only; single, every agent alone, its heads over B *
L. Then the optional shrink header and the heads. The output also holds
``occ_single_list``, the per-level occupancy logits over B * L agents, for
``point_pillar_pyramid_loss``.

``HeterMsModel`` (``heter_model_baseline_ms``) fuses the same branches with
``MsFusion`` (max or attentive fusion per level of a shared ResNet
backbone), with per-agent heads (``heads_single``) under
``supervise_single``.

Both models run fp32 on ``device`` (default ``cuda``), are built in
``eval()`` (``train()`` switches their norms to batch statistics) and take
the interface of ``HeterModel`` that ``InferencePipeline``, the trainer and
the tools use: ``forward(batch, noises=None, generator=None)`` (no
diffusion: ``noises`` and ``generator`` are accepted and unused),
``device``, ``modalities``, ``heads_single``, ``use_gencomm`` (False),
``agent_buckets`` and ``lidar_encoder``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from gencomm_tpu_torch import resolve_device
from gencomm_tpu_torch.data.bucketing import AGENT_BUCKETS
from gencomm_tpu_torch.models.aligners import AlignNet
from gencomm_tpu_torch.models.backbones.resnet_bev import ResNetBEVBackbone
from gencomm_tpu_torch.models.encoders.lss import (
    LSSEncoder, center_crop_or_pad,
)
from gencomm_tpu_torch.models.fuse.pyramid import MsFusion, PyramidFusion
from gencomm_tpu_torch.models.heads import DetectionHeads
from gencomm_tpu_torch.models.heter_baseline import (
    ModalityBranch, lidar_inputs,
)
from gencomm_tpu_torch.models.layers import DownsampleConv, NaiveCompressor
from gencomm_tpu_torch.utils.transformation_utils import normalize_pairwise_tfm

_CAMERA_KEYS = ("imgs", "rots", "trans", "intrins", "post_rots", "post_trans")


def camera_fov_mask(shape_hw, crop_ratio_h: float, crop_ratio_w: float,
                    device=None) -> torch.Tensor:
    """(H, W, 1) float mask, 1 inside the camera's field of view after the
    centre crop or pad: the centred box of (H / ratio_h - 4) x (W / ratio_w
    - 4) cells (the edge responses are unstable)."""
    h, w = shape_hw
    ch = int(h / crop_ratio_h) - 4
    cw = int(w / crop_ratio_w) - 4
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    inside = ((ys >= h // 2 - ch // 2) & (ys < h // 2 + ch // 2)
              & (xs >= w // 2 - cw // 2) & (xs < w // 2 + cw // 2))
    return inside.to(torch.float32)[..., None]


class _HeterBranches(nn.Module):
    """The modality branches and the shared parts of both models' forward."""

    use_gencomm = False
    agent_buckets = AGENT_BUCKETS

    def __init__(self, modality_args: Dict[str, Dict[str, Any]],
                 lidar_range: Tuple[float, ...]):
        super().__init__()
        self.heads_single = None
        self.lidar_range = tuple(lidar_range)
        self.modality_args = modality_args
        self.modalities = list(modality_args)
        self.feat_ch = None
        for m, margs in modality_args.items():
            enc = margs["encoder_args"]
            if margs.get("sensor_type", "lidar") == "camera":
                encoder = LSSEncoder(
                    grid_conf=enc["grid_conf"],
                    final_dim=tuple(enc["data_aug_conf"]["final_dim"]),
                    downsample=enc.get("img_downsample", 8),
                    feat_ch=enc.get("img_features", 128),
                    trunk_blocks=enc.get("trunk_blocks", 2),
                    trunk=enc.get("img_trunk", "tpu"),
                    depth_topk=enc.get("depth_topk", 0),
                    trunk_bf16=enc.get("trunk_bf16", False))
                self.add_module(f"encoder_{m}", encoder)
            else:
                encoder = ModalityBranch(
                    enc, None, None, margs.get("core_method", "point_pillar"),
                    encode_only=True)
                self.add_module(f"enc_branch_{m}", encoder)
            backbone = ResNetBEVBackbone.from_config(margs["backbone_args"],
                                                     encoder.out_channels)
            self.add_module(f"backbone_{m}", backbone)
            self.add_module(f"aligner_{m}", AlignNet.from_config(
                margs.get("aligner_args", {"core_method": "identity"})))
            if self.feat_ch not in (None, backbone.out_channels):
                raise ValueError("the modalities' features differ in width")
            self.feat_ch = backbone.out_channels

    @property
    def device(self) -> torch.device:
        return self.heads.cls_head.weight.device

    def lidar_encoder(self, mname: str):
        return getattr(self, f"enc_branch_{mname}").encoder

    def _is_camera(self, mname: str) -> bool:
        return self.modality_args[mname].get("sensor_type",
                                             "lidar") == "camera"

    def _ratios(self, grid_conf) -> Tuple[float, float]:
        """(h, w) ratio of the lidar range to a camera grid's extent."""
        return (self.lidar_range[4] / grid_conf["ybound"][1],
                self.lidar_range[3] / grid_conf["xbound"][1])

    def _branch(self, m: str, batch, out) -> torch.Tensor:
        """encoder -> backbone -> aligner (-> camera crop): (B, L, H, W, C)."""
        if self._is_camera(m):
            inputs = {k: batch[f"{k}_{m}"] for k in _CAMERA_KEYS}
            if f"depths_{m}" in batch:
                inputs["depths"] = batch[f"depths_{m}"]
            canvas, depth_logits = getattr(self, f"encoder_{m}")(inputs)
            if isinstance(depth_logits, tuple):
                logits, gt_idx = depth_logits
                wt = batch[f"modality_mask_{m}"].to(logits.dtype)[
                    :, :, None, None, None]
                out[f"depth_items_{m}"] = (logits, gt_idx, wt)
            elif depth_logits is not None:
                out[f"depth_items_{m}"] = depth_logits
        else:
            branch = getattr(self, f"enc_branch_{m}")
            canvas, _ = branch(lidar_inputs(branch, batch, m))
        b, l = canvas.shape[:2]
        # the bf16 pillar canvas promotes to fp32 at the first conv, as in
        # flax (SECOND's is fp32)
        flat = canvas.reshape((b * l,) + canvas.shape[2:]).float()
        feat = getattr(self, f"aligner_{m}")(getattr(self, f"backbone_{m}")(
            flat))
        feat = feat.reshape((b, l) + feat.shape[1:])
        if self._is_camera(m):
            # int(), not round(), as the JAX pyramid crops
            ratio_h, ratio_w = self._ratios(
                self.modality_args[m]["encoder_args"]["grid_conf"])
            feat = center_crop_or_pad(feat, (int(feat.shape[2] * ratio_h),
                                             int(feat.shape[3] * ratio_w)))
        return feat

    def _features(self, batch, out, score_masks: bool):
        """The modality-masked sum of the branches' features and, with
        ``score_masks``, the pyramid's score mask: each agent's camera field
        of view (ones for a lidar agent), by its modality."""
        b, l = batch["agent_mask"].shape
        feature = score_mask = None
        for m in self.modalities:
            feat = self._branch(m, batch, out)
            mmask = batch[f"modality_mask_{m}"].to(feat.dtype)[
                ..., None, None, None]
            contrib = feat * mmask
            feature = contrib if feature is None else feature + contrib
            if not score_masks:
                continue
            hw = tuple(feat.shape[2:4])
            if self._is_camera(m):
                fov = camera_fov_mask(hw, *self._ratios(
                    self.modality_args[m]["camera_mask_args"]["grid_conf"]),
                    device=feat.device)
            else:
                fov = torch.ones(hw + (1,), device=feat.device)
            sm = fov.expand((b, l) + hw + (1,)) * mmask
            score_mask = sm if score_mask is None else score_mask + sm
        return feature, score_mask

    def _affine(self, batch) -> torch.Tensor:
        hm = self.lidar_range[4] - self.lidar_range[1]
        wm = self.lidar_range[3] - self.lidar_range[0]
        return normalize_pairwise_tfm(
            batch["pairwise_t_matrix"].to(torch.float32), hm, wm, 1.0)

    def _shrink_and_heads(self, fused, out):
        if self.DownsampleConv_0 is not None:
            fused = self.DownsampleConv_0(fused)
        cls_preds, reg_preds, dir_preds = self.heads(fused)
        out.update(cls_preds=cls_preds, reg_preds=reg_preds,
                   dir_preds=dir_preds)
        return out

    def _add_shrink_and_heads(self, in_ch: int, shrink_args, anchor_number,
                              dir_bins):
        self.DownsampleConv_0 = None
        if shrink_args is not None:
            self.DownsampleConv_0 = DownsampleConv(
                in_ch, dims=shrink_args["dim"],
                kernels=shrink_args["kernal_size"],
                strides=shrink_args["stride"])
            in_ch = shrink_args["dim"][-1]
        self.heads = DetectionHeads(in_ch, anchor_number, dir_bins)


class HeterPyramidModel(_HeterBranches):
    def __init__(self, modality_args: Dict[str, Dict[str, Any]],
                 fusion_backbone: Dict[str, Any],
                 lidar_range: Tuple[float, ...],
                 shrink_args: Dict[str, Any] | None = None,
                 anchor_number: int = 2, dir_bins: int = 2,
                 collab: bool = True,
                 compressor: Dict[str, Any] | None = None, device=None):
        super().__init__(modality_args, lidar_range)
        device = resolve_device(device)
        self.collab = collab
        self.compressor = None
        if compressor is not None:
            self.compressor = NaiveCompressor(compressor["input_dim"],
                                              compressor["compress_ratio"])
        self.pyramid_backbone = PyramidFusion.from_config(fusion_backbone,
                                                          self.feat_ch)
        self._add_shrink_and_heads(self.pyramid_backbone.out_channels,
                                   shrink_args, anchor_number, dir_bins)
        self.eval()
        self.to(device)

    def forward(self, batch: Dict[str, torch.Tensor], noises=None,
                generator: torch.Generator | None = None) -> Dict[str, Any]:
        """batch: as ``HeterModel.forward``'s. Returns cls / reg / dir
        preds (collab (B, ...), single (B * L, ...)), ``occ_single_list``
        and, for a camera modality, ``depth_items_<m>``."""
        out: Dict[str, Any] = {}
        agent_mask = batch["agent_mask"].bool()
        # the field-of-view masks act at eval only, as the reference's
        # `not self.training`
        feature, score_mask = self._features(
            batch, out, self.collab and not self.training)
        b, l = agent_mask.shape
        if self.compressor is not None:
            feature = self.compressor(feature.reshape(
                (b * l,) + feature.shape[2:])).reshape(feature.shape)
        if self.collab:
            fused, occ = self.pyramid_backbone(
                feature, self._affine(batch), agent_mask,
                score_mask=score_mask)
        else:
            fused, occ = self.pyramid_backbone(
                feature.reshape((b * l,) + feature.shape[2:]), single=True)
        out["occ_single_list"] = occ
        return self._shrink_and_heads(fused, out)


class HeterMsModel(_HeterBranches):
    def __init__(self, modality_args: Dict[str, Dict[str, Any]],
                 fusion_backbone: Dict[str, Any],
                 lidar_range: Tuple[float, ...],
                 shrink_args: Dict[str, Any] | None = None,
                 anchor_number: int = 2, dir_bins: int = 2,
                 fusion_method: str = "att", supervise_single: bool = False,
                 device=None):
        super().__init__(modality_args, lidar_range)
        device = resolve_device(device)
        if supervise_single:
            self.heads_single = DetectionHeads(self.feat_ch, anchor_number,
                                               dir_bins)
        self.fusion_backbone = MsFusion.from_config(
            fusion_backbone, self.feat_ch, fusion_method)
        self._add_shrink_and_heads(self.fusion_backbone.out_channels,
                                   shrink_args, anchor_number, dir_bins)
        self.eval()
        self.to(device)

    def forward(self, batch: Dict[str, torch.Tensor], noises=None,
                generator: torch.Generator | None = None) -> Dict[str, Any]:
        """Returns cls / reg / dir preds (B, ...) and, with
        ``supervise_single``, each agent's own ``*_preds_single`` (B * L,
        ...) from the combined feature before fusion."""
        out: Dict[str, Any] = {}
        agent_mask = batch["agent_mask"].bool()
        b, l = agent_mask.shape
        feature, _ = self._features(batch, out, False)
        if self.heads_single is not None:
            cls_s, reg_s, dir_s = self.heads_single(
                feature.reshape((b * l,) + feature.shape[2:]))
            out.update(cls_preds_single=cls_s, reg_preds_single=reg_s,
                       dir_preds_single=dir_s)
        fused = self.fusion_backbone(feature, self._affine(batch), agent_mask)
        return self._shrink_and_heads(fused, out)


def _modality_args(args: dict) -> Dict[str, Dict[str, Any]]:
    """The ``m<k>`` blocks of ``model.args``, each encoder given the
    model's lidar range where it names none."""
    out = {}
    for k, v in args.items():
        if k.startswith("m") and k[1:].isdigit():
            v = dict(v)
            enc = dict(v["encoder_args"])
            enc.setdefault("lidar_range", args["lidar_range"])
            v["encoder_args"] = enc
            out[k] = v
    return out


def pyramid_kwargs(hypes: dict) -> Dict[str, Any]:
    """``HeterPyramidModel`` arguments from a hypes dict, as
    ``build_pyramid_model`` of the JAX package reads them."""
    args = hypes["model"]["args"]
    return dict(
        modality_args=_modality_args(args),
        fusion_backbone=args["fusion_backbone"],
        lidar_range=tuple(args["lidar_range"]),
        shrink_args=args.get("shrink_header"),
        anchor_number=args["anchor_number"],
        dir_bins=args["dir_args"]["num_bins"],
        collab="collab" in hypes["model"]["core_method"].lower(),
        compressor=args.get("compressor"))


def build_pyramid_model(hypes: dict, device=None) -> HeterPyramidModel:
    return HeterPyramidModel(**pyramid_kwargs(hypes), device=device)


def build_ms_model(hypes: dict, device=None) -> HeterMsModel:
    args = hypes["model"]["args"]
    return HeterMsModel(
        modality_args=_modality_args(args),
        fusion_backbone=args["fusion_backbone"],
        lidar_range=tuple(args["lidar_range"]),
        shrink_args=args.get("shrink_header"),
        anchor_number=args["anchor_number"],
        dir_bins=args["dir_args"]["num_bins"],
        fusion_method=args.get("fusion_method", "att"),
        supervise_single=bool(args.get("supervise_single", False)),
        device=device)
