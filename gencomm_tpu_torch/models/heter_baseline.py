"""Heterogeneous collaboration model, GenComm stage 1, eval and training.

Counterpart of ``gencomm_tpu/models/heter_baseline.py`` (``ModalityBranch``,
``HeterModel.__call__``) restricted to: point_pillar (host-decorated or
raw points), SECOND and VoxelNet (raw points) and lift_splat_shoot camera
modalities, ``use_gencomm``
(message extractor + conditional DDPM), ``use_enhancer``,
``supervise_single`` (per-agent heads),
the two stage-2 switches ``missing_message_rate`` and ``gencomm_trick``,
Where2comm's communication mask (``use_comm_mask``), the intermediate
fusions of ``models/fuse`` other than ``pyramid``, and the paper's four
heterogeneous baselines: BackAlign (``feature_missing_rate`` /
``feature_noise_std``, its eval-time corruption; no generation),
CodeFilling (``use_codebook``, ``models/codebook.py``), MPDA
(``use_mpda``, ``models/mpda.py``) and STAMP (``use_stamp``, the adapters
and reverters of ``models/stamp.py``), with fp32 activations or, with
``half=True``, bf16 ones at eval. The order is the JAX model's: STAMP's
combine in protocol space, BackAlign's corruption, ``heads_single``, MPDA,
the codebook, the comm mask, GenComm, fusion, heads. The model is built in
``eval()``; ``train()`` switches the batch norms to batch statistics, the
codebook to its Gumbel sample, and STAMP's reverters on (the cycle
tensors of its loss); BackAlign's corruption is eval-only. The random
draws (the codebook's Gumbel noise, the corruption's and the message
drop's) come from the caller's ``generator``. Every other branch raises
``NotImplementedError`` (``seg_head_args``, the ``gmatch`` loss).

``half`` (``gencomm_tpu/models/heter_baseline.py:51-52, 70-75, 286, 517,
541, 547, 562``): parameters stay fp32, so one ``state_dict`` serves both
graphs. Each modality's PFN, neck and shrinker run in bf16 (a camera
encoder also takes ``trunk_bf16`` and ``splat_bf16`` unless its arguments
set them; SECOND's and VoxelNet's encoders stay fp32, as the JAX ones have
no dtype), the
feature leaves the branch in bf16 and stays so through the
message extractor's deformable conv (its other layers promote to fp32, as
flax's do), generation and the Enhancer; the fusion returns fp32 and the
heads run in fp32 (``v2xvit`` takes ``half`` itself; the other fusions
compute in the promoted type of the bf16 feature and their fp32
parameters). bf16 training is not ported: ``train()`` raises.

Inputs are padded ``(B, L, ...)`` tensors with masks, agent slot 0 the ego;
submodule names follow the flax auto-names so ``weights.py`` can carry JAX
parameters across. ``build_model`` builds the model from a hypes dict
(``heter_baseline.py:574-659``); a config that needs a branch the port
does not have raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
from torch import nn

from gencomm_tpu_torch import resolve_device
from gencomm_tpu_torch.data.bucketing import AGENT_BUCKETS
from gencomm_tpu_torch.models.backbones.bev_backbone import BEVBackbone
from gencomm_tpu_torch.models.codebook import UMGMQuantizer
from gencomm_tpu_torch.models.encoders.lss import (
    LSSEncoder, center_crop_or_pad,
)
from gencomm_tpu_torch.models.encoders.point_pillar import PointPillarEncoder
from gencomm_tpu_torch.models.encoders.second import SECONDEncoder
from gencomm_tpu_torch.models.encoders.voxelnet import VoxelNetEncoder
from gencomm_tpu_torch.models.fuse.fusion import build_fusion
from gencomm_tpu_torch.models.fuse.where2comm import Communication
from gencomm_tpu_torch.models.gencomm.diffusion import GenCommDiffusion
from gencomm_tpu_torch.models.gencomm.enhancer import Enhancer
from gencomm_tpu_torch.models.gencomm.message_extractor import MessageExtractor
from gencomm_tpu_torch.models.heads import DetectionHeads
from gencomm_tpu_torch.models.layers import DownsampleConv
from gencomm_tpu_torch.models.mpda import (
    CrossDomainFusionEncoder, DAImgHead, LearnableResizer,
)
from gencomm_tpu_torch.models.stamp import StampAdapter
from gencomm_tpu_torch.utils.transformation_utils import normalize_pairwise_tfm


def uniform(shape, generator: torch.Generator, device) -> torch.Tensor:
    """U[0, 1) draws of the eval-time drops, from ``generator``."""
    return torch.rand(shape, generator=generator, device=device)


def normal(shape, generator: torch.Generator, device) -> torch.Tensor:
    """N(0, 1) draws of BackAlign's eval-time noise, from ``generator``."""
    return torch.randn(shape, generator=generator, device=device)


class ModalityBranch(nn.Module):
    """encoder -> backbone -> shrinker for one modality; ``core_method``
    selects the encoder, ``point_pillar``, ``second``, ``voxelnet`` (or
    ``voxel_net``) or ``lift_splat_shoot``. With ``encode_only`` (the HEAL pyramid models)
    the branch is the encoder alone and returns its canvas."""

    def __init__(self, encoder_args: Dict[str, Any],
                 backbone_args: Dict[str, Any] | None,
                 shrink_args: Dict[str, Any] | None,
                 core_method: str = "point_pillar", dtype=None,
                 encode_only: bool = False):
        super().__init__()
        self.core_method, self.dtype = core_method, dtype
        self.encode_only = encode_only
        half = dtype == torch.bfloat16
        if core_method == "lift_splat_shoot":
            self.encoder = LSSEncoder(
                grid_conf=encoder_args["grid_conf"],
                final_dim=tuple(encoder_args["data_aug_conf"]["final_dim"]),
                downsample=encoder_args.get("img_downsample", 8),
                feat_ch=encoder_args.get("img_features", 128),
                trunk_blocks=encoder_args.get("trunk_blocks", 2),
                trunk=encoder_args.get("img_trunk", "tpu"),
                depth_topk=encoder_args.get("depth_topk", 0),
                trunk_bf16=encoder_args.get("trunk_bf16", half),
                splat_bf16=encoder_args.get("splat_bf16", half))
        elif core_method == "point_pillar":
            self.encoder = PointPillarEncoder(
                voxel_size=tuple(encoder_args["voxel_size"]),
                lidar_range=tuple(encoder_args["lidar_range"]),
                num_filters=tuple(encoder_args["pillar_vfe"]["num_filters"]),
                use_norm=encoder_args["pillar_vfe"].get("use_norm", True),
                dtype=dtype)
        elif core_method == "second":
            # fp32 whatever ``dtype``: the JAX encoder has none
            self.encoder = SECONDEncoder(
                voxel_size=tuple(encoder_args["voxel_size"]),
                lidar_range=tuple(encoder_args["lidar_range"]),
                voxel_capacity_per_agent=encoder_args.get("max_voxels", 32000),
                out_ch=encoder_args.get("spconv", {}).get(
                    "num_features_out", 128))
        elif core_method in ("voxelnet", "voxel_net"):
            # fp32 whatever ``dtype``, as SECOND
            self.encoder = VoxelNetEncoder(
                voxel_size=tuple(encoder_args["voxel_size"]),
                lidar_range=tuple(encoder_args["lidar_range"]),
                vfe_filters=tuple(encoder_args.get("vfe_filters", (32, 128))))
        else:
            raise ValueError(f"unknown encoder core_method {core_method!r}")
        if encode_only:
            self.out_channels = self.encoder.out_channels
            return
        self.backbone = BEVBackbone(
            self.encoder.out_channels,
            layer_nums=backbone_args["layer_nums"],
            layer_strides=backbone_args["layer_strides"],
            num_filters=backbone_args["num_filters"],
            upsample_strides=backbone_args.get("upsample_strides", ()),
            num_upsample_filters=backbone_args.get("num_upsample_filter", ()),
            dtype=dtype)
        self.shrinker = DownsampleConv(
            self.backbone.out_channels, dims=shrink_args["dim"],
            kernels=shrink_args["kernal_size"], strides=shrink_args["stride"],
            dtype=dtype)
        self.out_channels = shrink_args["dim"][-1]

    def forward(self, inputs: Dict[str, torch.Tensor]):
        """The encoder's inputs -> (feature (B, L, H, W, C), depth logits or
        (logits, gt_idx) of a camera encoder, else None)."""
        depth_logits = None
        if self.core_method == "lift_splat_shoot":
            canvas, depth_logits = self.encoder(inputs)  # fp32
        elif "decorated" in inputs:
            canvas = self.encoder(inputs["decorated"], inputs["gids"],
                                  inputs["dvalid"])  # (B, L, ny, nx, C) bf16
        elif self.core_method == "point_pillar":
            canvas = self.encoder.from_points(inputs["points"],
                                              inputs["point_mask"])
        else:
            canvas = self.encoder(inputs["points"], inputs["point_mask"])
        if self.encode_only:
            return canvas, depth_logits
        b, l = canvas.shape[:2]
        flat = canvas.reshape((b * l,) + canvas.shape[2:])
        # in fp32 the neck runs on the bf16 pillar canvas values, as flax
        # promotes; under half its first conv casts a camera's or SECOND's
        # fp32 canvas to bf16
        feat = self.shrinker(self.backbone(
            flat.float() if self.dtype is None else flat))
        return feat.reshape((b, l) + feat.shape[1:]), depth_logits


def lidar_inputs(branch: ModalityBranch, batch, mname: str):
    """A lidar branch's inputs from the batch: the decorated fields where
    the batch holds them (PointPillars after the host decoration), else raw
    points and their mask (SECOND, VoxelNet, and PointPillars' raw-point
    path)."""
    if branch.encoder.takes_raw_points or f"decorated_{mname}" not in batch:
        return {"points": batch[f"points_{mname}"],
                "point_mask": batch[f"point_mask_{mname}"]}
    return {"decorated": batch[f"decorated_{mname}"],
            "gids": batch[f"gids_{mname}"],
            "dvalid": batch[f"dvalid_{mname}"].bool()}


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
                 supervise_single: bool = False,
                 missing_message_rate: float = 0.0,
                 gencomm_trick: bool = False,
                 fusion_args: Dict[str, Any] | None = None,
                 num_agents: int | None = None, use_comm_mask: bool = False,
                 comm_thre: float = 0.01,
                 feature_missing_rate: float = 0.0,
                 feature_noise_std: float = 0.0,
                 use_codebook: bool = False, codebook_seg: int = 2,
                 codebook_dict_sizes: Sequence[int] = (64, 64, 64),
                 use_mpda: bool = False, mpda_window_size: int = 8,
                 mpda_depth: int = 1, use_stamp: bool = False,
                 ego_modality: str = "m1",
                 stamp_args: Dict[str, Dict[str, Any]] | None = None,
                 device=None):
        super().__init__()
        if use_enhancer and not use_gencomm:
            raise NotImplementedError("the Enhancer runs only after GenComm")
        device = resolve_device(device)
        self.bf16 = half
        dtype = torch.bfloat16 if half else None
        self.lidar_range = tuple(lidar_range)
        self.use_gencomm, self.use_enhancer = use_gencomm, use_enhancer
        self.message_ch = message_ch
        # stage 2: the eval-time spatial dropout of the non-ego messages,
        # and the prediction masked where the true feature is zero
        self.missing_message_rate = float(missing_message_rate)
        self.gencomm_trick = gencomm_trick
        # BackAlign: the eval-time drop and noise of the non-ego features
        self.feature_missing_rate = float(feature_missing_rate)
        self.feature_noise_std = float(feature_noise_std)
        self.use_codebook, self.use_mpda = use_codebook, use_mpda
        self.use_stamp, self.ego_modality = use_stamp, ego_modality
        self.modalities = list(modality_args)
        # camera modalities: name -> the (x, y) extent of their BEV grid
        self.camera_extent = {
            m: (a["encoder_args"]["grid_conf"]["xbound"][1],
                a["encoder_args"]["grid_conf"]["ybound"][1])
            for m, a in modality_args.items()
            if a.get("sensor_type", "lidar") == "camera"}
        feat_ch = None
        for mname, margs in modality_args.items():
            branch = ModalityBranch(margs["encoder_args"], margs["backbone_args"],
                                    margs["shrink_header"],
                                    margs.get("core_method", "point_pillar"),
                                    dtype)
            self.add_module(f"branch_{mname}", branch)
            feat_ch = branch.out_channels
            if use_gencomm:
                self.add_module(f"message_extractor_{mname}",
                                MessageExtractor(feat_ch, message_ch))
        if use_stamp:
            # each non-ego modality's adapter to the protocol space (the
            # ego's feature space) and reverter back; the reverters run in
            # training only, and are built for eval too so that one
            # state_dict serves both
            self.modality_range = {
                m: tuple(a["encoder_args"].get("lidar_range", lidar_range))
                for m, a in modality_args.items()}
            for mname in self.modalities:
                if mname == ego_modality:
                    continue
                cfgs = (stamp_args or {}).get(mname, {})
                self.add_module(f"adapter_{mname}", StampAdapter.from_config(
                    cfgs.get("adapter", {}), self.modality_range[mname],
                    lidar_range))
                self.add_module(f"reverter_{mname}", StampAdapter.from_config(
                    cfgs.get("reverter", {}), lidar_range,
                    self.modality_range[mname]))
        if use_mpda:
            self.resizer = LearnableResizer(feat_ch, feat_ch,
                                            wg_depth=mpda_depth,
                                            window_size=mpda_window_size)
            self.cdt = CrossDomainFusionEncoder(feat_ch, depth=mpda_depth,
                                                window_size=mpda_window_size)
            self.classifier = DAImgHead(feat_ch)
        if use_codebook:
            self.codebook = UMGMQuantizer(feat_ch, codebook_seg,
                                          codebook_dict_sizes)
        if use_gencomm:
            self.gencomm = GenCommDiffusion(
                feat_ch=feat_ch, msg_ch=message_ch,
                num_timesteps=gencomm_timesteps, unet_ch=unet_ch,
                unet_ch_mult=unet_ch_mult,
                unet_num_res_blocks=unet_num_res_blocks, dtype=dtype)
        if use_enhancer:
            self.enhancer = Enhancer(feat_ch, use_attn=enhancer_use_attn,
                                     dtype=dtype)
        # Where2comm's mask from the shared heads; no parameters
        self.communication = Communication(thre=comm_thre) \
            if use_comm_mask else None
        self.fusion_net = build_fusion(fusion_method, fusion_args, half,
                                       in_ch=feat_ch, num_agents=num_agents)
        # the agent buckets a batch is trimmed to: a fusion built for one
        # agent-slot count (CoBEVT) takes that count alone
        slots = getattr(self.fusion_net, "fixed_agent_slots", None)
        self.agent_buckets = (slots,) if slots else AGENT_BUCKETS
        self.heads = DetectionHeads(feat_ch, anchor_number, dir_bins,
                                    num_class)
        # per-agent heads on the combined pre-generation feature, fp32
        # (gencomm_tpu/models/heter_baseline.py:403-413): late and no-fusion
        # inference decode them
        self.heads_single = (DetectionHeads(feat_ch, anchor_number, dir_bins,
                                            num_class)
                             if supervise_single else None)
        self.eval()
        self.to(device)

    def train(self, mode: bool = True):
        if mode and getattr(self, "bf16", False):
            raise NotImplementedError(
                "bf16 training (half=True) is not ported; build the model "
                "with half=False to train it")
        return super().train(mode)

    @property
    def device(self) -> torch.device:
        return self.heads.cls_head.weight.device

    def lidar_encoder(self, mname: str):
        """The encoder of lidar modality ``mname``: a ``PointPillarEncoder``,
        whose grid the host decoration takes, or a ``SECONDEncoder`` or
        ``VoxelNetEncoder``, which take the raw points."""
        return getattr(self, f"branch_{mname}").encoder

    def camera_bev_shape(self, mname: str, h: int, w: int) -> Tuple[int, int]:
        """The (H, W) that camera modality ``mname``'s (h, w) feature is
        cropped or padded to so that it spans the lidar range; rounded,
        since 100.8 / 51.2 lies just below 1.96875 in binary and int()
        would cut a column."""
        xmax, ymax = self.camera_extent[mname]
        return (int(round(h * (self.lidar_range[4] / ymax))),
                int(round(w * (self.lidar_range[3] / xmax))))

    def _stamp_combine(self, feats, batch, out):
        """STAMP: the combined feature in protocol space, each non-ego
        modality through its adapter; in training also the cycle tensors
        of the adapter loss (FP, and per modality FM, M2P, M2P2M, P2M)."""
        fp = feats[self.ego_modality]
        out["stamp_FP"] = fp
        feature = None
        for mname in self.modalities:
            f = feats[mname]
            if mname == self.ego_modality:
                proto = f
            else:
                b, l = f.shape[:2]
                flat = f.reshape((b * l,) + f.shape[2:])
                m2p = getattr(self, f"adapter_{mname}")(flat, fp.shape[2:4])
                proto = m2p.reshape((b, l) + m2p.shape[1:])
                if self.training:
                    reverter = getattr(self, f"reverter_{mname}")
                    out[f"stamp_FM_{mname}"] = f
                    out[f"stamp_M2P_{mname}"] = proto
                    out[f"stamp_M2P2M_{mname}"] = reverter(
                        m2p, f.shape[2:4]).reshape(f.shape)
                    out[f"stamp_P2M_{mname}"] = reverter(
                        fp.reshape((b * l,) + fp.shape[2:]),
                        f.shape[2:4]).reshape(f.shape)
            mmask = batch[f"modality_mask_{mname}"].to(proto.dtype)[
                ..., None, None, None]
            contrib = proto * mmask
            feature = contrib if feature is None else feature + contrib
        return feature

    def _mpda(self, feature, out):
        """MPDA: the non-ego features resized and aligned to the ego's
        domain, conditioned on the ego's feature; every slot's per-pixel
        domain logits (``da_feature``) behind the gradient reversal."""
        b, l, h, w, c = feature.shape
        cavs = feature[:, 1:].reshape((b * (l - 1), h, w, c))
        ego_rep = feature[:, 0:1].expand(b, l - 1, h, w, c).reshape(cavs.shape)
        aligned = self.cdt(ego_rep, self.resizer(ego_rep, cavs))
        feature = torch.cat([feature[:, :1],
                             aligned.reshape((b, l - 1, h, w, c))], dim=1)
        out["da_feature"] = self.classifier(
            feature.reshape((b * l, h, w, c))).reshape((b, l, h, w, 1))
        return feature

    def forward(self, batch: Dict[str, torch.Tensor], noises=None,
                generator: torch.Generator | None = None) -> Dict[str, Any]:
        """batch: tensors on the model's device (``agent_mask``,
        ``pairwise_t_matrix``, ``modality_mask_<m>`` and, for a pillar
        modality, the decorated fields ``decorated_<m>``, ``gids_<m>``,
        ``dvalid_<m>`` or else its raw points; for a SECOND or VoxelNet
        modality the raw ``points_<m>`` and ``point_mask_<m>``; for a camera modality ``imgs_<m>``, ``rots_<m>``,
        ``trans_<m>``, ``intrins_<m>``, ``post_rots_<m>``,
        ``post_trans_<m>`` and optionally ``depths_<m>``). ``noises`` or
        ``generator`` feed the diffusion (see GenCommDiffusion); with a
        ``missing_message_rate`` an eval forward first draws the messages'
        keep mask from ``generator``, which it then needs. The output
        keeps ``gt_feature``, ``pred_feature`` and ``feature_mask`` for the
        generation loss and, for a camera modality, ``depth_items_<m>`` =
        (logits, gt_idx, slot weight) for the depth loss (the bare logits
        without GT depth). With ``supervise_single`` it also holds each
        agent slot's own heads, ``cls_preds_single``, ``reg_preds_single``
        and ``dir_preds_single`` over (B * L, H, W, .). With the
        communication mask it holds ``comm_rate``, the share of the
        neighbours' cells sent. The baselines add ``da_feature`` (MPDA's
        domain logits, (B, L, H, W, 1)), ``codebook_loss`` and
        ``codebook_codes`` (B, L, stages, H * W * seg), and STAMP's
        ``stamp_FP`` with, in training, ``stamp_FM_<m>``, ``stamp_M2P_<m>``,
        ``stamp_M2P2M_<m>`` and ``stamp_P2M_<m>`` for its loss."""
        out: Dict[str, Any] = {}
        agent_mask = batch["agent_mask"].bool()
        b, l = agent_mask.shape
        hm = self.lidar_range[4] - self.lidar_range[1]
        wm = self.lidar_range[3] - self.lidar_range[0]
        affine = normalize_pairwise_tfm(
            batch["pairwise_t_matrix"].to(torch.float32), hm, wm, 1.0)

        feature = message = None
        feats: Dict[str, torch.Tensor] = {}
        for mname in self.modalities:
            if mname in self.camera_extent:
                inputs = {k: batch[f"{k}_{mname}"] for k in (
                    "imgs", "rots", "trans", "intrins", "post_rots",
                    "post_trans")}
                if f"depths_{mname}" in batch:
                    inputs["depths"] = batch[f"depths_{mname}"]
            else:
                inputs = lidar_inputs(getattr(self, f"branch_{mname}"),
                                      batch, mname)
            feat, depth_logits = getattr(self, f"branch_{mname}")(inputs)
            if mname in self.camera_extent:
                # align the camera's BEV extent to the lidar range by a
                # center crop or pad
                feat = center_crop_or_pad(feat, self.camera_bev_shape(
                    mname, feat.shape[2], feat.shape[3]))
                if isinstance(depth_logits, tuple):
                    # the slot weight keeps the depth loss's mean on the
                    # real camera agents of the padded layout
                    logits, gt_idx = depth_logits
                    wt = batch[f"modality_mask_{mname}"].to(logits.dtype)[
                        :, :, None, None, None]
                    out[f"depth_items_{mname}"] = (logits, gt_idx, wt)
                else:
                    out[f"depth_items_{mname}"] = depth_logits
            feats[mname] = feat
            mmask = batch[f"modality_mask_{mname}"].to(feat.dtype)[
                ..., None, None, None]
            if not self.use_stamp:
                # STAMP's modalities combine below, in protocol space
                contrib = feat * mmask
                feature = contrib if feature is None else feature + contrib
            if self.use_gencomm:
                flat = feat.reshape((b * l,) + feat.shape[2:])
                msg = getattr(self, f"message_extractor_{mname}")(flat)
                msg = msg.reshape((b, l) + feat.shape[2:-1] + (self.message_ch,))
                mcontrib = msg * mmask
                message = mcontrib if message is None else message + mcontrib

        if self.use_stamp:
            feature = self._stamp_combine(feats, batch, out)
        hw = tuple(feature.shape[2:4])
        if not self.training and (self.feature_missing_rate > 0
                                  or self.feature_noise_std > 0):
            # BackAlign: each non-ego feature loses random pixels and takes
            # Gaussian noise; the ego's stays intact
            if generator is None:
                raise ValueError("the feature corruption draws from a "
                                 "generator; none was given")
            keep = uniform((b, l) + hw + (1,), generator,
                           feature.device) > self.feature_missing_rate
            noise = normal(feature.shape, generator,
                           feature.device) * self.feature_noise_std
            corrupted = feature * keep + noise
            is_ego = torch.arange(l, device=feature.device)[
                None, :, None, None, None] == 0
            feature = torch.where(is_ego, feature, corrupted)
        if self.heads_single is not None:
            cls_s, reg_s, dir_s = self.heads_single(
                feature.reshape((b * l,) + feature.shape[2:]).to(torch.float32))
            out.update(cls_preds_single=cls_s, reg_preds_single=reg_s,
                       dir_preds_single=dir_s)
        if self.use_mpda:
            feature = self._mpda(feature, out)
        if self.use_codebook:
            # the transmitted features are quantized, the ego keeps its own
            c = feature.shape[-1]
            restored, codes, out["codebook_loss"] = self.codebook(
                feature.reshape(-1, c), generator=generator)
            is_ego = torch.arange(l, device=feature.device)[
                None, :, None, None, None] == 0
            feature = torch.where(is_ego, feature,
                                  restored.reshape(feature.shape))
            # the code indices are the payload, (B, L, stages, H * W * seg)
            out["codebook_codes"] = torch.stack(
                [q.reshape(b, l, -1) for q in codes], dim=2)
        if self.communication is not None:
            # Where2comm: cells of low confidence under the shared heads are
            # not sent (a hard threshold, no gradient), before generation
            with torch.no_grad():
                cls_before = self.heads(feature.reshape(
                    (b * l,) + feature.shape[2:]).to(torch.float32))[0]
                masks, out["comm_rate"] = self.communication(
                    cls_before.reshape((b, l) + cls_before.shape[1:]),
                    agent_mask)
            feature = feature * masks
        if self.use_gencomm:
            if not self.training and self.missing_message_rate > 0:
                # spatial dropout of the non-ego messages, the ego's intact
                if generator is None:
                    raise ValueError("missing_message_rate draws its mask "
                                     "from a generator; none was given")
                keep = uniform((b, l) + hw + (1,), generator,
                               message.device) > self.missing_message_rate
                keep[:, 0] = True
                message = message * keep
            out["message"] = message
            # only `message` crosses agents; generation starts from the ego
            ego_bc = feature[:, 0:1].expand(feature.shape).reshape(
                (b * l,) + feature.shape[2:])
            cond = message.reshape((b * l,) + hw + (self.message_ch,))
            pred = self.gencomm(ego_bc, cond, noises=noises, generator=generator)
            out["gt_feature"] = feature.reshape(pred.shape)
            out["pred_feature"] = pred
            out["feature_mask"] = agent_mask.reshape(-1)
            fused_in = pred
            if self.gencomm_trick:
                fused_in = pred * (out["gt_feature"] != 0).any(
                    dim=-1, keepdim=True).to(pred.dtype)
            if self.use_enhancer:
                fused_in = self.enhancer(fused_in)
            feature = fused_in.reshape((b, l) + hw + (pred.shape[-1],))

        fused = self.fusion_net(feature, affine, agent_mask)
        out["feature"] = fused
        cls_preds, reg_preds, dir_preds = self.heads(fused.to(torch.float32))
        out.update(cls_preds=cls_preds, reg_preds=reg_preds,
                   dir_preds=dir_preds)
        return out


def model_kwargs(hypes: dict) -> Dict[str, Any]:
    """``HeterModel`` arguments from a hypes dict, as ``build_model`` of
    the JAX package reads its ``model.args`` block; raises
    ``NotImplementedError`` for a branch the port does not have."""
    args = hypes["model"]["args"]
    core = hypes["model"]["core_method"].lower()
    if "seg_head_args" in args:
        raise NotImplementedError(
            "model.args.seg_head_args (STAMP's BEV segmentation head) is not "
            "ported yet (ROADMAP item 16)")
    if "gmatch" in hypes.get("loss", {}).get("core_method", ""):
        raise NotImplementedError(
            "the gradient-matching model branch is not ported yet (ROADMAP "
            "item 16)")
    modality_args = {}
    for key, val in args.items():
        if key.startswith("m") and key[1:].isdigit():
            margs = dict(val)
            enc = dict(margs["encoder_args"])
            enc.setdefault("lidar_range", args["lidar_range"])
            margs["encoder_args"] = enc
            modality_args[key] = margs
    # BackAlign never generates: its features, not messages, cross agents
    use_gencomm = ("gencomm" in core or "gencomm" in args) \
        and "backalign" not in core
    # BackAlign's eval-time corruption, at the reference's fixed drop rate
    # 0.05 and noise std 3.0
    backalign_missing = "backalign" in core and bool(
        args.get("missing_message", False))
    codebook = args.get("codebook", {})
    dict_size = codebook.get("dict_size", (64, 64, 64))
    if isinstance(dict_size, int):
        dict_size = (dict_size,) * 3  # three equal levels
    use_stamp = "stamp" in core
    gencomm_cfg = args.get("gencomm", {})
    unet_cfg = gencomm_cfg.get("model", {})
    diff_cfg = gencomm_cfg.get("diffusion", {})
    method = args["fusion_method"]
    return dict(
        modality_args=modality_args,
        fusion_method=method,
        fusion_args={method: dict(args.get(method, {}))},
        # the agent-slot count of the batch the JAX package's train CLI
        # initialises from (untrimmed, max_cav): CoBEVT sizes its table by
        # it, the other fusions ignore it
        num_agents=int(hypes.get("train_params", {}).get("max_cav", 5)),
        use_comm_mask="communication" in args,
        comm_thre=args.get("communication", {}).get("thre", 0.01),
        lidar_range=tuple(args["lidar_range"]),
        anchor_number=args["anchor_number"],
        num_class=int(args.get("num_class", 1)),
        dir_bins=args["dir_args"]["num_bins"],
        use_gencomm=use_gencomm,
        use_enhancer=use_gencomm and "enhancer" in args,
        enhancer_use_attn=bool(args.get("enhancer", {}).get("use_attn", False)),
        message_ch=args.get("message_extractor", {}).get("out_ch", 2),
        gencomm_timesteps=diff_cfg.get("num_diffusion_timesteps", 3),
        unet_ch=unet_cfg.get("ch", 8),
        unet_ch_mult=tuple(unet_cfg.get("ch_mult", (1, 1))),
        unet_num_res_blocks=unet_cfg.get("num_res_blocks", 2),
        half=bool(args.get("half", False)),
        supervise_single=bool(args.get("supervise_single", False)),
        missing_message_rate=(
            0.4 if use_gencomm and args.get("missing_message", False) else 0.0),
        gencomm_trick=bool(args.get("trick", False)),
        feature_missing_rate=0.05 if backalign_missing else 0.0,
        feature_noise_std=3.0 if backalign_missing else 0.0,
        use_codebook="codebook" in args,
        codebook_seg=codebook.get("seg_num", 2),
        codebook_dict_sizes=tuple(dict_size),
        use_mpda="mpda" in core,
        mpda_window_size=args.get("cdt", {}).get("window_size", 8),
        mpda_depth=args.get("cdt", {}).get("depth", 1),
        use_stamp=use_stamp,
        ego_modality=str(args.get("ego_modality", "m1")),
        stamp_args={m: {"adapter": v.get("adapter", {}),
                        "reverter": v.get("reverter", {})}
                    for m, v in modality_args.items()} if use_stamp else None,
    )


def build_model(hypes: dict, device=None) -> HeterModel:
    """``HeterModel`` from a hypes dict, on ``device`` (default ``cuda``)."""
    return HeterModel(**model_kwargs(hypes), device=device)
