"""PIXOR: a rasterized BEV occupancy encoder and a dense one-stage header.

Counterpart of ``gencomm_tpu/models/encoders/pixor.py``: ``rasterize_bev``
(one occupancy channel per z slice and the cell's mean intensity),
``PIXOREncoder`` (the raster through a ResNet BEV backbone of levels 64 /
128 / 192 at strides 2 / 4 / 8, each decoded to stride 2 with 64
channels), ``PIXORHeader`` (four 3x3 convs of 96 channels with batch norm
and ReLU, then a 1-channel classification map and a 6-channel regression
map: cos yaw, sin yaw, dx, dy, log w, log l), ``PIXORModel`` (the encoder,
the attentive fusion with kernel K3's warp, the header), ``PixorLoss`` and
``decode_pixor``. The model keeps ``HeterModel``'s interface for the
pipeline and the trainer (``device``, ``modalities``, ``heads_single``,
``use_gencomm``, ``agent_buckets``, ``lidar_encoder``); it reads the raw
points of modality ``m1``.

Where a loss target falls on a cell twice, the later box's target is kept,
as JAX's scatter on the CPU keeps it; here by an explicit last-index rule,
the same on every device.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from gencomm_tpu_torch import resolve_device
from gencomm_tpu_torch.data.bucketing import AGENT_BUCKETS
from gencomm_tpu_torch.models.backbones.resnet_bev import ResNetBEVBackbone
from gencomm_tpu_torch.models.fuse.fusion import build_fusion
from gencomm_tpu_torch.models.layers import BatchNorm, Conv, sigmoid
from gencomm_tpu_torch.ops.sparse import segment_sum_sorted, voxel_index
from gencomm_tpu_torch.utils.transformation_utils import normalize_pairwise_tfm


def grid_of(lidar_range, voxel_size) -> Tuple[int, int, int]:
    """(nx, ny, nz) of a range at a voxel size."""
    return tuple(int(round((lidar_range[3 + i] - lidar_range[i])
                           / voxel_size[i])) for i in range(3))


def rasterize_bev(points, point_mask, lidar_range, voxel_size):
    """(B, L, P, 4) points -> (B, L, ny, nx, nz + 1): 1 where a point falls
    in the cell's z slice, and the cell's mean intensity last."""
    b, l, p, _ = points.shape
    lr, vs = lidar_range, voxel_size
    nx, ny, nz = grid_of(lr, vs)
    pts = points.reshape(b * l * p, 4)
    ix, iy, iz = (voxel_index(pts[:, i], lr[i], vs[i]) for i in range(3))
    inb = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & (iz >= 0)
           & (iz < nz))
    valid = inb & point_mask.reshape(-1).bool()
    agent = torch.arange(b * l, dtype=torch.int32,
                         device=points.device).repeat_interleave(p)
    ncell = ny * nx
    cell2d = iy.clamp(0, ny - 1) * nx + ix.clamp(0, nx - 1)
    gid3 = torch.where(valid, (agent * ncell + cell2d) * nz + iz.clamp(0, nz - 1),
                       torch.full_like(iz, b * l * ncell * nz)).long()
    vf = valid.to(torch.float32)
    occ = vf.new_zeros(b * l * ncell * nz + 1).scatter_reduce(
        0, gid3, vf, "amax", include_self=True)
    occ = occ[:-1].reshape(b, l, ny, nx, nz)
    gid2 = torch.where(valid, agent * ncell + cell2d,
                       torch.full_like(cell2d, b * l * ncell)).long()
    sums = segment_sum_sorted(torch.stack([pts[:, 3] * vf, vf], dim=1), gid2,
                              b * l * ncell + 1)
    mean_i = (sums[:, 0] / sums[:, 1].clamp_min(1.0))[:-1].reshape(
        b, l, ny, nx, 1)
    return torch.cat([occ, mean_i], dim=-1)


class PIXOREncoder(nn.Module):
    """Raw points -> the raster -> the ResNet BEV backbone, (B, L, ny / 2,
    nx / 2, 192)."""

    # the pipeline leaves its modality's raw points undecorated
    takes_raw_points = True

    def __init__(self, voxel_size, lidar_range):
        super().__init__()
        self.voxel_size, self.lidar_range = tuple(voxel_size), tuple(lidar_range)
        nz = grid_of(lidar_range, voxel_size)[2]
        self.backbone = ResNetBEVBackbone(
            nz + 1, layer_nums=(2, 2, 2), layer_strides=(2, 2, 2),
            num_filters=(64, 128, 192), upsample_strides=(1, 2, 4),
            num_upsample_filters=(64, 64, 64), resnext=False)
        self.out_channels = self.backbone.out_channels

    def forward(self, points, point_mask):
        bev = rasterize_bev(points, point_mask, self.lidar_range,
                            self.voxel_size)
        b, l = bev.shape[:2]
        feat = self.backbone(bev.reshape((b * l,) + bev.shape[2:]))
        return feat.reshape((b, l) + feat.shape[1:])


class PIXORHeader(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        for i in range(4):
            self.add_module(f"conv{i}", Conv(in_ch if i == 0 else 96, 96, 3,
                                             bias=False))
            self.add_module(f"BatchNorm_{i}", BatchNorm(96))
        self.clshead = Conv(96, 1, 3)
        self.reghead = Conv(96, 6, 3)

    def forward(self, x):
        h = x
        for i in range(4):
            h = torch.relu(getattr(self, f"BatchNorm_{i}")(
                getattr(self, f"conv{i}")(h)))
        return self.clshead(h), self.reghead(h)


class PIXORModel(nn.Module):
    """The raster encoder, the fusion over agents, the header; runs on
    ``device`` (default ``cuda``). ``decode_cell`` is the metres a head
    cell spans in the decode (``InferencePipeline``)."""

    # no message, no per-agent heads; one lidar modality
    use_gencomm = False
    heads_single = None
    modalities = ("m1",)
    agent_buckets = AGENT_BUCKETS

    def __init__(self, voxel_size, lidar_range, fusion_method: str = "att",
                 decode_cell: float = 1.6, device=None):
        super().__init__()
        self.lidar_range = tuple(lidar_range)
        self.decode_cell = float(decode_cell)
        self.encoder = PIXOREncoder(voxel_size, lidar_range)
        ch = self.encoder.out_channels
        self.fusion_net = build_fusion(fusion_method,
                                       {"att": {"feat_dim": ch}}, in_ch=ch)
        self.header = PIXORHeader(ch)
        self.eval()
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.header.clshead.weight.device

    def lidar_encoder(self, mname: str):
        return self.encoder

    def forward(self, batch, noises=None, generator=None):
        """``points_m1``, ``point_mask_m1``, ``pairwise_t_matrix`` and
        ``agent_mask`` -> cls_preds (B, H, W, 1), reg_preds (B, H, W, 6).
        ``noises`` and ``generator`` are accepted for the pipeline's and
        the trainer's calls; nothing is drawn."""
        feat = self.encoder(batch["points_m1"], batch["point_mask_m1"])
        hm = self.lidar_range[4] - self.lidar_range[1]
        wm = self.lidar_range[3] - self.lidar_range[0]
        affine = normalize_pairwise_tfm(
            batch["pairwise_t_matrix"].to(torch.float32), hm, wm, 1.0)
        fused = self.fusion_net(feat, affine, batch["agent_mask"].bool())
        cls, reg = self.header(fused)
        return {"cls_preds": cls, "reg_preds": reg}


def build_pixor_model(hypes: dict, device=None) -> PIXORModel:
    """``PIXORModel`` from a hypes dict, as the JAX ``create_model`` builds
    it for a ``pixor`` core. Its decode cell is the loss's target cell
    (``loss.args.cell``, 1.6 m by default), so that boxes decode where the
    loss placed their targets (ROADMAP fault s)."""
    args = hypes["model"]["args"]
    return PIXORModel(voxel_size=tuple(args.get("voxel_size", (0.4, 0.4, 0.1))),
                      lidar_range=tuple(args["lidar_range"]),
                      decode_cell=hypes.get("loss", {}).get("args", {}).get(
                          "cell", 1.6),
                      device=device)


def _targets(gt_boxes, gt_mask, lr, cell: float, h: int, w: int):
    """One sample's positive map (h, w) and 6-dim target map (h, w, 6)."""
    div = torch.full_like(gt_boxes[:, 0], cell)
    cx = ((gt_boxes[:, 0] - lr[0]) / div - 0.5).to(torch.int32).clamp(0, w - 1)
    cy = ((gt_boxes[:, 1] - lr[1]) / div - 0.5).to(torch.int32).clamp(0, h - 1)
    flat = (cy * w + cx).long()
    pos = gt_mask.new_zeros(h * w).scatter_reduce(0, flat, gt_mask, "amax",
                                                  include_self=True)
    dx = gt_boxes[:, 0] - (lr[0] + (cx + 0.5) * cell)
    dy = gt_boxes[:, 1] - (lr[1] + (cy + 0.5) * cell)
    tvec = torch.stack([torch.cos(gt_boxes[:, 6]), torch.sin(gt_boxes[:, 6]),
                        dx, dy, torch.log(gt_boxes[:, 4].clamp_min(1e-3)),
                        torch.log(gt_boxes[:, 5].clamp_min(1e-3))], dim=-1)
    tvec = tvec * gt_mask[:, None]
    # the last box on a cell sets its target
    last = torch.full((h * w,), -1, dtype=torch.long, device=flat.device)
    last = last.scatter_reduce(0, flat, torch.arange(flat.shape[0],
                                                     device=flat.device),
                               "amax", include_self=True)
    tmap = torch.where((last >= 0)[:, None], tvec[last.clamp_min(0)],
                       torch.zeros_like(tvec[:1]))
    return pos.reshape(h, w), tmap.reshape(h, w, 6)


class PixorLoss:
    """Per-pixel focal BCE on the classification map and a smooth L1 on the
    6-dim targets where a box centre falls, the targets made from
    ``gt_boxes`` / ``gt_mask`` on cells of ``cell`` metres."""

    def __init__(self, args: dict):
        self.alpha = args.get("alpha", 0.25)
        self.gamma = args.get("gamma", 2.0)
        self.cls_weight = args.get("cls_weight", 1.0)
        self.reg_weight = args.get("reg_weight", 1.0)
        self.lidar_range = tuple(args["lidar_range"])
        self.cell = args.get("cell", 1.6)

    def __call__(self, output: dict, target: dict, suffix: str = "") -> dict:
        cls = output["cls_preds"][..., 0]
        reg = output["reg_preds"]
        _, h, w = cls.shape
        maps = [_targets(g.float(), m.float(), self.lidar_range, self.cell,
                         h, w)
                for g, m in zip(target["gt_boxes"], target["gt_mask"])]
        pos = torch.stack([m[0] for m in maps])
        tmap = torch.stack([m[1] for m in maps])
        prob = sigmoid(cls)
        pt = pos * prob + (1 - pos) * (1 - prob)
        alpha_w = pos * self.alpha + (1 - pos) * (1 - self.alpha)
        bce = cls.clamp_min(0) - cls * pos + torch.log1p(torch.exp(-cls.abs()))
        cls_loss = ((1 - pt) ** self.gamma * alpha_w * bce).sum() / \
            pos.sum().clamp_min(1.0)
        diff = (reg - tmap).abs() * pos[..., None]
        reg_loss = torch.where(diff < 1.0, 0.5 * diff ** 2, diff - 0.5).sum() \
            / (pos.sum() * 6).clamp_min(1.0)
        total = self.cls_weight * cls_loss + self.reg_weight * reg_loss
        return {"cls_loss": cls_loss, "reg_loss": reg_loss,
                "total_loss": total}


def decode_pixor(cls_map, reg_map, lidar_range, stride: float,
                 score_threshold: float = 0.2, topk: int = 128):
    """One sample's maps (h, w, 1), (h, w, 6) -> the top ``topk`` (x, y,
    yaw, w, l) boxes, their scores and ``scores > score_threshold``; cells
    of ``stride`` metres. Equal scores keep the lower index first, as
    ``jax.lax.top_k`` does."""
    h, w = cls_map.shape[:2]
    prob = sigmoid(cls_map[..., 0]).reshape(-1)
    cos_t, sin_t = reg_map[..., 0], reg_map[..., 1]
    dx, dy = reg_map[..., 2], reg_map[..., 3]
    logw, logl = reg_map[..., 4], reg_map[..., 5]
    gy = torch.arange(h, dtype=torch.float32, device=cls_map.device)[:, None]
    gx = torch.arange(w, dtype=torch.float32, device=cls_map.device)[None, :]
    px = lidar_range[0] + (gx + 0.5) * stride + dx
    py = lidar_range[1] + (gy + 0.5) * stride + dy
    yaw = torch.atan2(sin_t, cos_t)
    boxes = torch.stack([px, py, yaw, torch.exp(logw), torch.exp(logl)],
                        dim=-1).reshape(-1, 5)
    scores, idx = torch.sort(prob, descending=True, stable=True)
    scores, idx = scores[:topk], idx[:topk]
    return boxes[idx], scores, scores > score_threshold
