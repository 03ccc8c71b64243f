"""Anchors, box decoding and NMS post-processing.

Counterpart of ``gencomm_tpu/data/postprocessor.py``: ``generate_anchor_box``
(numpy, host), ``delta_to_boxes3d`` and ``decode_and_nms`` (torch, on the
device of the head outputs). Label generation comes with training.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gencomm_tpu_torch.ops.nms import rotated_nms
from gencomm_tpu_torch.utils import box_utils


def generate_anchor_box(anchor_args: dict, order: str = "hwl") -> np.ndarray:
    """(H', W', A, 7) anchor grid; H' = H // stride, W' = W // stride."""
    W, H = anchor_args["W"], anchor_args["H"]
    l, w, h = anchor_args["l"], anchor_args["w"], anchor_args["h"]
    yaws = [np.radians(r) for r in anchor_args["r"]]
    vw, vh = anchor_args["vw"], anchor_args["vh"]
    xrange = anchor_args["cav_lidar_range"][0], anchor_args["cav_lidar_range"][3]
    yrange = anchor_args["cav_lidar_range"][1], anchor_args["cav_lidar_range"][4]
    stride = anchor_args.get("feature_stride", 2)
    anchor_num = len(yaws)

    x = np.linspace(xrange[0] + vw, xrange[1] - vw, W // stride)
    y = np.linspace(yrange[0] + vh, yrange[1] - vh, H // stride)
    cx, cy = np.meshgrid(x, y)
    cx = np.tile(cx[..., None], anchor_num)
    cy = np.tile(cy[..., None], anchor_num)
    cz = np.full_like(cx, -1.0)
    ws = np.full_like(cx, w)
    ls = np.full_like(cx, l)
    hs = np.full_like(cx, h)
    rs = np.stack([np.full_like(cx[..., 0], yv) for yv in yaws], axis=-1)
    if order == "hwl":
        anchors = np.stack([cx, cy, cz, hs, ws, ls, rs], axis=-1)
    elif order == "lhw":
        anchors = np.stack([cx, cy, cz, ls, hs, ws, rs], axis=-1)
    else:
        raise ValueError(f"unknown box order {order}")
    return anchors.astype(np.float32)


def delta_to_boxes3d(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """deltas (..., H', W', A*7), anchors (H', W', A, 7) -> (..., N, 7)."""
    lead = deltas.shape[:-3]
    d = deltas.reshape(lead + (-1, 7))
    a = anchors.reshape(-1, 7).to(d.dtype)
    diag = torch.sqrt(a[:, 4] ** 2 + a[:, 5] ** 2)
    xy = d[..., 0:2] * diag[:, None] + a[:, 0:2]
    z = d[..., 2:3] * a[:, 3:4] + a[:, 2:3]
    # clip the log-dim residuals so an untrained head cannot overflow exp
    hwl = torch.exp(d[..., 3:6].clamp(-10.0, 10.0)) * a[:, 3:6]
    yaw = d[..., 6:7] + a[:, 6:7]
    return torch.cat([xy, z, hwl, yaw], dim=-1)


class Detections(NamedTuple):
    """Fixed-size decoded detections (post-NMS), score order."""

    corners3d: torch.Tensor  # (K, 8, 3) in ego frame
    boxes7: torch.Tensor     # (K, 7)
    scores: torch.Tensor     # (K,)
    valid: torch.Tensor      # (K,) bool


def decode_and_nms(cls_preds, reg_preds, dir_preds, anchors,
                   transformation_matrix, gt_range, *,
                   score_threshold: float = 0.2, nms_thresh: float = 0.15,
                   topk: int = 512, dir_offset: float = 0.7853,
                   num_bins: int = 2, order: str = "hwl") -> Detections:
    """Single-sample decode of (H', W', A), (H', W', A*7), (H', W', A*nb)
    head outputs: sigmoid, anchor decode, direction fix, top-K, sanity
    filters, rotated NMS."""
    prob = torch.sigmoid(cls_preds.reshape(-1))
    boxes = delta_to_boxes3d(reg_preds, anchors)

    dir_labels = torch.argmax(dir_preds.reshape(-1, num_bins), dim=-1)
    period = 2 * np.pi / num_bins
    dir_rot = box_utils.limit_period(boxes[:, 6] - dir_offset, 0.0, period)
    yaw = dir_rot + dir_offset + period * dir_labels.to(boxes.dtype)
    yaw = box_utils.limit_period(yaw, 0.5, 2 * np.pi)
    boxes = torch.cat([boxes[:, :6], yaw[:, None]], dim=1)

    masked = torch.where(prob > score_threshold, prob, torch.zeros_like(prob))
    k = min(topk, masked.shape[0])
    # a stable sort keeps the lower index first among equal scores, as
    # jax.lax.top_k does
    top_scores, top_idx = torch.sort(masked, descending=True, stable=True)
    top_scores, top_idx = top_scores[:k], top_idx[:k]
    top_boxes = boxes[top_idx]
    top_valid = top_scores > score_threshold

    corners = box_utils.boxes_to_corners_3d(top_boxes, order)
    corners = box_utils.project_box3d(corners, transformation_matrix)
    keep = box_utils.remove_large_pred_bbx(corners)
    keep &= box_utils.remove_bbx_abnormal_z(corners)
    keep &= box_utils.mask_boxes_outside_range(corners, gt_range)
    top_valid &= keep

    ordr, kept = rotated_nms(corners[:, :4, :2], top_scores, top_valid,
                             nms_thresh)
    return Detections(corners3d=corners[ordr], boxes7=top_boxes[ordr],
                      scores=top_scores[ordr], valid=kept)
