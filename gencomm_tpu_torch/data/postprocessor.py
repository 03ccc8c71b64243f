"""Anchors, box decoding and NMS post-processing.

Counterpart of ``gencomm_tpu/data/postprocessor.py``: ``generate_anchor_box``
and the anchor labels ``generate_label`` (numpy, host; the exact sparse
path for regular grids and the dense IoU path, with the same float32
operation order, so thresholds and argmax ties fall the same way), and
``delta_to_boxes3d`` and ``decode_and_nms`` (torch, on the device of the
head outputs).
"""

from __future__ import annotations

import hashlib
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


# Per-anchor-grid statics for the sparse label path: anchors are the SAME
# array every frame (built once from the yaml), so corners/standups/diag
# are cached, and the regular grid structure lets candidate anchors per GT
# be found analytically instead of via a dense (H'*W'*A, n_gt) IoU.
_ANCHOR_STATICS: dict = {}


def _anchor_statics(anchors: np.ndarray, order: str):
    # keyed on every byte of the grid (and the box order): two grids that
    # differ anywhere get their own statics
    key = (anchors.shape, anchors.dtype.str, order,
           hashlib.sha256(np.ascontiguousarray(anchors).tobytes()).hexdigest())
    hit = _ANCHOR_STATICS.get(key)
    if hit is not None:
        return hit
    h, w, a = anchors.shape[:3]
    xs = anchors[0, :, 0, 0]
    ys = anchors[:, 0, 0, 1]
    # structured iff centers form a regular separable grid and every
    # anchor type has constant size/yaw across the grid
    structured = (
        np.all(np.diff(xs) > 0) and np.all(np.diff(ys) > 0)
        and np.allclose(anchors[..., 0], xs[None, :, None])
        and np.allclose(anchors[..., 1], ys[:, None, None])
        and all(
            np.allclose(anchors[..., k], anchors[0, 0, :, k][None, None, :])
            for k in (2, 3, 4, 5, 6)
        )
    )
    stat = {"structured": bool(structured)}
    if structured:
        # corner OFFSETS per type: boxes_to_corners_3d computes
        # rotated_template + center, so offsets are center-independent fp
        # values, and min/max over (cx + off_j) == cx + min/max(off_j)
        # (rounding is monotone) — the sparse standups below are BIT-EXACT
        # equal to the dense corners_to_standup_2d path
        rep = anchors[0, 0].copy()  # (A, 7)
        rep[:, 0:2] = 0.0
        corners = box_utils.boxes_to_corners_3d(rep, order)
        standup = box_utils.corners_to_standup_2d(corners[:, :4])
        stat["off"] = np.asarray(standup)  # (A, 4) xmin/ymin/xmax/ymax
        stat["xs"], stat["ys"] = xs.copy(), ys.copy()
        diag = np.sqrt(anchors[0, 0, :, 4] ** 2 + anchors[0, 0, :, 5] ** 2)
        stat["diag"] = diag
    else:
        anchors_flat = anchors.reshape(-1, 7)
        corners = box_utils.boxes_to_corners_3d(anchors_flat, order)
        stat["standup"] = box_utils.corners_to_standup_2d(corners[:, :4])
        stat["diag"] = np.sqrt(
            anchors_flat[:, 4] ** 2 + anchors_flat[:, 5] ** 2)
    if len(_ANCHOR_STATICS) > 8:
        _ANCHOR_STATICS.clear()
    _ANCHOR_STATICS[key] = stat
    return stat


def _sparse_candidate_iou(stat: dict, gt_standup: np.ndarray,
                          fm_shape, anchor_num):
    """All (anchor_flat_idx, gt_idx, iou) covering every anchor with
    iou > 0, in the same row-major (anchor-major) order np.where would
    produce. The IoU values replicate box_utils.aligned_iou_2d op-for-op
    in float32, so thresholds and argmax tie-breaks are bit-identical to
    the dense path."""
    xs, ys = stat["xs"], stat["ys"]
    off = stat["off"]  # (A, 4)
    h, w = fm_shape
    gt_standup = np.asarray(gt_standup, np.float32)
    idx_list, gt_list, iou_list = [], [], []
    for g, (gx0, gy0, gx1, gy1) in enumerate(gt_standup):
        g_area = np.float32((gx1 - gx0) * (gy1 - gy0))
        for a in range(anchor_num):
            ox0, oy0, ox1, oy1 = off[a]
            # candidate gate (1-cell safety margin for fp rounding):
            # overlap needs cx + ox1 > gx0 and cx + ox0 < gx1
            j0 = max(np.searchsorted(xs, gx0 - ox1, side="left") - 1, 0)
            j1 = min(np.searchsorted(xs, gx1 - ox0, side="right") + 1,
                     len(xs))
            i0 = max(np.searchsorted(ys, gy0 - oy1, side="left") - 1, 0)
            i1 = min(np.searchsorted(ys, gy1 - oy0, side="right") + 1,
                     len(ys))
            if j0 >= j1 or i0 >= i1:
                continue
            sx0 = xs[j0:j1] + ox0
            sx1 = xs[j0:j1] + ox1
            sy0 = ys[i0:i1] + oy0
            sy1 = ys[i0:i1] + oy1
            # aligned_iou_2d op order, float32
            iw = np.clip(np.minimum(sx1, gx1) - np.maximum(sx0, gx0),
                         0, None)  # (nx,)
            ih = np.clip(np.minimum(sy1, gy1) - np.maximum(sy0, gy0),
                         0, None)  # (ny,)
            inter = ih[:, None] * iw[None, :]
            area_a = ((sx1 - sx0)[None, :]
                      * np.broadcast_to((sy1 - sy0)[:, None],
                                        (i1 - i0, j1 - j0)))
            union = area_a + g_area - inter
            iou = np.where(union > 0,
                           inter / np.where(union > 0, union,
                                            np.float32(1.0)),
                           np.float32(0.0))
            ii, jj = np.meshgrid(np.arange(i0, i1), np.arange(j0, j1),
                                 indexing="ij")
            idx_list.append((ii * w + jj).ravel() * anchor_num + a)
            gt_list.append(np.full(ii.size, g, np.int64))
            iou_list.append(iou.astype(np.float32).ravel())
    if not idx_list:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float32))
    cand_idx = np.concatenate(idx_list)
    cand_gt = np.concatenate(gt_list)
    cand_iou = np.concatenate(iou_list)
    # match dense np.where order: anchor-major, then gt
    o = np.lexsort((cand_gt, cand_idx))
    return cand_idx[o], cand_gt[o], cand_iou[o]


def generate_label(gt_box_center: np.ndarray, gt_mask: np.ndarray,
                   anchors: np.ndarray, pos_threshold: float,
                   neg_threshold: float, order: str = "hwl") -> dict:
    """Anchor target assignment (numpy, host side).

    gt_box_center: (max_num, 7) hwl-order boxes; gt_mask: (max_num,).
    anchors: (H', W', A, 7). Returns pos/neg/targets arrays shaped like the
    reference (pos_equal_one (H',W',A), targets (H',W',A*7)).

    Fast path: for the regular anchor grids every shipped config uses, the
    dense (H'*W'*A, n_gt) standup-IoU is replaced by an exact sparse
    computation over the analytically-found overlapping anchors (identical
    outputs).
    """
    if order != "hwl":
        raise ValueError(f"labels are generated for 'hwl' boxes, got {order!r}")
    fm_shape = anchors.shape[:2]
    anchor_num = anchors.shape[2]
    anchors_flat = anchors.reshape(-1, 7)

    pos_equal_one = np.zeros((*fm_shape, anchor_num), np.float32)
    neg_equal_one = np.zeros((*fm_shape, anchor_num), np.float32)
    targets = np.zeros((*fm_shape, anchor_num * 7), np.float32)

    gt_valid = gt_box_center[gt_mask == 1]
    if gt_valid.shape[0] == 0:
        neg_equal_one[...] = 1
        return {
            "pos_equal_one": pos_equal_one,
            "neg_equal_one": neg_equal_one,
            "targets": targets,
        }

    stat = _anchor_statics(anchors, order)
    anchors_d = stat["diag"]
    if stat["structured"]:
        anchors_d = np.broadcast_to(
            anchors_d[None, :], (anchors_flat.shape[0] // anchor_num,
                                 anchor_num)).reshape(-1)
    gt_corners = box_utils.boxes_to_corners_3d(gt_valid, order)
    gt_standup = box_utils.corners_to_standup_2d(gt_corners[:, :4])

    if stat["structured"] and 0 < neg_threshold <= pos_threshold:
        return _generate_label_sparse(
            stat, gt_valid, gt_standup, anchors_flat, anchors_d,
            fm_shape, anchor_num, pos_threshold, neg_threshold,
            pos_equal_one, neg_equal_one, targets)

    anchor_standup = stat["standup"]
    iou = box_utils.aligned_iou_2d(anchor_standup, gt_standup)  # (N_a, n_gt)
    return _finish_label_dense(
        iou, gt_valid, anchors_flat, anchors_d, fm_shape, anchor_num,
        pos_threshold, neg_threshold, pos_equal_one, neg_equal_one, targets)


def _generate_label_sparse(stat, gt_valid, gt_standup, anchors_flat,
                           anchors_d, fm_shape, anchor_num,
                           pos_threshold, neg_threshold,
                           pos_equal_one, neg_equal_one, targets):
    n_gt = gt_valid.shape[0]
    cand_idx, cand_gt, cand_iou = _sparse_candidate_iou(
        stat, gt_standup, fm_shape, anchor_num)

    # best anchor per gt (forced positive if iou > 0) — non-candidates all
    # have iou == 0, so the restricted argmax is exact. Dense argmax takes
    # the FIRST (lowest anchor idx) maximum; cand_* is anchor-major sorted
    # so a stable per-gt argmax reproduces that tie-break.
    id_highest, id_highest_gt = [], []
    for g in range(n_gt):
        sel = cand_gt == g
        if not np.any(sel):
            continue
        vals = cand_iou[sel]
        best = np.argmax(vals)  # first max in anchor-major order
        if vals[best] > 0:
            id_highest.append(cand_idx[sel][best])
            id_highest_gt.append(g)
    id_highest = np.asarray(id_highest, np.int64)
    id_highest_gt = np.asarray(id_highest_gt, np.int64)

    pos_sel = cand_iou > pos_threshold
    id_pos = _set_positives(
        np.concatenate([cand_idx[pos_sel], id_highest]),
        np.concatenate([cand_gt[pos_sel], id_highest_gt]),
        gt_valid, anchors_flat, anchors_d, pos_equal_one, targets)

    # negative = NO gt with iou >= neg_threshold (non-candidates are 0)
    neg_equal_one[...] = 1
    blocked = np.unique(cand_idx[cand_iou >= neg_threshold])
    ix, iy, iz = np.unravel_index(blocked, (*fm_shape, anchor_num))
    neg_equal_one[ix, iy, iz] = 0
    # positives must not stay negative either
    ix, iy, iz = np.unravel_index(id_pos, (*fm_shape, anchor_num))
    neg_equal_one[ix, iy, iz] = 0
    # (forced-positive clearing is implied: id_highest ⊆ id_pos)

    return {
        "pos_equal_one": pos_equal_one,
        "neg_equal_one": neg_equal_one,
        "targets": targets,
    }


def _finish_label_dense(iou, gt_valid, anchors_flat, anchors_d, fm_shape,
                        anchor_num, pos_threshold, neg_threshold,
                        pos_equal_one, neg_equal_one, targets):

    # best anchor per gt (forced positive if iou > 0)
    id_highest = np.argmax(iou, axis=0)
    id_highest_gt = np.arange(iou.shape[1])
    has_overlap = iou[id_highest, id_highest_gt] > 0
    id_highest, id_highest_gt = id_highest[has_overlap], id_highest_gt[has_overlap]

    id_pos, id_pos_gt = np.where(iou > pos_threshold)
    id_neg = np.where((iou < neg_threshold).sum(axis=1) == iou.shape[1])[0]

    _set_positives(np.concatenate([id_pos, id_highest]),
                   np.concatenate([id_pos_gt, id_highest_gt]),
                   gt_valid, anchors_flat, anchors_d, pos_equal_one, targets)

    ix, iy, iz = np.unravel_index(id_neg, (*fm_shape, anchor_num))
    neg_equal_one[ix, iy, iz] = 1
    # a forced-positive anchor must not stay negative
    ix, iy, iz = np.unravel_index(id_highest, (*fm_shape, anchor_num))
    neg_equal_one[ix, iy, iz] = 0

    return {
        "pos_equal_one": pos_equal_one,
        "neg_equal_one": neg_equal_one,
        "targets": targets,
    }


def _set_positives(id_pos, id_pos_gt, gt_valid, anchors_flat, anchors_d,
                   pos_equal_one, targets):
    """Mark the positive anchors (flat ids, each with its GT; the first GT
    listed for an anchor wins) and write their regression targets. Returns
    the unique positive ids."""
    id_pos, index = np.unique(id_pos, return_index=True)
    id_pos_gt = id_pos_gt[index]

    ix, iy, iz = np.unravel_index(id_pos, pos_equal_one.shape)
    pos_equal_one[ix, iy, iz] = 1

    a = anchors_flat[id_pos]
    d = anchors_d[id_pos]
    g = gt_valid[id_pos_gt]
    targets[ix, iy, iz * 7 + 0] = (g[:, 0] - a[:, 0]) / d
    targets[ix, iy, iz * 7 + 1] = (g[:, 1] - a[:, 1]) / d
    targets[ix, iy, iz * 7 + 2] = (g[:, 2] - a[:, 2]) / a[:, 3]
    targets[ix, iy, iz * 7 + 3] = np.log(g[:, 3] / a[:, 3])
    targets[ix, iy, iz * 7 + 4] = np.log(g[:, 4] / a[:, 4])
    targets[ix, iy, iz * 7 + 5] = np.log(g[:, 5] / a[:, 5])
    targets[ix, iy, iz * 7 + 6] = g[:, 6] - a[:, 6]
    return id_pos


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
