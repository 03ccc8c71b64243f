"""3D bounding-box geometry.

Counterpart of ``gencomm_tpu/utils/box_utils.py``. The corner functions
take a numpy array (host) or a torch tensor (device) and answer in kind;
``corners_to_standup_2d`` and ``aligned_iou_2d`` serve the host labels
(numpy), ``limit_period`` and the box filters the device (torch). Boxes
are ``(x, y, z, h, w, l, yaw)`` for order 'hwl' and ``(x, y, z, l, w, h,
yaw)`` for 'lwh'; the bottom face is corners 0..3, counter-clockwise.
"""

from __future__ import annotations

import numpy as np
import torch

_CORNER_TEMPLATE = np.array(
    [
        [1, -1, -1], [1, 1, -1], [-1, 1, -1], [-1, -1, -1],
        [1, -1, 1], [1, 1, 1], [-1, 1, 1], [-1, -1, 1],
    ],
    dtype=np.float32,
) / 2.0


def boxes_to_corners_3d(boxes, order: str):
    """(N, 7) boxes -> (N, 8, 3) corners."""
    if order == "hwl":
        boxes = boxes[:, (0, 1, 2, 5, 4, 3, 6)]
    elif order != "lwh":
        raise ValueError(f"unknown box order {order}")
    if isinstance(boxes, torch.Tensor):
        template = torch.as_tensor(_CORNER_TEMPLATE, dtype=boxes.dtype,
                                   device=boxes.device)
        corners = boxes[:, None, 3:6] * template[None]
        c, s = torch.cos(boxes[:, 6]), torch.sin(boxes[:, 6])
        zeros, ones = torch.zeros_like(c), torch.ones_like(c)
        rot = torch.stack([c, s, zeros, -s, c, zeros, zeros, zeros, ones],
                          dim=-1).reshape(-1, 3, 3)
        corners = torch.einsum("nkj,nji->nki", corners, rot)
        return corners + boxes[:, None, 0:3]
    boxes = np.asarray(boxes)
    corners = boxes[:, None, 3:6] * _CORNER_TEMPLATE[None]
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    rot = np.stack([c, s, zeros, -s, c, zeros, zeros, zeros, ones],
                   axis=-1).reshape(-1, 3, 3)
    return corners @ rot + boxes[:, None, 0:3]


def project_box3d(corners3d: torch.Tensor, transformation_matrix: torch.Tensor):
    """(N, 8, 3) corners through a (4, 4) transform."""
    n = corners3d.shape[0]
    ones = corners3d.new_ones((n, 8, 1))
    hom = torch.cat([corners3d, ones], dim=-1)
    tfm = transformation_matrix.to(corners3d.dtype)
    return torch.einsum("nkj,ij->nki", hom, tfm)[..., :3]


def corners_to_standup_2d(corners: np.ndarray) -> np.ndarray:
    """(N, K, >=2) corners -> (N, 4) [xmin, ymin, xmax, ymax] (numpy)."""
    return np.stack([corners[..., 0].min(axis=1), corners[..., 1].min(axis=1),
                     corners[..., 0].max(axis=1), corners[..., 1].max(axis=1)],
                    axis=-1)


def aligned_iou_2d(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Axis-aligned IoU of standup boxes (N, 4) x (M, 4) -> (N, M) (numpy),
    in the float32 operation order of the JAX package, so that label
    thresholds and argmax ties fall the same way."""
    boxes_a, boxes_b = np.asarray(boxes_a), np.asarray(boxes_b)
    lt = np.maximum(boxes_a[:, None, :2], boxes_b[None, :, :2])
    rb = np.minimum(boxes_a[:, None, 2:], boxes_b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (boxes_a[:, 2] - boxes_a[:, 0]) * (boxes_a[:, 3] - boxes_a[:, 1])
    area_b = (boxes_b[:, 2] - boxes_b[:, 0]) * (boxes_b[:, 3] - boxes_b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def limit_period(val: torch.Tensor, offset: float = 0.5,
                 period: float = 2 * np.pi) -> torch.Tensor:
    """Wrap ``val`` into [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period


def mask_boxes_outside_range(corners3d, limit_range):
    """Keep boxes with at least one corner inside the xy range."""
    xy = corners3d[..., :2]
    inside = ((xy[..., 0] >= limit_range[0]) & (xy[..., 0] <= limit_range[3])
              & (xy[..., 1] >= limit_range[1]) & (xy[..., 1] <= limit_range[4]))
    return inside.any(1)


def remove_large_pred_bbx(corners3d):
    """Drop boxes whose x/y extents exceed 6 m (and those with zero y
    extent, the reference's z_len quirk)."""
    x_len = corners3d[..., 0].amax(1) - corners3d[..., 0].amin(1)
    y_len = corners3d[..., 1].amax(1) - corners3d[..., 1].amin(1)
    return (x_len <= 6) & (y_len <= 6) & (y_len > 0)


def remove_bbx_abnormal_z(corners3d, z_min: float = -3.0, z_max: float = 1.0):
    zs = corners3d[..., 2]
    return (zs.amin(1) >= z_min) & (zs.amax(1) <= z_max)
