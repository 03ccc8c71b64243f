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
# the template on each (dtype, device), copied from the host once: a copy
# from the host cannot be captured in a CUDA graph
_TEMPLATES: dict = {}


def _corner_template(dtype, device) -> torch.Tensor:
    t = _TEMPLATES.get((dtype, device))
    if t is None:
        t = _TEMPLATES[(dtype, device)] = torch.as_tensor(
            _CORNER_TEMPLATE, dtype=dtype, device=device)
    return t


def boxes_to_corners_3d(boxes, order: str):
    """(N, 7) boxes -> (N, 8, 3) corners."""
    if order == "hwl":
        if isinstance(boxes, torch.Tensor):
            # slices, not an index list (its copy from the host cannot be
            # captured in a CUDA graph)
            boxes = torch.cat((boxes[:, :3], boxes[:, 3:6].flip(1),
                               boxes[:, 6:]), dim=1)
        else:
            boxes = boxes[:, (0, 1, 2, 5, 4, 3, 6)]
    elif order != "lwh":
        raise ValueError(f"unknown box order {order}")
    if isinstance(boxes, torch.Tensor):
        template = _corner_template(boxes.dtype, boxes.device)
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


def project_box3d(corners3d, transformation_matrix):
    """(N, 8, 3) corners through a (4, 4) transform, in the corners' type:
    numpy (host, ``hom @ T.T``) or torch."""
    n = corners3d.shape[0]
    if not isinstance(corners3d, torch.Tensor):
        hom = np.concatenate(
            [corners3d, np.ones((n, 8, 1), dtype=corners3d.dtype)], axis=-1)
        tfm = np.asarray(transformation_matrix, dtype=corners3d.dtype)
        return (hom @ tfm.T)[..., :3]
    ones = corners3d.new_ones((n, 8, 1))
    hom = torch.cat([corners3d, ones], dim=-1)
    tfm = transformation_matrix.to(corners3d.dtype)
    return torch.einsum("nkj,ij->nki", hom, tfm)[..., :3]


def create_bbx(extent):
    """(8, 3) corners of a box of half-extents [l/2, w/2, h/2] in its own
    frame (float64), in the template's corner order."""
    e = np.asarray(extent, dtype=np.float64)
    return _CORNER_TEMPLATE.astype(np.float64) * 2.0 * e[None, :]


def create_bbx_batch(extents: np.ndarray) -> np.ndarray:
    """(K, 3) half-extents -> (K, 8, 3) corners (``create_bbx`` of each)."""
    e = np.asarray(extents, dtype=np.float64)
    return _CORNER_TEMPLATE.astype(np.float64)[None] * 2.0 * e[:, None, :]


def corner_to_center(corner3d: np.ndarray, order: str = "lwh") -> np.ndarray:
    """(N, 8, 3) corners -> (N, 7) float32 boxes (numpy): the centre of the
    four corners 0, 3, 5, 6, the mean height, the four bottom and top edge
    lengths averaged for l and w, and the four edge yaws averaged."""
    xyz = np.mean(corner3d[:, [0, 3, 5, 6], :], axis=1)
    h = np.abs(np.mean(corner3d[:, 4:, 2] - corner3d[:, :4, 2], axis=1,
                       keepdims=True))

    def _elen(i, j):
        return np.sqrt(((corner3d[:, i, :2] - corner3d[:, j, :2]) ** 2).sum(
            axis=1, keepdims=True))

    def _eyaw(i, j):
        return np.arctan2(corner3d[:, i, 1] - corner3d[:, j, 1],
                          corner3d[:, i, 0] - corner3d[:, j, 0])

    l = (_elen(0, 3) + _elen(2, 1) + _elen(4, 7) + _elen(5, 6)) / 4
    w = (_elen(0, 1) + _elen(2, 3) + _elen(4, 5) + _elen(6, 7)) / 4
    theta = ((_eyaw(1, 2) + _eyaw(0, 3) + _eyaw(5, 6) + _eyaw(4, 7))
             / 4)[:, None]
    if order == "lwh":
        return np.concatenate([xyz, l, w, h, theta], axis=1).astype(np.float32)
    if order == "hwl":
        return np.concatenate([xyz, h, w, l, theta], axis=1).astype(np.float32)
    raise ValueError(f"unknown box order {order}")


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


def remove_large_pred_bbx(corners3d, max_len: float = 6.0):
    """Drop boxes whose x/y extents exceed ``max_len`` m (and those with
    zero y extent, the reference's z_len quirk)."""
    x_len = corners3d[..., 0].amax(1) - corners3d[..., 0].amin(1)
    y_len = corners3d[..., 1].amax(1) - corners3d[..., 1].amin(1)
    return (x_len <= max_len) & (y_len <= max_len) & (y_len > 0)


def remove_bbx_abnormal_z(corners3d, z_min: float = -3.0, z_max: float = 1.0):
    zs = corners3d[..., 2]
    return (zs.amin(1) >= z_min) & (zs.amax(1) <= z_max)
