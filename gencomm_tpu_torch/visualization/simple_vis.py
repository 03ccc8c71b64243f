"""BEV pictures of detections against ground truth, and of feature maps.

Counterpart of ``gencomm_tpu/visualization/simple_vis.py``: ``visualize``
draws one frame's lidar points (gray), ground-truth boxes (green) and
predicted boxes (red), each box's bottom quad in bird's-eye view, and
writes a PNG; ``vis_bev_feature`` writes an (H, W, C) map's channel mean
or max as an image. matplotlib (with the headless Agg backend) is imported
when a function draws, so importing this module needs no matplotlib.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def bev_quads(corners3d) -> np.ndarray:
    """(N, 8, 3) corners -> (N, 5, 2) closed bottom quads in BEV."""
    c = np.asarray(corners3d, np.float64).reshape(-1, 8, 3)
    return np.concatenate([c[:, :4, :2], c[:, :1, :2]], axis=1)


def points_in_range(points, lidar_range) -> np.ndarray:
    """The points (P, 3+) inside the range's x and y bounds."""
    pts = np.asarray(points)
    keep = ((pts[:, 0] >= lidar_range[0]) & (pts[:, 0] <= lidar_range[3])
            & (pts[:, 1] >= lidar_range[1]) & (pts[:, 1] <= lidar_range[4]))
    return pts[keep]


def _draw_boxes_bev(ax, corners3d, color: str, label: str):
    for i, quad in enumerate(bev_quads(corners3d)):
        ax.plot(quad[:, 0], quad[:, 1], color=color, linewidth=1.0,
                label=label if i == 0 else None)


def visualize(pred_corners3d, gt_corners3d, points, lidar_range,
              save_path: str, method: str = "bev", scores=None) -> str:
    """One frame's BEV PNG at ``save_path``: pred / gt corners (N, 8, 3),
    lidar points (P, 3+) in the ego frame, ``lidar_range`` [xmin, ymin,
    zmin, xmax, ymax, zmax]. ``method`` and ``scores`` are accepted as the
    JAX function has them."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(12, 6))
    if points is not None and len(points):
        pts = points_in_range(points, lidar_range)
        ax.scatter(pts[:, 0], pts[:, 1], s=0.1, c="gray", alpha=0.5)
    if gt_corners3d is not None and len(gt_corners3d):
        _draw_boxes_bev(ax, gt_corners3d, "tab:green", "GT")
    if pred_corners3d is not None and len(pred_corners3d):
        _draw_boxes_bev(ax, pred_corners3d, "tab:red", "pred")
    ax.set_xlim(lidar_range[0], lidar_range[3])
    ax.set_ylim(lidar_range[1], lidar_range[4])
    ax.set_aspect("equal")
    ax.legend(loc="upper right")
    fig.savefig(save_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return save_path


def bev_feature_image(feature, mode: str = "mean") -> np.ndarray:
    """(H, W, C) -> the (H, W) image ``vis_bev_feature`` draws."""
    f = np.asarray(feature)
    return f.mean(-1) if mode == "mean" else f.max(-1)


def vis_bev_feature(feature, save_path: str, mode: str = "mean") -> str:
    """An (H, W, C) map's channel mean (or max) as a PNG."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 5))
    ax.imshow(bev_feature_image(feature, mode), cmap="viridis",
              origin="lower")
    ax.axis("off")
    fig.savefig(save_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return save_path
