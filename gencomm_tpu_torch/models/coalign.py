"""CoAlign: agent-pose refinement by aligning the agents' detected boxes.

Counterpart of ``gencomm_tpu/models/coalign.py`` (the reference's box
alignment and g2o SE2 pose graph, written as a dense Gauss-Newton), in
plain PyTorch on the caller's device; it is no TPU kernel (the JAX package
computes it outside Pallas). With every agent's boxes projected to the
world under the noisy poses:

1. boxes of different agents whose world centers lie within ``thres`` are
   joined, and each connected component is labelled by its smallest member
   index (min-label propagation over the (M, M) threshold graph, L sweeps:
   a component holds at most one box an agent, so its diameter is below L);
2. each cluster's landmark is eliminated (Schur complement): for quadratic
   residuals the best landmark given the poses is the certainty-weighted
   mean of its members (a weighted circular mean for yaw), so a box's
   residual is its deviation from its cluster's mean, and agents that share
   a cluster constrain each other whether the ego saw it or not;
3. Gauss-Newton with a damped normal matrix over the non-ego agents'
   (x, y, yaw) corrections; the ego is the gauge and stays fixed.

Segment sums are products with the one-hot cluster matrix (M <= a few
hundred boxes), so a run gives the same bits every time on either device.
"""

from __future__ import annotations

import numpy as np
import torch

from gencomm_tpu_torch import resolve_device

# the anchor's diagonal, which scales the xy certainty (the reference's
# box_align_v2.py)
_W_A, _L_A = 1.6, 3.9
_D_A_SQUARE = _W_A ** 2 + _L_A ** 2


def _wrap(a: torch.Tensor) -> torch.Tensor:
    return torch.atan2(torch.sin(a), torch.cos(a))


def _world(poses, centers, yaws):
    """(M, 2) world box centers and (M,) world yaws of (L, K) own-frame
    boxes under (L, 3) poses [x, y, yaw]."""
    c, s = torch.cos(poses[:, 2:3]), torch.sin(poses[:, 2:3])
    x = centers[..., 0] * c - centers[..., 1] * s + poses[:, 0:1]
    y = centers[..., 0] * s + centers[..., 1] * c + poses[:, 1:2]
    return (torch.stack([x, y], -1).reshape(-1, 2),
            (yaws + poses[:, 2:3]).reshape(-1))


def cluster_labels(init_xy: torch.Tensor, valid: torch.Tensor,
                   agent_of: torch.Tensor, thres: float,
                   n_sweeps: int) -> torch.Tensor:
    """(M,) labels of the connected components of the cross-agent threshold
    graph over the world centers ``init_xy`` (M, 2): each component
    labelled by its smallest member index; an invalid box keeps its own."""
    m = init_xy.shape[0]
    d2 = ((init_xy[:, None, :] - init_xy[None, :, :]) ** 2).sum(-1)
    adj = ((d2 < thres ** 2) & (agent_of[:, None] != agent_of[None, :])
           & valid[:, None] & valid[None, :])
    label = torch.arange(m, device=init_xy.device)
    none = torch.full((m, m), m, device=init_xy.device)
    for _ in range(n_sweeps):
        label = torch.minimum(label, torch.where(adj, label[None, :],
                                                 none).min(dim=1).values)
    return label


def box_align_relative(centers, yaws, box_mask, poses_se2, uncertainty=None,
                       thres: float = 1.5, iterations: int = 10,
                       damping: float = 1e-3, landmark_se2: bool = True,
                       adaptive_landmark: bool = False,
                       yaw_var_thres: float = 0.2) -> torch.Tensor:
    """Refined (L, 3) SE2 poses [x, y, yaw (rad)], the ego's (agent 0)
    unchanged, so that the agents' boxes agree in the world frame.

    centers (L, K, 2) box centers and yaws (L, K) in each agent's own frame,
    box_mask (L, K) bool, poses_se2 (L, 3) the noisy world poses, all on one
    device; ``uncertainty`` (L, K, 3), where given, the log sigma^2 of x, y
    and yaw, weighted exp(-u) with xy over the anchor's squared diagonal
    (unit weights without it). ``landmark_se2``: the clusters' yaws are
    residuals too (xy only without it); ``adaptive_landmark``: a cluster
    whose yaws' circular variance exceeds ``yaw_var_thres`` keeps xy only.
    """
    L, K = box_mask.shape
    M = L * K
    dev, dt = poses_se2.device, poses_se2.dtype
    if L < 2:  # the ego alone: nothing to refine
        return poses_se2.clone()
    agent_of = torch.arange(L, device=dev).repeat_interleave(K)
    valid = box_mask.reshape(M)
    if uncertainty is None:
        w = torch.ones(M, 3, device=dev, dtype=dt)
    else:
        w = torch.exp(-uncertainty.reshape(M, 3))
        w = torch.cat([w[:, :2] / _D_A_SQUARE, w[:, 2:]], 1)
    w = w * valid[:, None].to(dt)

    init_xy, init_yaw = _world(poses_se2, centers, yaws)
    label = cluster_labels(init_xy, valid, agent_of, thres, n_sweeps=L)
    # cluster c's sum of v: onehot[c] @ v
    onehot = (label[None, :] == torch.arange(M, device=dev)[:, None]).to(dt)
    wy = w[:, 2]
    sin_s, cos_s = onehot @ (wy * torch.sin(init_yaw)), \
        onehot @ (wy * torch.cos(init_yaw))
    wy_s = onehot @ wy
    # circular variance in [0, 1]: 1 - |mean resultant|
    rbar = torch.sqrt(sin_s ** 2 + cos_s ** 2) / torch.clamp(wy_s, min=1e-9)
    yaw_ok = (1.0 - rbar) <= yaw_var_thres
    if not landmark_se2:
        use_yaw = torch.zeros(M, dtype=torch.bool, device=dev)
    elif adaptive_landmark:
        use_yaw = yaw_ok
    else:
        use_yaw = torch.ones(M, dtype=torch.bool, device=dev)
    sqw = torch.sqrt(w)
    wx_s, wyy_s = onehot @ w[:, 0], onehot @ w[:, 1]

    def residuals(delta_flat):
        delta = torch.cat([torch.zeros(1, 3, device=dev, dtype=dt),
                           delta_flat.reshape(L - 1, 3)], 0)
        xy, yw = _world(poses_se2 + delta, centers, yaws)
        mean_x = (onehot @ (w[:, 0] * xy[:, 0])) / torch.clamp(wx_s, min=1e-9)
        mean_y = (onehot @ (w[:, 1] * xy[:, 1])) / torch.clamp(wyy_s,
                                                               min=1e-9)
        ssin, scos = onehot @ (wy * torch.sin(yw)), onehot @ (wy * torch.cos(yw))
        # an empty cluster's atan2(0, 0) has no gradient: pin it to (0, 1);
        # its residuals weigh nothing
        safe = wy_s > 1e-9
        mean_yaw = torch.atan2(torch.where(safe, ssin, torch.zeros_like(ssin)),
                               torch.where(safe, scos, torch.ones_like(scos)))
        # a singleton cluster's mean is the box itself: no constraint
        r_x = sqw[:, 0] * (xy[:, 0] - mean_x[label])
        r_y = sqw[:, 1] * (xy[:, 1] - mean_y[label])
        r_yaw = sqw[:, 2] * _wrap(yw - mean_yaw[label]) * \
            use_yaw[label].to(dt)
        return torch.stack([r_x, r_y, r_yaw], 1).reshape(-1)

    n = 3 * (L - 1)
    delta = torch.zeros(n, device=dev, dtype=dt)
    eye = torch.eye(n, device=dev, dtype=dt)
    for _ in range(iterations):
        r = residuals(delta)
        jac = torch.func.jacfwd(residuals)(delta)
        hess = jac.T @ jac + damping * eye
        delta = delta - torch.linalg.solve(hess, jac.T @ r)
    return poses_se2 + torch.cat([torch.zeros(1, 3, device=dev, dtype=dt),
                                  delta.reshape(L - 1, 3)], 0)


def refine_poses_np(pred_boxes, box_masks, noisy_poses_6dof,
                    uncertainty=None, thres: float = 1.5,
                    iterations: int = 10, device=None, **kwargs) -> np.ndarray:
    """numpy in and out, for the data pipeline: (L, K, 7) hwl boxes in each
    agent's own frame, (L, K) masks, (L, 6) noisy poses [x, y, z, roll,
    yaw (deg), pitch] and, optionally, (L, K, 3) log sigma^2 -> (L, 6) poses
    with x, y and yaw refined (``box_align_relative`` in fp32 on
    ``device``, ``cuda`` unless ``device="cpu"``)."""
    dev = resolve_device(device)
    poses = np.asarray(noisy_poses_6dof, np.float64)
    se2 = np.stack([poses[:, 0], poses[:, 1], np.radians(poses[:, 4])], 1)
    boxes = np.asarray(pred_boxes)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    refined = box_align_relative(
        t(boxes[:, :, :2]), t(boxes[:, :, 6]), t(box_masks, torch.bool),
        t(se2), None if uncertainty is None else t(uncertainty),
        thres=thres, iterations=iterations, **kwargs).cpu().numpy()
    out = poses.copy()
    out[:, 0] = refined[:, 0]
    out[:, 1] = refined[:, 1]
    out[:, 4] = np.degrees(refined[:, 2])
    return out
