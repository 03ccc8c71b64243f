"""Early fusion (Cooper): every agent's point cloud merged into the ego
frame, on the host.

Counterpart of ``gencomm_tpu/data/early_fusion.py``: each agent's cloud is
projected to the ego frame with its pairwise transform, the clouds are
concatenated, masked to the ego's lidar range, and the result is one agent.
Static shapes: L x P points a sample with a validity mask.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def merge_points_to_ego(batch: Dict[str, np.ndarray], lidar_range=None,
                        modality: str = "m1") -> Dict[str, np.ndarray]:
    """The batch with the (B, L, P, 4) clouds of ``modality`` merged into
    (B, 1, L P, 4) in the ego frame, one agent slot left (its pairwise
    transform the identity); points outside ``lidar_range`` (x, y, z min and
    max), where given, are masked out."""
    pts = np.asarray(batch[f"points_{modality}"])
    mask = np.asarray(batch[f"point_mask_{modality}"])
    tfm = np.asarray(batch["pairwise_t_matrix"])
    amask = np.asarray(batch["agent_mask"])
    b, l, p, _ = pts.shape

    out_pts = np.zeros((b, 1, l * p, 4), pts.dtype)
    out_mask = np.zeros((b, 1, l * p), mask.dtype)
    for i in range(b):
        chunks, valids = [], []
        for j in range(l):
            xyz1 = np.concatenate([pts[i, j, :, :3],
                                   np.ones((p, 1), pts.dtype)], axis=1)
            # agent j -> ego: row 0 of the pairwise transforms
            proj = xyz1 @ tfm[i, j, 0].T.astype(pts.dtype)
            chunks.append(np.concatenate([proj[:, :3], pts[i, j, :, 3:4]],
                                         axis=1))
            valids.append(mask[i, j] * amask[i, j])
        allp = np.concatenate(chunks, axis=0)
        allv = np.concatenate(valids, axis=0)
        if lidar_range is not None:
            r = lidar_range
            inside = ((allp[:, 0] >= r[0]) & (allp[:, 0] <= r[3])
                      & (allp[:, 1] >= r[1]) & (allp[:, 1] <= r[4])
                      & (allp[:, 2] >= r[2]) & (allp[:, 2] <= r[5]))
            allv = allv * inside
        out_pts[i, 0] = allp
        out_mask[i, 0] = allv

    out = dict(batch)
    out[f"points_{modality}"] = out_pts
    out[f"point_mask_{modality}"] = out_mask
    out["agent_mask"] = np.ones((b, 1), amask.dtype)
    out["pairwise_t_matrix"] = np.broadcast_to(
        np.eye(4, dtype=tfm.dtype), (b, 1, 1, 4, 4)).copy()
    if f"modality_mask_{modality}" in batch:
        out[f"modality_mask_{modality}"] = np.ones((b, 1), np.float32)
    return out
