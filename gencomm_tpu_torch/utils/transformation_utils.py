"""Pose / transformation-matrix geometry.

Counterpart of ``gencomm_tpu/utils/transformation_utils.py``: numpy for the
host data path, torch for ``normalize_pairwise_tfm`` on the device. CARLA
poses ``[x, y, z, roll, yaw, pitch]`` in degrees.
"""

from __future__ import annotations

import numpy as np
import torch


def x_to_world(pose) -> np.ndarray:
    """Pose [x,y,z,roll,yaw,pitch] (deg) -> 4x4 transform agent->world."""
    x, y, z, roll, yaw, pitch = pose
    c_y, s_y = np.cos(np.radians(yaw)), np.sin(np.radians(yaw))
    c_r, s_r = np.cos(np.radians(roll)), np.sin(np.radians(roll))
    c_p, s_p = np.cos(np.radians(pitch)), np.sin(np.radians(pitch))

    matrix = np.identity(4)
    matrix[0, 3], matrix[1, 3], matrix[2, 3] = x, y, z
    matrix[0, 0] = c_p * c_y
    matrix[0, 1] = c_y * s_p * s_r - s_y * c_r
    matrix[0, 2] = -c_y * s_p * c_r - s_y * s_r
    matrix[1, 0] = s_y * c_p
    matrix[1, 1] = s_y * s_p * s_r + c_y * c_r
    matrix[1, 2] = -s_y * s_p * c_r + c_y * s_r
    matrix[2, 0] = s_p
    matrix[2, 1] = -c_p * s_r
    matrix[2, 2] = c_p * c_r
    return matrix


def x_to_world_batch(poses: np.ndarray) -> np.ndarray:
    """(N, 6) poses (deg) -> (N, 4, 4) agent->world transforms
    (``x_to_world`` of each)."""
    poses = np.asarray(poses, np.float64)
    x, y, z = poses[:, 0], poses[:, 1], poses[:, 2]
    roll, yaw, pitch = (np.radians(poses[:, 3]), np.radians(poses[:, 4]),
                        np.radians(poses[:, 5]))
    c_y, s_y = np.cos(yaw), np.sin(yaw)
    c_r, s_r = np.cos(roll), np.sin(roll)
    c_p, s_p = np.cos(pitch), np.sin(pitch)
    m = np.zeros((len(poses), 4, 4))
    m[:, 0, 0] = c_p * c_y
    m[:, 0, 1] = c_y * s_p * s_r - s_y * c_r
    m[:, 0, 2] = -c_y * s_p * c_r - s_y * s_r
    m[:, 1, 0] = s_y * c_p
    m[:, 1, 1] = s_y * s_p * s_r + c_y * c_r
    m[:, 1, 2] = -s_y * s_p * c_r + c_y * s_r
    m[:, 2, 0] = s_p
    m[:, 2, 1] = -c_p * s_r
    m[:, 2, 2] = c_p * c_r
    m[:, 0, 3], m[:, 1, 3], m[:, 2, 3], m[:, 3, 3] = x, y, z, 1.0
    return m


def x1_to_x2(x1, x2) -> np.ndarray:
    """The transform from pose ``x1``'s frame into pose ``x2``'s (CARLA
    poses or 4 x 4 matrices)."""
    t1 = x1 if isinstance(x1, np.ndarray) and x1.shape == (4, 4) \
        else x_to_world(x1)
    t2 = x2 if isinstance(x2, np.ndarray) and x2.shape == (4, 4) \
        else x_to_world(x2)
    return np.linalg.solve(t2, t1)


def get_pairwise_transformation(poses: np.ndarray, max_cav: int, n_valid: int,
                                proj_first: bool = False) -> np.ndarray:
    """(L, L, 4, 4) pairwise transforms; [i, j] maps agent-i coords into
    agent-j's frame. Identity for padded slots and when proj_first."""
    pairwise = np.tile(np.eye(4), (max_cav, max_cav, 1, 1))
    if proj_first:
        return pairwise
    t_list = [x_to_world(poses[i]) for i in range(n_valid)]
    for i in range(n_valid):
        for j in range(n_valid):
            if i != j:
                pairwise[i, j] = np.linalg.solve(t_list[j], t_list[i])
    return pairwise


def normalize_pairwise_tfm(pairwise_t_matrix: torch.Tensor, H: float,
                           W: float, discrete_ratio: float,
                           downsample_rate: float = 1.0) -> torch.Tensor:
    """(..., 4, 4) metric transforms -> (..., 2, 3) normalized affines for
    the BEV feature warp (``F.affine_grid`` convention)."""
    p = pairwise_t_matrix
    a00 = p[..., 0, 0]
    a01 = p[..., 0, 1] * H / W
    a10 = p[..., 1, 0] * W / H
    a11 = p[..., 1, 1]
    a02 = p[..., 0, 3] / (downsample_rate * discrete_ratio * W) * 2
    a12 = p[..., 1, 3] / (downsample_rate * discrete_ratio * H) * 2
    row0 = torch.stack([a00, a01, a02], dim=-1)
    row1 = torch.stack([a10, a11, a12], dim=-1)
    return torch.stack([row0, row1], dim=-2)
