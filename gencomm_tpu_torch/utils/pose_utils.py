"""Pose-error injection for the robustness evaluation.

Counterpart of ``gencomm_tpu/utils/pose_utils.py`` (numpy, host side):
Gaussian or Laplace noise on x, y and yaw of an agent's lidar pose, a
von-Mises variant for a batch of poses, the z-axis removal of a transform,
and the ``noise_setting`` gate of the hypes. The same ``RandomState`` gives
the same draws as the JAX package.
"""

from __future__ import annotations

import numpy as np


def generate_noise(pos_std: float, rot_std: float, pos_mean: float = 0.0,
                   rot_mean: float = 0.0,
                   rng: np.random.RandomState | None = None) -> np.ndarray:
    """(6,) additive pose noise: x, y (m) and yaw (deg), Gaussian."""
    rng = rng or np.random
    xy = rng.normal(pos_mean, pos_std, 2)
    yaw = rng.normal(rot_mean, rot_std)
    return np.array([xy[0], xy[1], 0.0, 0.0, yaw, 0.0])


def generate_noise_laplace(pos_b: float, rot_b: float,
                           rng: np.random.RandomState | None = None
                           ) -> np.ndarray:
    """(6,) additive pose noise with Laplace-distributed x, y and yaw."""
    rng = rng or np.random
    xy = rng.laplace(0.0, pos_b, 2)
    yaw = rng.laplace(0.0, rot_b)
    return np.array([xy[0], xy[1], 0.0, 0.0, yaw, 0.0])


def generate_noise_von_mises(poses: np.ndarray, pos_std: float,
                             rot_std: float, pos_mean: float = 0.0,
                             rot_mean: float = 0.0,
                             rng: np.random.RandomState | None = None
                             ) -> np.ndarray:
    """(N, 6) additive noise for N poses: Gaussian x, y (m) and a von-Mises
    yaw (rad) of concentration (180 / (pi std))^2, std in degrees."""
    rng = rng or np.random
    n = poses.shape[0]
    noise = np.zeros_like(poses)
    if pos_std > 0:
        noise[:, :2] = rng.normal(pos_mean, pos_std, (n, 2))
    if rot_std > 0:
        concentration = (180.0 / (np.pi * rot_std)) ** 2
        noise[:, 4] = rng.vonmises(rot_mean, concentration, n)
    return noise


def remove_z_axis(T: np.ndarray) -> np.ndarray:
    """Zeroes the z translation and the rotation about x and y of a 4 x 4
    transform, in place; returns it."""
    T[2, 3] = 0.0
    T[0, 2] = 0.0
    T[1, 2] = 0.0
    T[2, 0] = 0.0
    T[2, 1] = 0.0
    T[2, 2] = 1.0
    return T


def pose_noise_enabled(noise_setting: dict | None) -> bool:
    """Pose noise is on when the hypes' ``noise_setting`` has both
    ``add_noise`` and ``add_pose_noise`` true (the inference CLI's
    ``--pos_std`` / ``--rot_std`` write both)."""
    ns = noise_setting or {}
    return bool(ns.get("add_noise", False)) and bool(
        "add_pose_noise" in ns and ns["add_pose_noise"])


def add_noise_to_poses(poses: np.ndarray, noise_setting: dict | None,
                       rng: np.random.RandomState | None = None
                       ) -> np.ndarray:
    """(N, 6) poses with every agent's pose perturbed (the ego's too) by
    ``noise_setting``'s ``args`` (``pos_std``, ``rot_std``, ``laplace``); a
    copy of ``poses`` when the gate is off."""
    if not pose_noise_enabled(noise_setting):
        return poses.copy()
    args = noise_setting.get("args", {})
    pos_std = args.get("pos_std", 0.0)
    rot_std = args.get("rot_std", 0.0)
    laplace = args.get("laplace", False)
    out = poses.copy()
    for i in range(out.shape[0]):
        if laplace:
            out[i] += generate_noise_laplace(pos_std, rot_std, rng)
        else:
            out[i] += generate_noise(pos_std, rot_std, rng=rng)
    return out
