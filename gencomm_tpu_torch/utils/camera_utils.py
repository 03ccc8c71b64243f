"""Camera / LSS geometry helpers (numpy).

Counterpart of ``gencomm_tpu/utils/camera_utils.py`` (``gen_dx_bx``,
``depth_discretization``), copied. The visibility filter of the real camera
loader is not ported yet.
"""

from __future__ import annotations

import numpy as np


def gen_dx_bx(xbound, ybound, zbound):
    """Returns (dx, bx, nx): cell sizes, first-cell centers, cell counts."""
    dx = np.array([row[2] for row in (xbound, ybound, zbound)], np.float32)
    bx = np.array(
        [row[0] + row[2] / 2.0 for row in (xbound, ybound, zbound)], np.float32
    )
    nx = np.array(
        [int((row[1] - row[0]) / row[2]) for row in (xbound, ybound, zbound)],
        np.int32,
    )
    return dx, bx, nx


def depth_discretization(depth_min, depth_max, num_bins, mode: str):
    """Depth bin centers: uniform (UD) or linearly-increasing (LID)."""
    if mode == "UD":
        bin_size = (depth_max - depth_min) / num_bins
        return depth_min + bin_size * np.arange(num_bins)
    if mode == "LID":
        bin_size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
        return depth_min + bin_size * (
            np.arange(num_bins) * np.arange(1, 1 + num_bins)
        ) / 2
    raise NotImplementedError(mode)
