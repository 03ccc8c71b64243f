"""Host-side pillar decoration of a batch.

Counterpart of ``gencomm_tpu/data/decorate.py:host_decorate_pillars``
without the stripe-padded layout: ``points_<m> (B, L, P, 4)`` becomes
``decorated_<m> (B, L, P, 10)``, ``gids_<m> (B, L, P)`` sorted within each
agent, and ``dvalid_<m> (B, L, P)``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from gencomm_tpu_torch.native import PillarVoxelizer


def decorate_modality(batch: Dict[str, np.ndarray], voxelizer: PillarVoxelizer,
                      mname: str = "m1") -> Dict[str, np.ndarray]:
    """Replace ``points_<mname>`` (and its point mask) by the decorated
    fields. Padded points (mask False) are pushed below the z range so they
    do not reach the pillar statistics."""
    out = dict(batch)
    pts = np.asarray(out.pop(f"points_{mname}"))[..., :4].astype(np.float32)
    mask = out.pop(f"point_mask_{mname}", None)
    if mask is not None and not np.asarray(mask).all():
        pts = pts.copy()
        pts[~np.asarray(mask, bool)] = np.array([0.0, 0.0, -1e4, 0.0],
                                                np.float32)
    b, l, p, _ = pts.shape
    feats, gids, valid = voxelizer.decorate_batch(pts.reshape(b * l, p, 4))
    out[f"decorated_{mname}"] = feats.reshape(b, l, p, 10)
    out[f"gids_{mname}"] = gids.reshape(b, l, p)
    out[f"dvalid_{mname}"] = valid.reshape(b, l, p)
    return out


class HostDecoration:
    """``host_decorate_pillars`` of the JAX package (``data/decorate.py``)
    for a hypes dict: called on a batch, it decorates every point_pillar
    modality of ``model.args`` whose raw points the batch holds (with its
    encoder's ``voxel_size`` and ``lidar_range``) and passes the rest
    through. The voxelizers are built at first use in each process, so an
    instance can be sent to a worker process."""

    def __init__(self, hypes: dict):
        margs = hypes.get("model", {}).get("args", {})
        self.grids = {
            m: (tuple(c["encoder_args"]["lidar_range"]),
                tuple(c["encoder_args"]["voxel_size"]))
            for m, c in margs.items()
            if isinstance(c, dict) and c.get("core_method", "") == "point_pillar"
            and "voxel_size" in c.get("encoder_args", {})
            and "lidar_range" in c.get("encoder_args", {})}
        self._voxelizers: Dict[str, PillarVoxelizer] = {}

    def __getstate__(self):
        return {"grids": self.grids, "_voxelizers": {}}

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        for m, (lidar_range, voxel_size) in self.grids.items():
            if f"points_{m}" not in batch or f"decorated_{m}" in batch:
                continue
            if m not in self._voxelizers:
                self._voxelizers[m] = PillarVoxelizer(lidar_range, voxel_size)
            batch = decorate_modality(batch, self._voxelizers[m], m)
        return batch
