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
