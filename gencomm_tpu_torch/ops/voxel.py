"""Points -> pillar ids, decorated points and the BEV canvas, on the device.

Counterpart of ``gencomm_tpu/ops/voxel.py``: a point carries the flat id of
its pillar (``iy * nx + ix``; ``nx * ny`` is the dump slot of a point out of
range or masked), per-pillar sums come from a segment sum and the encoded
point features are max-reduced onto the dense ``(ny, nx, C)`` canvas. This
is the raw-point path of the PointPillars encoder (no host decoration) and
of VoxelNet's voxel max.

A point is kept for ``pc_range[2] <= z <= pc_range[5]``: a point at exactly
z == z_max is in range, as in the JAX package's raw path (the numpy host
decorator drops it, ROADMAP fault d). Indices are ``floor((x - r0) / v)``
by true division (``ops/sparse.py:voxel_index``).

The segment sums are ``ops/sparse.py:segment_sum_sorted``: each segment
summed sequentially in point order, the same bits on every run. The segment
max is ``torch.scatter_reduce`` ("amax", from -inf) in the features' own
dtype: the raw path's rows are fp32 PFN outputs in the JAX
package, and kernel K2 takes bf16 rows sorted by pillar, so the raw path
keeps JAX's fp32 canvas and computes the max in plain PyTorch. A max is
exact whatever the order, and its gradient goes in equal shares to the rows
that tie with the cell's max, as JAX's scatter-max VJP shares it.
"""

from __future__ import annotations

import torch

from gencomm_tpu_torch.ops.sparse import segment_sum_sorted, voxel_index


def pillar_ids(points, point_mask, pc_range, voxel_size, nx: int, ny: int):
    """points (..., P, D >= 3), point_mask (..., P) bool -> (ids, valid):
    ids in [0, nx * ny], nx * ny for an invalid or out-of-range point."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    ix = voxel_index(x, pc_range[0], voxel_size[0])
    iy = voxel_index(y, pc_range[1], voxel_size[1])
    inb = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
           & (z >= pc_range[2]) & (z <= pc_range[5]))
    valid = inb & point_mask.bool()
    ids = torch.where(valid, iy * nx + ix, torch.full_like(ix, nx * ny))
    return ids, valid


def _centers(cell, points, pc_range, voxel_size, nx: int):
    """Pillar centres (N, 3) of flat cells ``cell`` within one agent."""
    ix = (cell % nx).to(points.dtype)
    iy = torch.div(cell, nx, rounding_mode="floor").to(points.dtype)
    cx = ix * voxel_size[0] + voxel_size[0] / 2 + pc_range[0]
    cy = iy * voxel_size[1] + voxel_size[1] / 2 + pc_range[1]
    cz = torch.full_like(cx, voxel_size[2] / 2 + pc_range[2])
    return torch.stack([cx, cy, cz], dim=-1)


def pillar_decorate(points, ids, valid, pc_range, voxel_size, nx: int,
                    ny: int):
    """One agent's 10-dim pillar features (PillarVFE's input): points
    (P, 4), ids (P,), valid (P,) -> (P, 10) [xyzi, xyz - pillar mean,
    xyz - pillar centre], zero for invalid points."""
    ncell = nx * ny
    xyz = points[:, :3]
    vf = valid[:, None].to(points.dtype)
    seg = ids.long()
    sums = segment_sum_sorted(xyz * vf, seg, ncell + 1)
    cnts = segment_sum_sorted(vf, seg, ncell + 1)
    mean = sums / cnts.clamp_min(1.0)
    f_cluster = xyz - mean[seg]
    cell = torch.where(seg < ncell, seg, seg % nx + (ny - 1) * nx)
    f_center = xyz - _centers(cell, points, pc_range, voxel_size, nx)
    return torch.cat([points, f_cluster, f_center], dim=-1) * vf


def segment_max(point_feats, seg, valid, num_segments: int):
    """(num_segments, C) max of the valid rows by segment; a segment
    without a valid row is 0. Invalid rows are routed to an extra dump
    segment. The max starts from -inf, which no row ties with, so a row
    alone at the max takes its whole cotangent."""
    c = point_feats.shape[-1]
    idx = torch.where(valid, seg, torch.full_like(seg, num_segments))
    out = point_feats.new_full((num_segments + 1, c), float("-inf"))
    out = out.scatter_reduce(0, idx[:, None].expand(-1, c), point_feats,
                             "amax", include_self=True)[:num_segments]
    return torch.where(torch.isneginf(out), torch.zeros_like(out), out)


def scatter_pillar_max(point_feats, ids, valid, nx: int, ny: int):
    """One agent's canvas (ny, nx, C): each pillar the max of its valid
    points' features, empty pillars 0."""
    out = segment_max(point_feats, ids.long(), valid, nx * ny)
    return out.reshape(ny, nx, point_feats.shape[-1])


def pillar_decorate_flat(points, point_mask, pc_range, voxel_size, nx: int,
                         ny: int):
    """All agents at once: points (A, P, 4), point_mask (A, P) -> (feats
    (A * P, 10), gids (A * P,) in the global id space [0, A * ncell]
    (A * ncell the shared dump slot), valid (A * P,), counts (A * ncell
    + 1,) points a pillar)."""
    a, p, d = points.shape
    ncell = nx * ny
    ids, valid = pillar_ids(points, point_mask, pc_range, voxel_size, nx, ny)
    agent = torch.arange(a, dtype=torch.int32, device=points.device)[:, None]
    gids = torch.where(valid, agent * ncell + ids.clamp_max(ncell - 1),
                       torch.full_like(ids, a * ncell)).reshape(a * p)
    flat = points.reshape(a * p, d)
    valid_f = valid.reshape(a * p)
    xyz = flat[:, :3]
    vf = valid_f[:, None].to(points.dtype)
    seg = gids.long()
    # sums and counts in one segment sum (xyz | 1)
    sums4 = segment_sum_sorted(torch.cat([xyz, torch.ones_like(vf)], -1) * vf,
                               seg, a * ncell + 1)
    sums, cnts = sums4[:, :3], sums4[:, 3:4]
    mean = sums / cnts.clamp_min(1.0)
    f_cluster = xyz - mean[seg]
    f_center = xyz - _centers(seg % ncell, flat, pc_range, voxel_size, nx)
    feats = torch.cat([flat, f_cluster, f_center], dim=-1) * vf
    return feats, gids, valid_f, cnts[:, 0]


def scatter_pillar_max_flat(point_feats, gids, valid, n_agents: int, nx: int,
                            ny: int):
    """The flat ids' canvases (A, ny, nx, C): each pillar the max of its
    valid points' features, empty pillars 0."""
    ncell = nx * ny
    out = segment_max(point_feats, gids.long(), valid, n_agents * ncell)
    return out.reshape(n_agents, ny, nx, point_feats.shape[-1])


def cap_points_per_pillar(points, ids, valid, nx: int, ny: int,
                          max_points: int = 32):
    """``valid`` without the points past rank ``max_points`` in their
    pillar, the rank being the position among the pillar's points in array
    order (the reference keeps a voxel's first 32 points). ``points``,
    ``nx`` and ``ny`` are accepted as the JAX signature has them."""
    n = ids.shape[0]
    sorted_ids, order = torch.sort(ids, stable=True)
    same_as_prev = torch.cat([sorted_ids.new_zeros(1, dtype=torch.bool),
                              sorted_ids[1:] == sorted_ids[:-1]])
    idx = torch.arange(n, device=ids.device)
    run_start = torch.cummax(torch.where(same_as_prev, 0, idx), 0).values
    rank = torch.empty_like(idx).scatter_(0, order, idx - run_start)
    return valid & (rank < max_points)
