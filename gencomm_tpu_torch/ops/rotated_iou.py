"""Rotated-box (convex quad) IoU with static shapes.

Counterpart of ``gencomm_tpu/ops/rotated_iou.py`` (``quad_iou_pairwise`` and
its helpers): the intersection area of two CCW convex quads is the
Green's-theorem sum of each quad's edges clipped to the other
(Liang-Barsky), with no sort and no compaction.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _ccw(q: torch.Tensor) -> torch.Tensor:
    """Canonicalize quads (..., 4, 2) to CCW winding."""
    nxt = torch.roll(q, -1, dims=-2)
    signed = (q[..., 0] * nxt[..., 1] - q[..., 1] * nxt[..., 0]).sum(-1)
    return torch.where(signed[..., None, None] >= 0, q, q.flip(-2))


def _clipped_edge_contribution(poly, clip, strict: bool = False):
    """Sum over ``poly``'s edges, clipped to ``clip``, of cross(a, b)."""
    p0 = poly[..., :, None, :]
    p1 = torch.roll(poly, -1, dims=-2)[..., :, None, :]
    v0 = clip[..., None, :, :]
    d = (torch.roll(clip, -1, dims=-2) - clip)[..., None, :, :]

    dn = torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)
    dn = torch.where(dn > _EPS, dn, torch.ones_like(dn))
    f0 = (d[..., 0] * (p0[..., 1] - v0[..., 1])
          - d[..., 1] * (p0[..., 0] - v0[..., 0])) / dn
    f1 = (d[..., 0] * (p1[..., 1] - v0[..., 1])
          - d[..., 1] * (p1[..., 0] - v0[..., 0])) / dn
    df = f1 - f0
    eps = 1e-5  # meters
    t_cross = -f0 / torch.where(df.abs() > eps, df, torch.ones_like(df))

    zero, one = torch.zeros_like(t_cross), torch.ones_like(t_cross)
    lower = torch.where(df > eps, t_cross, zero)
    upper = torch.where(df < -eps, t_cross, one)
    thresh = eps if strict else -eps
    infeasible = (df.abs() <= eps) & (f0 < thresh)
    lower = torch.where(infeasible, 2.0 * one, lower)

    t_lo = lower.amax(-1).clamp(0.0, 1.0)
    t_hi = upper.amin(-1).clamp(0.0, 1.0)
    ok = (t_hi > t_lo).to(poly.dtype)

    e0 = poly
    e1 = torch.roll(poly, -1, dims=-2)
    a = e0 + t_lo[..., None] * (e1 - e0)
    b = e0 + t_hi[..., None] * (e1 - e0)
    cross = a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    return (cross * ok).sum(-1)


def quad_intersection_area(qa, qb):
    """Intersection area of convex quads (..., 4, 2) -> (...,)."""
    qa, qb = _ccw(qa), _ccw(qb)
    total = (_clipped_edge_contribution(qa, qb, strict=False)
             + _clipped_edge_contribution(qb, qa, strict=True))
    return (0.5 * total).clamp_min(0.0)


def quad_area(q):
    """Shoelace area of quads (..., 4, 2) -> (...,)."""
    nxt = torch.roll(q, -1, dims=-2)
    return 0.5 * (q[..., 0] * nxt[..., 1] - q[..., 1] * nxt[..., 0]).sum(-1).abs()


def quad_iou_pairwise(qa, qb, row_chunk: int = 128):
    """Pairwise IoU between quads qa (N, 4, 2) and qb (M, 4, 2) -> (N, M),
    computed ``row_chunk`` rows at a time to bound the intermediates."""
    n, m = qa.shape[0], qb.shape[0]
    area_a, area_b = quad_area(qa), quad_area(qb)
    inter = torch.cat([
        quad_intersection_area(qa[i:i + row_chunk, None], qb[None, :])
        for i in range(0, n, row_chunk)
    ]) if n else qa.new_zeros((0, m))
    union = area_a[:, None] + area_b[None, :] - inter
    safe = torch.where(union > _EPS, union, torch.ones_like(union))
    return torch.where(union > _EPS, inter / safe, torch.zeros_like(union))
