"""Rotated NMS with static shapes.

Counterpart of ``gencomm_tpu/ops/nms.py``: one K x K rotated IoU matrix,
then the exact greedy keep-set as a round-parallel closure.
"""

from __future__ import annotations

import torch

from gencomm_tpu_torch.ops.rotated_iou import quad_iou_pairwise


def rotated_nms(corners, scores, valid, iou_thresh: float):
    """corners (K, 4, 2) BEV quads, scores (K,), valid (K,) bool ->
    (order, keep): the score-descending permutation (stable, as
    ``jnp.argsort``) and a keep mask aligned with it."""
    k = scores.shape[0]
    s = torch.where(valid, scores,
                    torch.full_like(scores, torch.finfo(scores.dtype).min))
    order = torch.argsort(-s, stable=True)
    q = corners[order]
    v = valid[order]
    iou = quad_iou_pairwise(q, q)
    idx = torch.arange(k, device=scores.device)
    # overlap[j, i]: higher-scored j would suppress i
    overlap = (iou > iou_thresh) & (idx[:, None] < idx[None, :])

    # Each round keeps every undecided box that no kept box and no
    # higher-scored undecided box overlaps; rounds = suppression-chain
    # depth. Same keep-set as sequential greedy NMS.
    kept = torch.zeros(k, dtype=torch.bool, device=scores.device)
    und = v.clone()
    while bool(und.any()):
        und &= ~(overlap & kept[:, None]).any(0)
        newkeep = und & ~(overlap & und[:, None]).any(0)
        kept |= newkeep
        und &= ~newkeep
    return order, kept
