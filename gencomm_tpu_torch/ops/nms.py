"""Rotated NMS with static shapes: kernel N1 and its plain version.

Counterpart of ``gencomm_tpu/ops/nms.py``: one K x K rotated IoU matrix in
PyTorch, then the exact greedy keep-set. On the device the keep-set is one
launch of ``csrc/nms_closure.cu`` (N1, the counterpart of the JAX package's
``lax.while_loop``), which reads nothing back to the host, so a CUDA graph
can capture it; its plain version, the round-parallel closure in Python,
reads a flag on the host every round and serves CPU tensors.
"""

from __future__ import annotations

import torch

from gencomm_tpu_torch.ops import _cuda
from gencomm_tpu_torch.ops.rotated_iou import quad_iou_pairwise

# csrc/nms_closure.cu: MAX_K (four bit words a lane of one warp) and the
# size up to which the packed K x ceil(K / 32) words stay in shared memory
NMS_MAX_K = 4096
SMEM_MASK_BYTES = 200 * 1024


def scratch_words(k: int) -> int:
    """uint32 words of global scratch N1 needs for ``k`` boxes: none while
    the packed rows fit in shared memory."""
    words = k * (-(-k // 32))
    return words if 4 * words > SMEM_MASK_BYTES else 0


def nms_closure_plain(overlap: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """overlap (K, K) bool (``overlap[j, i]``: the higher-scored j would
    suppress i), valid (K,) bool, both in score order -> keep (K,) bool.

    Each round keeps every undecided box that no kept box and no
    higher-scored undecided box overlaps; rounds = suppression-chain depth.
    Same keep-set as sequential greedy NMS."""
    k = valid.shape[0]
    kept = torch.zeros(k, dtype=torch.bool, device=valid.device)
    und = valid.clone()
    while bool(und.any()):
        und &= ~(overlap & kept[:, None]).any(0)
        newkeep = und & ~(overlap & und[:, None]).any(0)
        kept |= newkeep
        und &= ~newkeep
    return kept


def nms_closure(overlap: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The greedy keep mask: the plain version for a CPU tensor, kernel N1
    for a CUDA tensor (at most ``NMS_MAX_K`` boxes)."""
    if not overlap.is_cuda:
        return nms_closure_plain(overlap, valid)
    k = valid.shape[0]
    if k > NMS_MAX_K:
        raise ValueError(f"the NMS kernel takes at most {NMS_MAX_K} boxes, "
                         f"got {k}")
    _cuda.check_cuda_tensor(overlap, "overlap", torch.bool, (k, k))
    _cuda.check_cuda_tensor(valid, "valid", torch.bool, (k,))
    keep = torch.empty(k, dtype=torch.bool, device=valid.device)
    if k == 0:
        return keep
    n_scratch = scratch_words(k)
    scratch = (torch.empty(n_scratch, dtype=torch.int32, device=valid.device)
               if n_scratch else None)
    _cuda.launch("nms_closure", overlap.data_ptr(), valid.data_ptr(),
                 keep.data_ptr(),
                 scratch.data_ptr() if scratch is not None else None, k)
    _cuda.LAUNCHES["nms_closure"] += 1
    return keep


def overlap_matrix(q: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """(K, K) bool from score-sorted quads (K, 4, 2): ``[j, i]`` is true
    where j < i and their rotated IoU exceeds ``iou_thresh``."""
    iou = quad_iou_pairwise(q, q)
    idx = torch.arange(q.shape[0], device=q.device)
    return (iou > iou_thresh) & (idx[:, None] < idx[None, :])


def rotated_nms(corners, scores, valid, iou_thresh: float):
    """corners (K, 4, 2) BEV quads, scores (K,), valid (K,) bool ->
    (order, keep): the score-descending permutation (stable, as
    ``jnp.argsort``) and a keep mask aligned with it."""
    s = torch.where(valid, scores,
                    torch.full_like(scores, torch.finfo(scores.dtype).min))
    order = torch.argsort(-s, stable=True)
    return order, nms_closure(overlap_matrix(corners[order], iou_thresh),
                              valid[order])
