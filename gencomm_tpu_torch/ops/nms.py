"""Rotated NMS with static shapes: kernel N1 and its plain version.

Counterpart of ``gencomm_tpu/ops/nms.py``: one K x K rotated IoU matrix in
PyTorch, then the exact greedy keep-set. On the device the keep-set is one
launch of ``csrc/nms_closure.cu`` (N1, the counterpart of the JAX package's
``lax.while_loop``; a cooperative launch) for K up to 262,112 (on the
card's tests up to 25,000), which reads nothing back to the host, so a
CUDA graph can capture it; its plain version, the round-parallel closure
in Python, reads a flag on the host every round and serves CPU tensors.
"""

from __future__ import annotations

import torch

from gencomm_tpu_torch.ops import _cuda
from gencomm_tpu_torch.ops.rotated_iou import quad_iou_pairwise

# csrc/nms_closure.cu: the size up to which the packed columns (64 W
# (W + 1) bytes, W = ceil(K / 32)) are copied into the walking block's
# shared memory (route "smem", else "l2")
TRIANGLE_SMEM_BYTES = 210 * 1024


def _words(k: int) -> int:
    return -(-k // 32)


def storage_route(k: int) -> str:
    """Where N1's decider reads the packed columns of ``k`` boxes: "smem"
    while they fit in shared memory (K <= 1,824), else "l2"."""
    w = _words(k)
    return "smem" if 64 * w * (w + 1) <= TRIANGLE_SMEM_BYTES else "l2"


def scratch_words(k: int) -> int:
    """uint32 words of global scratch N1 needs for ``k`` boxes: the packed
    upper triangle twice, as rows and as columns (for each 32-box word u,
    32 (W - u) words each), which the packing pass writes on either
    route."""
    w = _words(k)
    return 32 * w * (w + 1)


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
    (one kernel launch) for a CUDA tensor, K up to 262,112."""
    if not overlap.is_cuda:
        return nms_closure_plain(overlap, valid)
    k = valid.shape[0]
    _cuda.check_cuda_tensor(overlap, "overlap", torch.bool, (k, k))
    _cuda.check_cuda_tensor(valid, "valid", torch.bool, (k,))
    if scratch_words(k) >= 2 ** 31:
        # the kernel's refusal: K above 262,112 (a 68.7 GB overlap matrix)
        raise ValueError(f"the NMS kernel takes K with 32 W (W + 1) < 2^31 "
                         f"(W = ceil(K / 32)), K <= 262,112; got {k}")
    keep = torch.empty(k, dtype=torch.bool, device=valid.device)
    if k == 0:
        return keep
    scratch = torch.empty(scratch_words(k), dtype=torch.int32,
                          device=valid.device)
    _cuda.launch("nms_closure", overlap.data_ptr(), valid.data_ptr(),
                 keep.data_ptr(), scratch.data_ptr(), k)
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
