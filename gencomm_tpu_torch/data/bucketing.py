"""Agent-slot bucketing: trim padded (B, L, ...) arrays to a bucket size.

Counterpart of ``gencomm_tpu/data/bucketing.py:trim_agent_slots``. The
padded layout holds ``max_cav`` agent slots; trimming to the smallest
bucket that holds every valid agent skips the empty slots' compute.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

AGENT_BUCKETS = (2, 3, 5)


def trim_agent_slots(batch: Dict[str, np.ndarray],
                     buckets: Sequence[int] = AGENT_BUCKETS,
                     max_cav: int | None = None) -> Dict[str, np.ndarray]:
    """Slice every agent-axis array (shape[1] == L) down to the smallest
    bucket holding all valid agents; the pairwise transform is sliced on
    both agent axes."""
    amask = np.asarray(batch["agent_mask"])
    b, l = amask.shape
    if max_cav is None:
        max_cav = l
    used = 0
    for i in range(b):
        idx = np.nonzero(amask[i])[0]
        if len(idx):
            used = max(used, int(idx[-1]) + 1)
    used = max(used, 1)
    target = next((k for k in sorted(buckets) if k >= used), max_cav)
    target = min(target, l)
    if target == l:
        return batch

    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        if a.ndim >= 2 and a.shape[0] == b and a.shape[1] == l:
            a = a[:, :target]
            if a.ndim >= 3 and a.shape[2] == l and k == "pairwise_t_matrix":
                a = a[:, :, :target]
            out[k] = a
        else:
            out[k] = v
    return out
