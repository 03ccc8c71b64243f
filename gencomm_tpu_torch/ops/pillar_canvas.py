"""Pillar segment-max canvas: kernel K2 and its plain version.

Counterpart of ``gencomm_tpu/ops/pillar_pallas.py``. The port does not use
the stripe-padded row layout of the TPU kernel: rows arrive sorted by gid
within each agent (the host decorator's order), so a segmented max over
runs writes each canvas cell once (``csrc/pillar_canvas.cu``).
"""

from __future__ import annotations

import torch

from gencomm_tpu_torch.ops import _cuda


def pillar_canvas_plain(rows: torch.Tensor, gids: torch.Tensor,
                        n_agents: int, ncell: int) -> torch.Tensor:
    """rows (A*P, C) >= 0, gids (A*P,) within-agent cell ids (clamped to
    [0, ncell-1]) -> canvas (A, ncell, C) of rows' dtype; empty cells 0."""
    m, c = rows.shape
    agent = torch.arange(m, device=rows.device) // (m // n_agents)
    flat = agent * ncell + gids.long().clamp(0, ncell - 1)
    canvas = torch.zeros(n_agents * ncell, c, dtype=rows.dtype,
                         device=rows.device)
    canvas.scatter_reduce_(0, flat[:, None].expand(m, c), rows, "amax",
                           include_self=True)
    return canvas.view(n_agents, ncell, c)


def pillar_canvas(rows: torch.Tensor, gids: torch.Tensor, n_agents: int,
                  ncell: int) -> torch.Tensor:
    """Per-agent BEV canvas ``(A, ncell, C)`` bf16: each cell is the max of
    the rows with that gid, empty cells exactly 0.

    rows: (A*P, C) bf16, values >= 0 (post-ReLU, invalid rows zeroed);
    gids: (A*P,) int32, sorted within each agent (ids >= ncell are clamped
    to ncell-1, which keeps them sorted). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel.
    """
    m, c = rows.shape
    if m % n_agents:
        raise ValueError(f"{m} rows do not split over {n_agents} agents")
    if not rows.is_cuda:
        return pillar_canvas_plain(rows, gids, n_agents, ncell)
    _cuda.check_cuda_tensor(rows, "rows", torch.bfloat16)
    _cuda.check_cuda_tensor(gids, "gids", torch.int32, (m,))
    if c % 2:
        raise ValueError(f"the canvas kernel needs an even channel count, got {c}")
    out = torch.empty(n_agents, ncell, c, dtype=torch.bfloat16,
                      device=rows.device)
    _cuda.launch("pillar_canvas", rows.data_ptr(), gids.data_ptr(),
                 out.data_ptr(), m, m // n_agents, n_agents, ncell, c)
    _cuda.LAUNCHES["pillar_canvas"] += 1
    return out

