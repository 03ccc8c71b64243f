"""Pillar segment-max canvas: kernels K2 (forward) and K2b (backward) and
their plain versions.

Counterpart of ``gencomm_tpu/ops/pillar_pallas.py`` (forward) and of the
VJP that JAX derives for the training canvas, ``.at[].max`` on a zero bf16
canvas (``gencomm_tpu/models/encoders/point_pillar.py:188-189``, through
``jax._src.lax.slicing._scatter_extremal_jvp``). The port does not use the
stripe-padded row layout of the TPU kernel: rows arrive sorted by gid
within each agent (the host decorator's order), so a segmented max over
runs writes each canvas cell once (``csrc/pillar_canvas.cu``).

The backward (``csrc/pillar_canvas_bwd.cu``) is bound by bytes: the rows
read once, their gradient written once, and each occupied cell's max and
cotangent. It has two routes, chosen here from the channel count
(``backward_route``): ``"rows64"`` for 64 channels (every model of the
repo), where a warp reads its 32 rows once as 16-byte loads, finds the runs
by warp votes and counts ties with bit masks, and ``"general"`` for any
other even count, the first version's kernel.

The backward gives each row that ties with its cell's max an equal share
of the cell's cotangent, rounded as JAX rounds it in bf16: the share is
bf16(1 / n), with n the number of tied rows, plus one when the max equals
the zero canvas init; n is counted in bf16, where it stops at 256. The
product g * share is rounded to bf16. Rows below the max get 0.
"""

from __future__ import annotations

import torch

from gencomm_tpu_torch.ops import _cuda

_CHUNK = 32  # rows per warp in csrc/pillar_canvas_bwd.cu
ROUTES = {"general": 0, "rows64": 1}  # the `route` argument of the C entry
# K2b's launches by route, counted where the wrapper launches
ROUTE_LAUNCHES = {"general": 0, "rows64": 0}
_BF16_COUNT_LIMIT = 256.0  # 256 + 1 rounds back to 256 in bf16


def _flat_cells(m: int, gids: torch.Tensor, n_agents: int, ncell: int):
    agent = torch.arange(m, device=gids.device) // (m // n_agents)
    return agent * ncell + gids.long().clamp(0, ncell - 1)


def pillar_canvas_plain(rows: torch.Tensor, gids: torch.Tensor,
                        n_agents: int, ncell: int) -> torch.Tensor:
    """rows (A*P, C) >= 0, gids (A*P,) within-agent cell ids (clamped to
    [0, ncell-1]) -> canvas (A, ncell, C) of rows' dtype; empty cells 0."""
    m, c = rows.shape
    flat = _flat_cells(m, gids, n_agents, ncell)
    canvas = torch.zeros(n_agents * ncell, c, dtype=rows.dtype,
                         device=rows.device)
    canvas.scatter_reduce_(0, flat[:, None].expand(m, c), rows, "amax",
                           include_self=True)
    return canvas.view(n_agents, ncell, c)


def pillar_canvas_bwd_plain(rows: torch.Tensor, gids: torch.Tensor,
                            canvas: torch.Tensor, gout: torch.Tensor,
                            n_agents: int, ncell: int) -> torch.Tensor:
    """Row cotangents (A*P, C) of rows' dtype from the forward's canvas and
    its cotangent gout (A, ncell, C)."""
    m, c = rows.shape
    flat = _flat_cells(m, gids, n_agents, ncell)
    target = canvas.reshape(-1, c)[flat]
    tied = rows == target
    counts = torch.zeros(n_agents * ncell, c, dtype=torch.float32,
                         device=rows.device)
    counts.index_add_(0, flat, tied.to(torch.float32))
    den = (counts[flat] + (target == 0).to(torch.float32)).clamp_max(
        _BF16_COUNT_LIMIT)
    share = (1.0 / den).to(rows.dtype).to(torch.float32)
    coef = torch.where(tied, share, torch.zeros_like(share))
    # g * 0 keeps g's sign, as JAX's product does for rows below the max
    return (gout.reshape(-1, c)[flat].to(torch.float32) * coef).to(rows.dtype)


def _check_rows(rows, gids, n_agents):
    m, c = rows.shape
    _cuda.check_cuda_tensor(rows, "rows", torch.bfloat16)
    _cuda.check_cuda_tensor(gids, "gids", torch.int32, (m,))
    if c % 2:
        raise ValueError(f"the canvas kernels need an even channel count, "
                         f"got {c}")
    return m, c


def backward_route(channels: int, m: int = 0, cells: int = 0) -> str:
    """The route K2b takes for this channel count, ``m`` rows and ``cells``
    canvas cells over all agents: ``rows64`` indexes both by int32."""
    fits = max(m, cells) < 2 ** 31
    return "rows64" if channels == 64 and fits else "general"


def backward_scratch(route: str, m: int, channels: int) -> int:
    """Ints of scratch K2b needs for ``m`` rows: ``channels`` tie counters
    for every chunk of 32 rows (a run longer than its chunks is counted in
    the slot of the chunk that holds its head) and, on route ``rows64``,
    two ints a chunk that mark it for the second launch."""
    chunks = -(-m // _CHUNK)
    return chunks * (channels + (2 if route == "rows64" else 0))


def pillar_canvas_fwd(rows: torch.Tensor, gids: torch.Tensor, n_agents: int,
                      ncell: int) -> torch.Tensor:
    """The forward of ``pillar_canvas`` without autograd: the plain version
    for a CPU tensor, kernel K2 for a CUDA tensor."""
    if not rows.is_cuda:
        return pillar_canvas_plain(rows, gids, n_agents, ncell)
    m, c = _check_rows(rows, gids, n_agents)
    out = torch.empty(n_agents, ncell, c, dtype=torch.bfloat16,
                      device=rows.device)
    _cuda.launch("pillar_canvas", rows.data_ptr(), gids.data_ptr(),
                 out.data_ptr(), m, m // n_agents, n_agents, ncell, c)
    _cuda.LAUNCHES["pillar_canvas"] += 1
    return out


def pillar_canvas_bwd(rows: torch.Tensor, gids: torch.Tensor,
                      canvas: torch.Tensor, gout: torch.Tensor,
                      n_agents: int, ncell: int) -> torch.Tensor:
    """Row cotangents: the plain version for a CPU tensor, kernel K2b for a
    CUDA tensor."""
    if not rows.is_cuda:
        return pillar_canvas_bwd_plain(rows, gids, canvas, gout, n_agents,
                                       ncell)
    m, c = _check_rows(rows, gids, n_agents)
    _cuda.check_cuda_tensor(canvas, "canvas", torch.bfloat16,
                            (n_agents, ncell, c))
    _cuda.check_cuda_tensor(gout, "gout", torch.bfloat16,
                            (n_agents, ncell, c))
    route = backward_route(c, m, n_agents * ncell)
    drows = torch.empty_like(rows)
    scratch = torch.empty(backward_scratch(route, m, c), dtype=torch.int32,
                          device=rows.device)
    _cuda.launch("pillar_canvas_bwd", rows.data_ptr(), gids.data_ptr(),
                 canvas.data_ptr(), gout.data_ptr(), drows.data_ptr(),
                 scratch.data_ptr(), m, m // n_agents, ncell, c, ROUTES[route])
    _cuda.LAUNCHES["pillar_canvas_bwd"] += 1
    ROUTE_LAUNCHES[route] += 1
    return drows


class _PillarCanvas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, gids, n_agents, ncell):
        canvas = pillar_canvas_fwd(rows, gids, n_agents, ncell)
        ctx.save_for_backward(rows, gids, canvas)
        ctx.n_agents, ctx.ncell = n_agents, ncell
        return canvas

    @staticmethod
    def backward(ctx, gout):
        rows, gids, canvas = ctx.saved_tensors
        drows = pillar_canvas_bwd(rows, gids, canvas, gout.contiguous(),
                                  ctx.n_agents, ctx.ncell)
        return drows, None, None, None


def pillar_canvas(rows: torch.Tensor, gids: torch.Tensor, n_agents: int,
                  ncell: int) -> torch.Tensor:
    """Per-agent BEV canvas ``(A, ncell, C)`` bf16: each cell is the max of
    the rows with that gid, empty cells exactly 0.

    rows: (A*P, C) bf16, values >= 0 (post-ReLU, invalid rows zeroed);
    gids: (A*P,) int32, sorted within each agent (ids >= ncell are clamped
    to ncell-1, which keeps them sorted). A CPU tensor takes the plain
    versions; a CUDA tensor launches K2 and, in the backward, K2b.
    """
    m = rows.shape[0]
    if m % n_agents:
        raise ValueError(f"{m} rows do not split over {n_agents} agents")
    return _PillarCanvas.apply(rows, gids, n_agents, ncell)
