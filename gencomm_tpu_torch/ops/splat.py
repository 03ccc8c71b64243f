"""Top-K categorical-depth splat onto a flat BEV canvas: kernels K4 (forward)
and K4b (backward) and their plain versions.

Counterpart of ``gencomm_tpu/ops/splat_pallas.py`` (``splat_topk`` and its
VJP ``_splat_bwd``): ``canvas[c] = sum over (p, k) with ids[p, k] == c of
dvals[p, k] * feats[p]``, fp32; an id outside ``[0, num_cells)`` drops its
row. The port carries over neither the stripe padding nor the one-hot
matmul of the TPU kernel, nor a library sort: ``csrc/splat_topk.cu`` takes
the raw ids, sorts the rows by cell itself (a counting sort, since ids are
bounded by ``num_cells``, with each cell's rows put into ascending flat row,
the order of a stable sort: by rank counts in a short cell, by a block's
bitonic sort in a long one), stores zeros to the empty cells only, gathers
the feature rows, forms the products and sums each run of equal ids, so the
canvas is written once and no PyTorch call prepares indices. What bounds it
is the bytes of the canvas. The backward is a gather, one warp per pixel
(``csrc/splat_topk_bwd.cu``); it reads the unsorted ids.

``bf16_rows`` follows the kernel's contract in the JAX package: each product
row is rounded to bf16 and the sum stays fp32; the backward ignores the
rounding (straight-through). (The JAX ``segment_sum`` path with
``splat_bf16`` sums *in* bf16 instead, in an order XLA chooses; the port's
``splat_bf16`` is held against JAX run with ``splat_impl: pallas``.)

K4 sums every cell in one fixed order (ascending flat row ``p * K + k``, in
chunks of 32 sorted rows), so two runs give the same bits. The plain
version sums with ``index_add_``, whose order on a CUDA tensor varies from
run to run, so kernel and plain version agree to an fp32 sum-order
tolerance, not bit for bit.
"""

from __future__ import annotations

import torch

from gencomm_tpu_torch.ops import _cuda

_CHUNK = 32  # sorted rows per warp in csrc/splat_topk.cu
_SCAN_TILE = 1024  # counters per block of its scan
_BWD_MAX_CHANNELS = 128  # csrc/splat_topk_bwd.cu: one float4 per lane


def _valid(ids: torch.Tensor, num_cells: int) -> torch.Tensor:
    return (ids >= 0) & (ids < num_cells)


def splat_topk_plain(dvals: torch.Tensor, feats: torch.Tensor,
                     ids: torch.Tensor, num_cells: int,
                     bf16_rows: bool = False) -> torch.Tensor:
    """dvals (P, K) fp32, feats (P, C) fp32, ids (P, K) int -> canvas
    (num_cells, C) fp32, by ``index_add_`` of the materialised (P * K, C)
    rows; differentiable for dvals and feats (straight-through across the
    bf16 rounding)."""
    c = feats.shape[-1]
    rows = (dvals[..., None] * feats[:, None, :]).reshape(-1, c)
    if bf16_rows:
        rows = rows + (rows.to(torch.bfloat16).to(rows.dtype) - rows).detach()
    flat = torch.where(_valid(ids, num_cells), ids,
                       torch.full_like(ids, num_cells)).reshape(-1).long()
    canvas = torch.zeros(num_cells + 1, c, dtype=rows.dtype,
                         device=rows.device)
    return canvas.index_add(0, flat, rows)[:-1]


def splat_topk_bwd_plain(dvals: torch.Tensor, feats: torch.Tensor,
                         ids: torch.Tensor, gout: torch.Tensor,
                         num_cells: int):
    """(d_dvals (P, K), d_feats (P, C)) from the canvas cotangent gout
    (num_cells, C): the gather of the cotangent rows by cell id."""
    valid = _valid(ids, num_cells)
    grows = gout[torch.where(valid, ids, torch.zeros_like(ids)).long()]
    grows = torch.where(valid[..., None], grows, torch.zeros_like(grows))
    return (torch.einsum("pc,pkc->pk", feats, grows),
            torch.einsum("pk,pkc->pc", dvals, grows))


def _check(dvals, feats, ids, num_cells, max_channels=None):
    p, k = dvals.shape
    c = feats.shape[-1]
    _cuda.check_cuda_tensor(dvals, "dvals", torch.float32)
    _cuda.check_cuda_tensor(feats, "feats", torch.float32, (p, c))
    _cuda.check_cuda_tensor(ids, "ids", torch.int32, (p, k))
    if c % 4:
        raise ValueError("the splat kernels need a channel count that is a "
                         f"multiple of 4, got {c}")
    if max_channels is not None and c > max_channels:
        raise ValueError("the splat backward kernel takes at most "
                         f"{max_channels} channels, got {c}")
    if not 0 < num_cells < 2 ** 31 - 1 or p * k >= 2 ** 31:
        raise ValueError(f"num_cells {num_cells} or {p * k} rows exceed int32")
    return p, k, c


def sort_ids(ids: torch.Tensor, num_cells: int):
    """The plain reference of the order K4 gives the rows: the flat ids with
    every dropped id (negative or ``>= num_cells``) set to ``num_cells``,
    sorted ascending by a stable sort, and the flat row ``p * K + k`` of each
    sorted position; both (P * K,) int32. The dropped rows are the tail; the
    kernel orders the kept rows alike and never places the dropped ones."""
    flat = torch.where(_valid(ids, num_cells), ids,
                       torch.full_like(ids, num_cells)).reshape(-1)
    sids, order = torch.sort(flat, stable=True)
    return sids.to(torch.int32), order.to(torch.int32)


def _int_layout(m: int, num_cells: int) -> dict:
    """Where each part of K4's int scratch starts, in ints, as
    ``csrc/splat_topk.cu`` carves it: the cells' counters, the scan's
    ticket and the number of long segments (zeroed by the kernel's entry
    point), the counters' offsets inside their scan tile, the tiles'
    offsets with the number of kept rows last, and per flat row its arrival
    number in its cell (then the list of long segments), its place, the
    final order and the sorted ids."""
    n = num_cells + 1
    tiles = -(-n // _SCAN_TILE)
    starts, at = {}, 0
    for name, size in (("counts", n), ("ticket", 1), ("nlong", 1), ("local", n),
                       ("tiles", tiles), ("kept", 1), ("arrival", m),
                       ("placed", m), ("order", m), ("sids", m)):
        starts[name] = at
        at += size
    starts["end"] = at
    return starts


def forward_scratch(m: int, num_cells: int, channels: int):
    """(ints, floats) of scratch K4 needs for ``m`` flat rows. Floats: the
    two piece sums of every chunk of sorted rows, for the runs that cross
    the chunk's ends."""
    return (_int_layout(m, num_cells)["end"],
            2 * -(-m // _CHUNK) * channels)


def _launch_forward(dvals, feats, ids, num_cells, bf16_rows,
                    count="splat_topk"):
    """Kernel K4 on CUDA tensors, its launch counted under ``count``;
    returns the canvas and the int scratch, which holds the kernel's order
    afterwards."""
    p, k, c = _check(dvals, feats, ids, num_cells)
    n_ints, n_floats = forward_scratch(p * k, num_cells, c)
    canvas = torch.empty(num_cells, c, dtype=torch.float32,
                         device=dvals.device)
    ints = torch.empty(n_ints, dtype=torch.int32, device=dvals.device)
    pieces = torch.empty(n_floats, dtype=torch.float32, device=dvals.device)
    _cuda.launch("splat_topk", dvals.data_ptr(), feats.data_ptr(),
                 ids.data_ptr(), canvas.data_ptr(), ints.data_ptr(),
                 pieces.data_ptr(), p * k, k, c, num_cells,
                 int(bool(bf16_rows)))
    _cuda.LAUNCHES[count] += 1
    return canvas, ints


def splat_topk_with_order(dvals: torch.Tensor, feats: torch.Tensor,
                          ids: torch.Tensor, num_cells: int,
                          bf16_rows: bool = False):
    """Kernel K4 on CUDA tensors, with the order it summed in: (canvas, the
    kept rows' cell ids in sorted order, their flat rows ``p * K + k``). For
    checks: the order must be ``sort_ids``'s without its dropped tail."""
    canvas, ints = _launch_forward(dvals, feats, ids, num_cells, bf16_rows)
    at = _int_layout(dvals.numel(), num_cells)
    kept = int(ints[at["kept"]])
    return (canvas, ints[at["sids"]:at["sids"] + kept],
            ints[at["order"]:at["order"] + kept])


def splat_topk_fwd(dvals: torch.Tensor, feats: torch.Tensor,
                   ids: torch.Tensor, num_cells: int,
                   bf16_rows: bool = False) -> torch.Tensor:
    """The forward of ``splat_topk`` without autograd: the plain version for
    a CPU tensor, kernel K4 for a CUDA tensor."""
    if not dvals.is_cuda:
        return splat_topk_plain(dvals, feats, ids, num_cells, bf16_rows)
    return _launch_forward(dvals, feats, ids, num_cells, bf16_rows)[0]


def segment_sum(weights: torch.Tensor, rows: torch.Tensor,
                ids: torch.Tensor, num_cells: int, count: str) -> torch.Tensor:
    """``out[c] = sum over (r, q) with ids[r, q] == c of weights[r, q] *
    rows[r]``, (num_cells, C) fp32, for another kernel's records: weights
    (R, Q) fp32, rows (R, C) fp32 with C a multiple of 4, ids (R, Q) int32;
    an id outside ``[0, num_cells)`` drops its term. A CUDA tensor runs K4's
    kernels, which sum every cell in one fixed order (ascending ``r * Q +
    q``), counted under ``_cuda.LAUNCHES[count]``; a CPU tensor takes the
    plain version. No autograd."""
    if not weights.is_cuda:
        return splat_topk_plain(weights, rows, ids, num_cells)
    return _launch_forward(weights, rows, ids, num_cells, False, count)[0]


def splat_topk_bwd(dvals: torch.Tensor, feats: torch.Tensor,
                   ids: torch.Tensor, gout: torch.Tensor, num_cells: int):
    """(d_dvals, d_feats): the plain version for a CPU tensor, kernel K4b
    for a CUDA tensor."""
    if not dvals.is_cuda:
        return splat_topk_bwd_plain(dvals, feats, ids, gout, num_cells)
    p, k, c = _check(dvals, feats, ids, num_cells, _BWD_MAX_CHANNELS)
    _cuda.check_cuda_tensor(gout, "gout", torch.float32, (num_cells, c))
    d_dvals = torch.empty_like(dvals)
    d_feats = torch.empty_like(feats)
    _cuda.launch("splat_topk_bwd", dvals.data_ptr(), feats.data_ptr(),
                 ids.data_ptr(), gout.data_ptr(), d_dvals.data_ptr(),
                 d_feats.data_ptr(), p, k, c, num_cells)
    _cuda.LAUNCHES["splat_topk_bwd"] += 1
    return d_dvals, d_feats


class _SplatTopK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dvals, feats, ids, num_cells, bf16_rows):
        ctx.save_for_backward(dvals, feats, ids)
        ctx.num_cells = num_cells
        return splat_topk_fwd(dvals, feats, ids, num_cells, bf16_rows)

    @staticmethod
    def backward(ctx, gout):
        dvals, feats, ids = ctx.saved_tensors
        d_dvals, d_feats = splat_topk_bwd(dvals, feats, ids,
                                          gout.contiguous(), ctx.num_cells)
        return d_dvals, d_feats, None, None, None


def splat_topk(dvals: torch.Tensor, feats: torch.Tensor, ids: torch.Tensor,
               num_cells: int, bf16_rows: bool = False) -> torch.Tensor:
    """Canvas ``(num_cells, C)`` fp32 with ``canvas[c] = sum dvals[p, k] *
    feats[p]`` over the pairs with ``ids[p, k] == c``; cells that receive
    nothing are exactly 0.

    dvals (P, K) fp32 depth weights, feats (P, C) fp32 pixel features, ids
    (P, K) int32 flat cell ids, K minor (pixel-major rows); an id outside
    ``[0, num_cells)`` drops its row. ``bf16_rows`` rounds each product row
    to bf16 before the fp32 sum. A CPU tensor takes the plain versions; a
    CUDA tensor launches K4 and, in the backward, K4b.
    """
    if dvals.shape != ids.shape or dvals.shape[0] != feats.shape[0]:
        raise ValueError(f"dvals {tuple(dvals.shape)}, ids {tuple(ids.shape)} "
                         f"and feats {tuple(feats.shape)} do not match")
    return _SplatTopK.apply(dvals, feats, ids, num_cells, bf16_rows)
