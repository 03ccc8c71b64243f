"""Sparse 3D convolution from sort, binary search, gathers and products.

Counterpart of ``gencomm_tpu/ops/sparse.py``, which builds spconv's
submanifold and strided sparse convolutions for SECOND from primitives that
keep every shape static:

  - the active voxels live in fixed-capacity lists: feats (K, C), coords
    (K, 4) int32 = [agent, z, y, x], valid (K,);
  - a voxel is found by binary search (``torch.searchsorted``) over the
    sorted int32 linear keys; ``INVALID_KEY`` (int32 max) pads a list and
    sorts last;
  - a submanifold conv gathers each active voxel's 27 neighbours' rows (the
    list's zero row where there is none) and multiplies (K, 27 Cin) by
    (27 Cin, Cout), chunk by chunk;
  - a strided conv proposes, per input voxel, the output sites whose
    receptive field covers it (at most 2 a dimension for kernel 3, stride
    <= 2), and deduplicates them by sort + first occurrence + ``cumsum`` +
    a scatter into a dump row, keeping the first ``capacity`` keys in
    ascending order (the last agent's voxels are dropped first).

Nothing here reads a value back to the host (no ``unique``, ``nonzero``,
boolean-mask indexing or ``.item()``), and every constant is made on the
device (``arange``, fills), so a frame through SECOND can be captured in a
CUDA graph. ``voxelize_mean`` sums each voxel's points in point order with
``torch.segment_reduce`` over the points stable-sorted by voxel: its CUDA
kernel sums a segment sequentially, so the means have the same bits on every
run (``scatter_add_`` / ``index_add_`` would add by atomics in a
run-dependent order) and the bits of the JAX package's CPU segment sum.
Voxel indices are ``floor((x - r0) / v)`` by true division: PyTorch on CUDA
multiplies by the reciprocal of a Python scalar divisor, which moves points
that lie on a voxel boundary, so the divisor is a tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch

INVALID_KEY = 2 ** 31 - 1

Grid = Tuple[int, int, int]


def linear_key(coords: torch.Tensor, grid_dhw: Grid,
               valid: torch.Tensor | None = None) -> torch.Tensor:
    """coords (..., 4) int32 [agent, z, y, x] -> int32 keys, INVALID_KEY
    outside the grid or where not ``valid``. n_agents * D * H * W must stay
    below 2^31."""
    d, h, w = grid_dhw
    a, z, y, x = coords.unbind(-1)
    key = ((a * d + z) * h + y) * w + x
    inb = (z >= 0) & (z < d) & (y >= 0) & (y < h) & (x >= 0) & (x < w)
    if valid is not None:
        inb = inb & valid
    return torch.where(inb, key, INVALID_KEY)


def key_to_coords(keys: torch.Tensor, grid_dhw: Grid) -> torch.Tensor:
    """Non-negative keys -> (..., 4) [agent, z, y, x]."""
    d, h, w = grid_dhw

    def fdiv(v, n):
        return torch.div(v, n, rounding_mode="floor")

    return torch.stack([fdiv(keys, w * h * d), fdiv(keys, w * h) % d,
                        fdiv(keys, w) % h, keys % w], dim=-1)


def lookup(sorted_keys: torch.Tensor, sorted_idx: torch.Tensor,
           query_keys: torch.Tensor) -> torch.Tensor:
    """The list positions (int32) of ``query_keys`` in the active set whose
    keys ascend in ``sorted_keys`` (``sorted_idx`` maps them back to the
    list); K, one past the end, where a key is missing or invalid."""
    k = sorted_keys.shape[0]
    pos = torch.searchsorted(sorted_keys, query_keys.contiguous(),
                             out_int32=True).clamp_(0, k - 1)
    hit = (sorted_keys[pos] == query_keys) & (query_keys != INVALID_KEY)
    return torch.where(hit, sorted_idx[pos], k)


def build_index(keys: torch.Tensor):
    """Keys sorted ascending (invalid last, stably) and the int32
    permutation into the list: (sorted_keys, sorted_idx)."""
    sorted_keys, order = torch.sort(keys, stable=True)
    return sorted_keys, order.to(torch.int32)


def unique_compact(keys: torch.Tensor, capacity: int):
    """The distinct valid ``keys`` ascending in a list of ``capacity``
    (INVALID_KEY after them) and their count, capped at ``capacity`` (a
    0-dim tensor). Keys past the capacity are dropped."""
    sorted_keys = torch.sort(keys).values
    first = torch.ones_like(sorted_keys, dtype=torch.bool)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    first &= sorted_keys != INVALID_KEY
    pos = torch.cumsum(first, 0) - 1
    dump = torch.where(first & (pos < capacity), pos, capacity)
    out = torch.full((capacity + 1,), INVALID_KEY, dtype=keys.dtype,
                     device=keys.device)
    # every key past the first of its run lands in the dump row
    out.scatter_(0, dump, sorted_keys)
    return out[:capacity], first.sum().clamp(max=capacity)


def _offsets(kernel: Grid, device, centred: bool = True) -> torch.Tensor:
    """(kz * ky * kx, 3) int32 kernel offsets in (z, y, x) order, z
    slowest; centred (-k//2 ..) or raw (0 .. k-1). Made on the device."""
    axes = [torch.arange(k, dtype=torch.int32, device=device)
            - (k // 2 if centred else 0) for k in kernel]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)


def _neighbour_coords(coords: torch.Tensor, base: torch.Tensor,
                      offs: torch.Tensor) -> torch.Tensor:
    """(K, N, 4): each row's agent with ``base`` (K, 3) + every offset."""
    k, n = coords.shape[0], offs.shape[0]
    return torch.cat([coords[:, None, :1].expand(k, n, 1),
                      base[:, None, :] + offs[None]], dim=-1)


def _chunked_gather_matmul(feats_padded: torch.Tensor, idx: torch.Tensor,
                           weight: torch.Tensor, chunk: int = 8192
                           ) -> torch.Tensor:
    """out[k] = sum_n feats_padded[idx[k, n]] @ weight[n], chunk rows at a
    time, so that no more than (chunk, N Cin) is gathered at once.

    feats_padded (K'+1, Cin) with a zero last row; idx (K, N) int32;
    weight (N, Cin, Cout)."""
    k, n = idx.shape
    wmat = weight.reshape(n * weight.shape[1], weight.shape[2])
    outs = []
    for s in range(0, k, chunk):
        part = idx[s:s + chunk]
        g = feats_padded.index_select(0, part.reshape(-1))
        outs.append(g.reshape(part.shape[0], -1) @ wmat)
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def _conv_rows(feats, idx, weight, chunk):
    feats_p = torch.cat([feats, feats.new_zeros((1, feats.shape[1]))])
    kernel = tuple(weight.shape[:3])
    n = kernel[0] * kernel[1] * kernel[2]
    return _chunked_gather_matmul(feats_p, idx,
                                  weight.reshape(n, *weight.shape[3:]), chunk)


def subm_conv3d(feats, coords, valid, weight, grid_dhw: Grid,
                sorted_keys=None, sorted_idx=None, chunk: int = 8192):
    """Submanifold sparse conv: outputs at exactly the active input sites.

    feats (K, Cin); coords (K, 4) int32; valid (K,) bool; weight (kz, ky,
    kx, Cin, Cout). A prebuilt (sorted_keys, sorted_idx) of the same list
    saves the sort for every conv that shares it (spconv's indice_key)."""
    k = feats.shape[0]
    if sorted_keys is None:
        sorted_keys, sorted_idx = build_index(
            linear_key(coords, grid_dhw, valid))
    offs = _offsets(tuple(weight.shape[:3]), coords.device)
    nkeys = linear_key(_neighbour_coords(coords, coords[:, 1:], offs),
                       grid_dhw, valid[:, None].expand(k, offs.shape[0]))
    idx = lookup(sorted_keys, sorted_idx, nkeys.reshape(-1)).reshape(k, -1)
    return _conv_rows(feats, idx, weight, chunk) * valid[:, None]


def spconv3d_downsample(feats, coords, valid, weight, grid_dhw: Grid,
                        stride: Grid, padding: Grid, out_capacity: int,
                        chunk: int = 8192):
    """Strided ("regular") sparse conv with spconv's output-site dilation.

    Returns (out_feats (K_out, Cout), out_coords (K_out, 4) int32,
    out_valid (K_out,), out_grid_dhw)."""
    kernel = tuple(weight.shape[:3])
    out_grid = tuple((grid_dhw[i] + 2 * padding[i] - kernel[i]) // stride[i]
                     + 1 for i in range(3))
    # the output sites covering an input voxel, per dimension: the integer o
    # with s*o - p <= c <= s*o - p + k - 1, i.e. ceil((c+p-k+1)/s) <= o <=
    # floor((c+p)/s); floor division, as c + p - k + 1 is negative at the
    # border
    per_dim = []
    for i in range(3):
        c = coords[:, 1 + i]
        lo = -torch.div(-(c + padding[i] - kernel[i] + 1), stride[i],
                        rounding_mode="floor")
        hi = torch.div(c + padding[i], stride[i], rounding_mode="floor")
        per_dim.append((lo, torch.minimum(lo + 1, hi)))
    a = coords[:, 0]
    cands = torch.stack([torch.stack([a, z, y, x], dim=-1)
                         for z in per_dim[0] for y in per_dim[1]
                         for x in per_dim[2]], dim=1)  # (K, 8, 4)
    ckeys = linear_key(cands, out_grid, valid[:, None].expand(-1, 8))
    out_keys, _ = unique_compact(ckeys.reshape(-1), out_capacity)
    out_valid = out_keys != INVALID_KEY
    out_coords = key_to_coords(torch.where(out_valid, out_keys, 0),
                               out_grid).to(coords.dtype)

    # an output site's inputs: s * o - p + the raw kernel offset
    sorted_keys, sorted_idx = build_index(linear_key(coords, grid_dhw, valid))
    offs = _offsets(kernel, coords.device, centred=False)
    base = torch.stack([out_coords[:, 1 + i] * stride[i] - padding[i]
                        for i in range(3)], dim=-1)
    nkeys = linear_key(_neighbour_coords(out_coords, base, offs), grid_dhw,
                       out_valid[:, None].expand(-1, offs.shape[0]))
    idx = lookup(sorted_keys, sorted_idx, nkeys.reshape(-1)).reshape(
        out_capacity, -1)
    out = _conv_rows(feats, idx, weight, chunk)
    return out * out_valid[:, None], out_coords, out_valid, out_grid


def segment_sum_sorted(values: torch.Tensor, seg: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """(num_segments, C) sums of the rows of ``values`` (N, C) by segment
    id ``seg`` (N,) in [0, num_segments), each segment summed sequentially
    in row order: the rows stable-sorted by id, then one
    ``torch.segment_reduce`` over the offsets of the runs."""
    seg_sorted, order = torch.sort(seg, stable=True)
    bounds = torch.arange(num_segments + 1, dtype=seg.dtype, device=seg.device)
    offsets = torch.searchsorted(seg_sorted, bounds)
    return torch.segment_reduce(values.index_select(0, order), "sum",
                                offsets=offsets, axis=0, unsafe=True)


def voxel_index(v: torch.Tensor, lo: float, size: float) -> torch.Tensor:
    """floor((v - lo) / size) as int32, by true division (see the module's
    docstring)."""
    return torch.floor((v - lo) / torch.full_like(v, size)).to(torch.int32)


def voxelize_mean(points, point_mask, pc_range, voxel_size, grid_dhw: Grid,
                  capacity: int):
    """Points -> a fixed-capacity voxel list with mean features (MeanVFE).

    points (A, P, F); point_mask (A, P). Returns (feats (capacity, F),
    coords (capacity, 4) int32 in ascending key order, valid (capacity,)).
    """
    a, p, dfeat = points.shape
    ix, iy, iz = (voxel_index(points[..., i], pc_range[i], voxel_size[i])
                  for i in range(3))
    agent = torch.arange(a, dtype=torch.int32,
                         device=points.device)[:, None].expand(a, p)
    keys_pt = linear_key(torch.stack([agent, iz, iy, ix], dim=-1), grid_dhw,
                         point_mask.bool()).reshape(-1)
    vox_keys, _ = unique_compact(keys_pt, capacity)  # ascending
    vox_valid = vox_keys != INVALID_KEY
    vox_coords = key_to_coords(torch.where(vox_valid, vox_keys, 0), grid_dhw)
    # each point's voxel, ``capacity`` (the dump segment) for a point out of
    # the grid, masked, or in a voxel past the capacity
    idx = lookup(vox_keys, torch.arange(capacity, dtype=torch.int32,
                                        device=points.device), keys_pt)
    flat = points.reshape(a * p, dfeat)
    vmask = (keys_pt != INVALID_KEY).to(points.dtype)[:, None]
    sums = segment_sum_sorted(torch.cat([flat * vmask, vmask], dim=1), idx,
                              capacity + 1)
    feats = (sums[:, :dfeat] / sums[:, dfeat:].clamp_min(1.0))[:capacity]
    return feats * vox_valid[:, None], vox_coords, vox_valid


def scatter_to_dense(feats, coords, valid, grid_dhw: Grid, n_agents: int):
    """Sparse voxels -> a dense (A, D, H, W, C) volume (the height
    compression's input)."""
    d, h, w = grid_dhw
    keys = linear_key(coords, grid_dhw, valid)
    total = n_agents * d * h * w
    flat_idx = torch.where(keys != INVALID_KEY, keys, total).long()
    canvas = feats.new_zeros((total + 1, feats.shape[1]))
    canvas = canvas.index_put((flat_idx,), feats)  # invalid rows: the dump
    return canvas[:total].reshape(n_agents, d, h, w, feats.shape[1])
