"""Deformable 3x3 convolution: kernels K1 (forward) and K1b (backward) and
their plain versions.

Counterpart of ``gencomm_tpu/ops/deform.py`` (the gather formulation) and
``gencomm_tpu/ops/deform_pallas.py`` (``deform_conv3x3_mxu`` and its
``custom_vjp``, the TPU kernels). Stride 1, padding 1, bilinear sampling with
zero padding, torchvision (dy, dx)-per-tap offset layout. Offsets are clamped
to ±``MAX_OFFSET`` by the caller (``deform_conv3x3_clamped``), as on the TPU.

The backward follows the TPU kernel's conventions: the offset gradient is
the two-corner floor difference (-1 at floor(y), +1 at floor(y) + 1, the
latter counted wherever that corner lies inside the map, even at weight 0),
one-sided at exact integers; the offsets are not clipped again inside it.
On the card K1b sums nothing by atomics, so its three gradients have the
same bits on every run: its pass writes the input gradient's records
(``input_grad_records_plain`` is their plain version: per pixel and tap the
row u_k = g W_k^T and the four corners' pixels and bilinear weights), and
K4's kernels (``ops/splat.py:segment_sum``) sum each input pixel's weighted
rows in one fixed order, for any offsets.

Each kernel has two routes, chosen here from the channel counts
(``kernel_route``): ``"mma"``, for Cin a multiple of 32 and Cout = 64 (every
model of the repo), runs the contractions on the tensor cores as 3xTF32 (an
error-compensated split that keeps fp32-level results); ``"general"`` takes
any other channel counts with fp32 FMAs. Neither gives way to the plain
version: a CUDA tensor reaches a kernel or the call raises.

The forward also takes a bf16 ``x`` (``half``), as the TPU kernel does
(``deform_pallas.py:88``: the output in x's type): offsets and weight stay
fp32, the samples and the contraction are fp32, and the output is rounded
once to bf16. On the card that is K1's bf16 entry (C entry
``deform_conv3x3_bf16``, launches counted under ``deform_conv3x3_bf16``):
on route ``mma`` a kernel of its own, which takes the fp32 contraction as
three bf16 tensor-core products of operands split into hi + lo (within
~1e-5 of the fp32 product, ``tests/test_torch_bf16_split.py``), so a
rounded output may lie one bf16 step from the fp32 kernel's; on route
``general`` the fp32 kernel on the widened map. The backward takes fp32
only, and a backward through a bf16 forward raises (bf16 training is not
ported).
"""

from __future__ import annotations

import torch

from gencomm_tpu_torch.ops import _cuda, splat

MAX_OFFSET = 4  # px, the clamp of gencomm_tpu/ops/deform_pallas.py
ROUTES = {"general": 0, "mma": 1}  # the `route` argument of the C entry points
# launches by route, counted where the wrappers launch: which route a path took
ROUTE_LAUNCHES = {"deform_conv3x3": {"general": 0, "mma": 0},
                  "deform_conv3x3_bwd": {"general": 0, "mma": 0}}
# the same for the bf16 instantiation of K1, kept apart so that the fp32
# counts keep their keys
HALF_ROUTE_LAUNCHES = {"deform_conv3x3_bf16": {"general": 0, "mma": 0}}
_MMA_CHANNELS, _MMA_COUT, _MMA_TILE = 32, 64, 64
# the kernels' keys in ``_cuda.SIGNATURES`` by launch-count name
_ENTRIES = {"deform_conv3x3": "deform_conv", "deform_conv3x3_bf16": "deform_conv_bf16"}
# K1b's tensor-core route: a block takes one row of taps; blocks an SM
_MMA_TAP_ROWS, _MMA_BLOCKS_PER_SM = 3, 3
# general K1b, dweight: pixels each block of the weight pass reduces before
# the partial sums are added in a fixed order
_DW_PIXELS_PER_SPLIT = 2048
# general K1b, input pass: 32 pixels of g and u, W_k transposed with padded
# rows, and the 9 x 32 corner records, in at most 227 KB of shared memory
_SMEM_LIMIT = 227 * 1024


def kernel_route(cin: int, cout: int, backward: bool = False) -> str:
    """The route K1 (or, with ``backward``, K1b) takes for these channel
    counts; raises ``ValueError`` for counts that no route takes."""
    if cin > 0 and cin % _MMA_CHANNELS == 0 and cout == _MMA_COUT:
        return "mma"
    if backward:
        smem = 4 * (32 * cout + 32 * cin + cout * (cin + 1)) + 9 * 32 * 4 * 8
        if smem > _SMEM_LIMIT:
            raise ValueError(
                f"deform_conv3x3 backward: no kernel route takes Cin {cin}, "
                f"Cout {cout} (the general route needs {smem} bytes of shared "
                f"memory, the card gives a block {_SMEM_LIMIT}; the "
                f"tensor-core route takes Cin % {_MMA_CHANNELS} == 0 and Cout "
                f"== {_MMA_COUT})")
    return "general"


def backward_scratch(route: str, npix: int, cin: int, cout: int,
                     sm_count: int):
    """(nsplit, floats of scratch) of a K1b launch. ``mma``: nsplit groups
    of 64-pixel tiles, one block per group, 32-channel slice and row of
    taps, three blocks an SM; scratch holds each block's dweight partial and
    each slice's doffsets partial. ``general``: nsplit pixel ranges of the
    weight pass."""
    nw = 9 * cin * cout
    if route == "mma":
        slices = cin // _MMA_CHANNELS
        tiles = -(-npix // _MMA_TILE)
        nsplit = max(1, min(tiles, _MMA_BLOCKS_PER_SM * sm_count
                            // (_MMA_TAP_ROWS * slices)))
        return nsplit, nsplit * nw + slices * npix * 18
    nsplit = max(1, min(64, -(-npix // _DW_PIXELS_PER_SPLIT)))
    return nsplit, nsplit * nw


def _geometry(offsets: torch.Tensor, b: int, h: int, w: int):
    """Per (pixel, tap) sampling position: floor corners and the bilinear
    factors, (B, H, W, 9) each, in the forward's rounding order."""
    dev, dt = offsets.device, offsets.dtype
    off = offsets.reshape(b, h, w, 9, 2)
    base_y = torch.arange(h, dtype=dt, device=dev)[None, :, None, None]
    base_x = torch.arange(w, dtype=dt, device=dev)[None, None, :, None]
    k = torch.arange(9, device=dev)
    tap_y = (k // 3 - 1).to(dt)
    tap_x = (k % 3 - 1).to(dt)
    y = base_y + tap_y + off[..., 0]
    xx = base_x + tap_x + off[..., 1]
    y0, x0 = torch.floor(y), torch.floor(xx)
    wy1, wx1 = y - y0, xx - x0
    return y0, x0, 1.0 - wy1, wy1, 1.0 - wx1, wx1


def _corners(x: torch.Tensor, y0, x0):
    """For each corner (y0,x0), (y0,x1), (y1,x0), (y1,x1): (flat index into
    ``x`` viewed as (B*H*W, Cin), clamped; in-map mask)."""
    b, h, w, _ = x.shape
    bidx = torch.arange(b, device=x.device)[:, None, None, None] * (h * w)
    out = []
    for qy in (0, 1):
        for qx in (0, 1):
            iy, ix = y0 + qy, x0 + qx
            inb = (iy >= 0) & (iy <= h - 1) & (ix >= 0) & (ix <= w - 1)
            idx = bidx + (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).long()
            out.append((idx, inb))
    return out


def deform_conv3x3_plain(x: torch.Tensor, offsets: torch.Tensor,
                         weight: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, Cin), offsets (B, H, W, 18), weight (3, 3, Cin, Cout) ->
    (B, H, W, Cout) in x's type: bilinear gathers of the 9 taps, then one
    matmul, both in fp32 (a bf16 x is widened, the output rounded once)."""
    b, h, w, cin = x.shape
    cout = weight.shape[-1]
    y0, x0, wy0, wy1, wx0, wx1 = _geometry(offsets, b, h, w)
    flat = x.reshape(b * h * w, cin).float()
    wts = (wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1)
    samples = sum(flat[idx] * (wt * inb)[..., None]
                  for (idx, inb), wt in zip(_corners(x, y0, x0), wts))
    out = samples.reshape(b, h, w, 9 * cin) @ weight.reshape(9 * cin, cout)
    return out.to(x.dtype)


def deform_conv3x3_bwd_plain(x: torch.Tensor, offsets: torch.Tensor,
                             weight: torch.Tensor, g: torch.Tensor):
    """Gradients of ``deform_conv3x3_plain`` for the cotangent g (B, H, W,
    Cout): (dx (B, H, W, Cin), doffsets (B, H, W, 18), dweight (3, 3, Cin,
    Cout)). u = g W_k^T per tap is scattered into dx with the corner
    weights; the offset gradient is the two-corner floor difference."""
    b, h, w, cin = x.shape
    cout = weight.shape[-1]
    y0, x0, wy0, wy1, wx0, wx1 = _geometry(offsets, b, h, w)
    flat = x.reshape(b * h * w, cin)
    u = torch.einsum("bhwo,kco->bhwkc", g, weight.reshape(9, cin, cout))
    dflat = torch.zeros_like(flat)
    samples = torch.zeros_like(u)
    doff_y = torch.zeros_like(y0)
    doff_x = torch.zeros_like(x0)
    for q, (idx, inb) in enumerate(_corners(x, y0, x0)):
        qy, qx = q >> 1, q & 1
        wy, wx = (wy1 if qy else wy0), (wx1 if qx else wx0)
        wt = (wy * wx) * inb
        v = flat[idx] * inb[..., None]
        samples = samples + v * wt[..., None]
        dflat.index_add_(0, idx.reshape(-1),
                         (u * wt[..., None]).reshape(-1, cin))
        dot = (u * v).sum(-1)
        doff_y = doff_y + (1.0 if qy else -1.0) * wx * dot
        doff_x = doff_x + (1.0 if qx else -1.0) * wy * dot
    dweight = torch.einsum("bhwkc,bhwo->kco", samples, g)
    doff = torch.stack([doff_y, doff_x], dim=-1).reshape(b, h, w, 18)
    return (dflat.reshape(b, h, w, cin), doff,
            dweight.reshape(3, 3, cin, cout))


def input_grad_records_plain(offsets: torch.Tensor, weight: torch.Tensor,
                             g: torch.Tensor):
    """The records K1b writes for the input gradient, for offsets (B, H, W,
    18), weight (3, 3, Cin, Cout) and the cotangent g (B, H, W, Cout): with
    record r = pixel * 9 + tap, (weights (B H W 9, 4) fp32, rows (B H W 9,
    Cin) = u_tap(pixel) = g(pixel) W_tap^T, ids (B H W 9, 4) int32: the flat
    pixel of each corner, -1 outside the map). ``splat.splat_topk_plain(
    weights, rows, ids, B H W)`` is then dx, flattened to (B H W, Cin)."""
    b, h, w, _ = offsets.shape
    cin, cout = weight.shape[2:]
    y0, x0, wy0, wy1, wx0, wx1 = _geometry(offsets, b, h, w)
    rows = torch.einsum("bhwo,kco->bhwkc", g, weight.reshape(9, cin, cout))
    wts, ids = [], []
    # _corners reads only the (B, H, W) map and the device, as offsets has
    for q, (idx, inb) in enumerate(_corners(offsets, y0, x0)):
        wy, wx = (wy1 if q >> 1 else wy0), (wx1 if q & 1 else wx0)
        wts.append((wy * wx) * inb)
        ids.append(torch.where(inb, idx, torch.full_like(idx, -1)))
    return (torch.stack(wts, -1).reshape(-1, 4), rows.reshape(-1, cin),
            torch.stack(ids, -1).reshape(-1, 4).to(torch.int32))


def _check_args(x, offsets, weight, x_dtypes=(torch.float32,)):
    b, h, w, cin = x.shape
    cout = weight.shape[-1]
    _cuda.check_cuda_tensor(x, "x", x_dtypes)
    _cuda.check_cuda_tensor(offsets, "offsets", torch.float32, (b, h, w, 18))
    _cuda.check_cuda_tensor(weight, "weight", torch.float32, (3, 3, cin, cout))
    return b, h, w, cin, cout


def deform_conv3x3_fwd(x: torch.Tensor, offsets: torch.Tensor,
                       weight: torch.Tensor) -> torch.Tensor:
    """The forward of ``deform_conv3x3`` without autograd: the plain version
    for a CPU tensor, kernel K1 for a CUDA tensor (its bf16 instantiation
    for a bf16 ``x``)."""
    if not x.is_cuda:
        return deform_conv3x3_plain(x, offsets, weight)
    b, h, w, cin, cout = _check_args(x, offsets, weight,
                                     (torch.float32, torch.bfloat16))
    route = kernel_route(cin, cout)
    if route == "mma" and x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned: the tensor-core route "
                         "reads it by 16-byte vectors")
    name = ("deform_conv3x3_bf16" if x.dtype == torch.bfloat16
            else "deform_conv3x3")
    out = torch.empty(b, h, w, cout, dtype=x.dtype, device=x.device)
    _cuda.launch(_ENTRIES[name], x.data_ptr(), offsets.data_ptr(),
                 weight.data_ptr(), out.data_ptr(), b, h, w, cin, cout,
                 ROUTES[route])
    _cuda.LAUNCHES[name] += 1
    (HALF_ROUTE_LAUNCHES if name in HALF_ROUTE_LAUNCHES
     else ROUTE_LAUNCHES)[name][route] += 1
    return out


def deform_conv3x3_bwd(x: torch.Tensor, offsets: torch.Tensor,
                       weight: torch.Tensor, g: torch.Tensor):
    """(dx, doffsets, dweight) for the cotangent g (B, H, W, Cout): the
    plain version for a CPU tensor, kernel K1b for a CUDA tensor, whose
    input-gradient records K4's kernels then sum (counted under
    ``deform_conv3x3_bwd_dx``). The rows are padded with zeros to a
    multiple of 4 channels, which K4 reads as 16-byte vectors."""
    if not x.is_cuda:
        return deform_conv3x3_bwd_plain(x, offsets, weight, g)
    b, h, w, cin, cout = _check_args(x, offsets, weight)
    _cuda.check_cuda_tensor(g, "g", torch.float32, (b, h, w, cout))
    route = kernel_route(cin, cout, backward=True)
    npix = b * h * w
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    nsplit, nscratch = backward_scratch(route, npix, cin, cout, sm_count)
    cpad = -(-cin // 4) * 4
    rows = torch.empty(npix * 9, cpad, dtype=torch.float32, device=x.device)
    weights = torch.empty(npix * 9, 4, dtype=torch.float32, device=x.device)
    ids = torch.empty(npix * 9, 4, dtype=torch.int32, device=x.device)
    doff = torch.empty_like(offsets)
    dweight = torch.empty_like(weight)
    scratch = torch.empty(nscratch, dtype=torch.float32, device=x.device)
    _cuda.launch("deform_conv_bwd", x.data_ptr(), offsets.data_ptr(),
                 weight.data_ptr(), g.data_ptr(), rows.data_ptr(),
                 weights.data_ptr(), ids.data_ptr(), doff.data_ptr(),
                 dweight.data_ptr(), scratch.data_ptr(), b, h, w, cin, cout,
                 cpad, nsplit, ROUTES[route])
    _cuda.LAUNCHES["deform_conv3x3_bwd"] += 1
    ROUTE_LAUNCHES["deform_conv3x3_bwd"][route] += 1
    if npix == 0 or cin == 0:
        return torch.zeros_like(x), doff, dweight
    dx = splat.segment_sum(weights, rows, ids, npix,
                           count="deform_conv3x3_bwd_dx")
    if cpad != cin:
        dx = dx[:, :cin].contiguous()
    return dx.view(b, h, w, cin), doff, dweight


class _DeformConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offsets, weight):
        ctx.save_for_backward(x, offsets, weight)
        return deform_conv3x3_fwd(x, offsets, weight)

    @staticmethod
    def backward(ctx, g):
        x, offsets, weight = ctx.saved_tensors
        if x.dtype != torch.float32:
            raise NotImplementedError(
                "bf16 training (half=True) is not ported: the deformable "
                "conv's backward takes fp32 only")
        return deform_conv3x3_bwd(x, offsets, weight, g.contiguous())


def deform_conv3x3(x: torch.Tensor, offsets: torch.Tensor,
                   weight: torch.Tensor) -> torch.Tensor:
    """Deformable 3x3 conv without bias. x (B, H, W, Cin) fp32 or bf16,
    offsets (B, H, W, 18) fp32, weight (3, 3, Cin, Cout) fp32 -> (B, H, W,
    Cout) in x's type. A CPU tensor takes the plain versions; a CUDA tensor
    launches K1 and, in the backward (fp32 only), K1b."""
    return _DeformConv3x3.apply(x, offsets, weight)


def clamp_offsets(offsets: torch.Tensor) -> torch.Tensor:
    """Clamp to ±MAX_OFFSET as ``jnp.clip`` does, gradient included: an
    offset exactly at a bound passes half its gradient (the min/max tie
    rule), where ``torch.clamp`` would pass all of it. The bound is filled
    on the device (no copy from the host, which graph capture refuses)."""
    lim = torch.full((), float(MAX_OFFSET), dtype=offsets.dtype,
                     device=offsets.device)
    return torch.minimum(torch.maximum(offsets, -lim), lim)


def deform_conv3x3_clamped(x, offsets, weight, bias=None):
    """The message extractor's call: clamp offsets to ±MAX_OFFSET, run the
    deformable conv, add the bias (gencomm_tpu deform_conv3x3_auto)."""
    out = deform_conv3x3(x, clamp_offsets(offsets).contiguous(), weight)
    return out + bias if bias is not None else out
