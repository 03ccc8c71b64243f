"""Affine BEV feature warp: kernels K3 (forward) and K3b (backward) and
their plain versions.

Counterpart of ``gencomm_tpu/ops/warp.py`` (the gather warp) and
``gencomm_tpu/ops/warp_pallas.py`` (``warp_affine_mxu``, the TPU kernel,
whose VJP differentiates the gather). Bilinear sampling with zero padding
in torch ``affine_grid`` convention (align_corners=False), NHWC, output
H x W equal to the input's. The backward scatters each output cotangent
into the four source corners with their bilinear weights; theta gets no
gradient (it comes from poses), and a theta that requires one is refused.

The forward also takes a bf16 ``src`` (``half``), with the TPU kernel's
contract (``warp_pallas.py:71-82``): the same fp32 coordinates, the lerp in
fp32, the output rounded once to bf16. On the card that is a second
instantiation of K3 (C entry ``warp_affine_bf16``, launches counted under
``warp_affine_bf16``). The JAX main path's bf16 gather (``ops/warp.py``)
rounds its lerp weights and products to bf16 instead. The backward takes
fp32 only; a backward through a bf16 forward raises (bf16 training is not
ported).

K3 has three routes, chosen by its C entries from the width and the
alignment and mirrored by ``forward_route`` for the launch counts
(``FORWARD_ROUTE_LAUNCHES``): ``"rows"``, 16-byte vectors (C a multiple of
4 in fp32, of 8 in bf16, both maps 16-byte aligned) over lanes sized from
C; ``"pixel"``, a thread a pixel, for the maps of at most
``FORWARD_PIXEL_MAX_CHANNELS`` channels that ``rows`` does not take (the
one-channel occupancy scores); ``"scalar"``, single channels over 2 to 32
lanes a pixel, for wider maps ``rows`` does not take (C % 4 != 0, or a view
off 16 bytes). All give the same bits. ``warp_affine_pair`` warps two fp32
maps under one theta in one launch (C entry ``warp_affine_pair_f32``): the
HEAL pyramid's level feature, on its route, and its one-channel score,
blended from the same samples, each with the bits of its own launch.

K3b has two routes (``backward_route``, the C entry's ``route`` argument):
``"warp"``, a warp for four source pixels with its lanes over the channels,
for wide maps, and ``"pixel"``, a thread for each source pixel, for maps of
at most ``PIXEL_MAX_CHANNELS`` channels (the pyramid's one-channel
occupancy scores). Both sum each channel in the same order, so they give
the same bits.
"""

from __future__ import annotations

import torch

from gencomm_tpu_torch.ops import _cuda

# csrc/warp_affine.cu:plan_for: the widest map K3's pixel route takes (where
# rows does not); two lanes a pixel beat it at 5 and 6 channels on an H100
FORWARD_PIXEL_MAX_CHANNELS = 4
# fp32 K3's launches by route (warp_affine_pair's by its first map's),
# counted where the wrappers launch
FORWARD_ROUTE_LAUNCHES = {"rows": 0, "pixel": 0, "scalar": 0}
ROUTES = {"warp": 0, "pixel": 1}  # the `route` argument of K3b's C entry
# csrc/warp_affine_bwd.cu: the widest map the pixel route takes; on an H100
# it beat the warp route at every width up to this one (PERF.md section 6)
PIXEL_MAX_CHANNELS = 8
# K3b's launches by route, counted where the wrapper launches
ROUTE_LAUNCHES = {"warp": 0, "pixel": 0}


def forward_route(channels: int, aligned: bool, vector: int = 4) -> str:
    """The route K3 takes for a map of ``channels`` channels whose input
    and output are (``aligned``) or are not both 16-byte aligned; ``vector``
    channels a 16-byte load (4 in fp32, 8 in bf16)."""
    if channels % vector == 0 and aligned:
        return "rows"
    return "pixel" if channels <= FORWARD_PIXEL_MAX_CHANNELS else "scalar"


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def backward_route(channels: int) -> str:
    """The route K3b takes for a map of ``channels`` channels."""
    return "pixel" if channels <= PIXEL_MAX_CHANNELS else "warp"


def _sample_grid(theta: torch.Tensor, n: int, h: int, w: int):
    """Source coordinates of every output pixel: floor corners (x0, y0) and
    bilinear factors (wx0, wx1, wy0, wy1), (N, H, W) each, in fp32 and
    never rounded to a pixel."""
    dev = theta.device
    ys = (2.0 * torch.arange(h, dtype=torch.float32, device=dev) + 1.0) / h - 1.0
    xs = (2.0 * torch.arange(w, dtype=torch.float32, device=dev) + 1.0) / w - 1.0
    gy, gx = ys[None, :, None], xs[None, None, :]
    th = theta.to(torch.float32)[:, :, :, None, None]  # (N, 2, 3, 1, 1)
    sx = th[:, 0, 0] * gx + th[:, 0, 1] * gy + th[:, 0, 2]  # (N, H, W)
    sy = th[:, 1, 0] * gx + th[:, 1, 1] * gy + th[:, 1, 2]
    x = (sx + 1.0) * w / 2.0 - 0.5
    y = (sy + 1.0) * h / 2.0 - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    return x0, y0, 1.0 - wx1, wx1, 1.0 - wy1, wy1


def _corners(n: int, h: int, w: int, theta: torch.Tensor):
    """(flat source index into (N*H*W, C), clamped; in-map mask; bilinear
    weight) of the corners (x0,y0), (x1,y0), (x0,y1), (x1,y1)."""
    x0, y0, wx0, wx1, wy0, wy1 = _sample_grid(theta, n, h, w)
    bidx = torch.arange(n, device=theta.device)[:, None, None] * (h * w)
    out = []
    for k in range(4):
        ix, iy = x0 + (k & 1), y0 + (k >> 1)
        inb = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        idx = bidx + (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).long()
        wgt = (wx1 if k & 1 else wx0) * (wy1 if k >> 1 else wy0)
        out.append((idx, inb, wgt))
    return out


def _source_window(theta: torch.Tensor, h: int, w: int):
    """K3b's window rule (``csrc/warp_affine_bwd.cu:source_window``), used
    only by the tests: for every source pixel (n, iy, ix) the inclusive
    output-pixel box (xo0, xo1, yo0, yo1), each (N, H, W) int64, that holds
    every output whose sample point lies in [ix-1, ix+1) x [iy-1, iy+1).

    In pixel space (x + 0.5, y + 0.5) = M (xo + 0.5, yo + 0.5) + c with
    M = [[t0, t1 w/h], [t3 h/w, t4]]; the box bounds the preimage of that
    square under M, widened for the rounding of the fp32 coordinate chain
    and clipped to the map. A singular M takes the whole map."""
    th = theta.to(torch.float64).reshape(-1, 6)
    t0, t1, t2, t3, t4, t5 = th.unbind(-1)
    aspect = w / h
    m00, m01, m10, m11 = t0, t1 * aspect, t3 / aspect, t4
    c0 = 0.5 * w * (t2 + 1.0 - t0 - t1)
    c1 = 0.5 * h * (t5 + 1.0 - t3 - t4)
    det = m00 * m11 - m01 * m10
    singular = ~(det.abs() > 0)
    inv = 1.0 / torch.where(singular, torch.ones_like(det), det)
    i00, i01, i10, i11 = m11 * inv, -m01 * inv, -m10 * inv, m00 * inv
    delta = 1e-4 * (1.0 + w * (t0.abs() + t1.abs() + t2.abs() + 1.0)
                    + h * (t3.abs() + t4.abs() + t5.abs() + 1.0))
    eu = ((i00.abs() + i01.abs()) * (1.0 + delta) + 1e-3)[:, None, None]
    ev = ((i10.abs() + i11.abs()) * (1.0 + delta) + 1e-3)[:, None, None]
    ix = torch.arange(w, dtype=torch.float64, device=theta.device)
    iy = torch.arange(h, dtype=torch.float64, device=theta.device)
    xc = ix[None, None, :] + 0.5 - c0[:, None, None]
    yc = iy[None, :, None] + 0.5 - c1[:, None, None]
    uc = i00[:, None, None] * xc + i01[:, None, None] * yc - 0.5
    vc = i10[:, None, None] * xc + i11[:, None, None] * yc - 0.5
    box = [torch.ceil(uc - eu), torch.floor(uc + eu),
           torch.ceil(vc - ev), torch.floor(vc + ev)]
    full = singular[:, None, None] | ~torch.stack(box).isfinite().all(0)
    out = []
    for v, lo, size in zip(box, (True, False, True, False), (w, w, h, h)):
        # a first index past the map or a last one before it: an empty box
        v = v.clamp(0.0, float(size)) if lo else v.clamp(-1.0, size - 1.0)
        edge = 0.0 if lo else size - 1.0
        out.append(torch.where(full, torch.full_like(v, edge), v).long())
    return tuple(out)


def warp_affine_plain(src: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """src (N, H, W, C), theta (N, 2, 3) -> (N, H, W, C) in src's type: the
    four-corner gather, blended in fp32 (a bf16 src is widened, the output
    rounded once)."""
    n, h, w, c = src.shape
    flat = src.reshape(n * h * w, c).float()
    out = sum(flat[idx] * (wgt * inb)[..., None]
              for idx, inb, wgt in _corners(n, h, w, theta))
    return out.to(src.dtype)


def warp_affine_bwd_plain(g: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """d src (N, H, W, C) for the output cotangent g (N, H, W, C): the
    four-corner scatter-add, nothing from samples outside the source."""
    n, h, w, c = g.shape
    dflat = torch.zeros(n * h * w, c, dtype=g.dtype, device=g.device)
    for idx, inb, wgt in _corners(n, h, w, theta):
        dflat.index_add_(0, idx.reshape(-1), (
            g * (wgt * inb)[..., None].to(g.dtype)).reshape(-1, c))
    return dflat.reshape(n, h, w, c)


def _check_args(t, theta, name, dtypes=(torch.float32,)):
    n = t.shape[0]
    _cuda.check_cuda_tensor(t, name, dtypes)
    _cuda.check_cuda_tensor(theta, "theta", torch.float32, (n, 2, 3))
    return t.shape


def warp_affine_fwd(src: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """The forward of ``warp_affine`` without autograd: the plain version
    for a CPU tensor, kernel K3 for a CUDA tensor (its bf16 instantiation
    for a bf16 ``src``)."""
    if not src.is_cuda:
        return warp_affine_plain(src, theta)
    n, h, w, c = _check_args(src, theta, "src",
                             (torch.float32, torch.bfloat16))
    half = src.dtype == torch.bfloat16
    name = "warp_affine_bf16" if half else "warp_affine"
    out = torch.empty_like(src)
    _cuda.launch(name, src.data_ptr(), theta.data_ptr(), out.data_ptr(), n,
                 h, w, c)
    _cuda.LAUNCHES[name] += 1
    if not half:
        FORWARD_ROUTE_LAUNCHES[forward_route(c, _aligned(src, out))] += 1
    return out


def warp_affine_pair_fwd(feat: torch.Tensor, score: torch.Tensor,
                         theta: torch.Tensor):
    """``(warp_affine_fwd(feat, theta), warp_affine_fwd(score, theta))``
    without autograd: the plain version for CPU tensors, one K3 launch for
    CUDA tensors (fp32; ``feat`` (N, H, W, C), ``score`` (N, H, W, C_b),
    each output with the bits of its own launch)."""
    if not feat.is_cuda:
        return warp_affine_plain(feat, theta), warp_affine_plain(score, theta)
    n, h, w, c = _check_args(feat, theta, "feat")
    _cuda.check_cuda_tensor(score, "score", torch.float32)
    if score.dim() != 4 or tuple(score.shape[:3]) != (n, h, w) or \
            not (c and score.shape[3]):
        raise ValueError(f"feat {tuple(feat.shape)} and score "
                         f"{tuple(score.shape)} must be (N, H, W, C) maps "
                         "of one N, H, W, each of at least one channel")
    out, out_s = torch.empty_like(feat), torch.empty_like(score)
    _cuda.launch("warp_affine_pair", feat.data_ptr(), score.data_ptr(),
                 theta.data_ptr(), out.data_ptr(), out_s.data_ptr(), n, h, w,
                 c, score.shape[3])
    _cuda.LAUNCHES["warp_affine"] += 1
    FORWARD_ROUTE_LAUNCHES[forward_route(c, _aligned(feat, out))] += 1
    return out, out_s


def warp_affine_bwd(g: torch.Tensor, theta: torch.Tensor,
                    route: str | None = None) -> torch.Tensor:
    """d src for the cotangent g: the plain version for a CPU tensor,
    kernel K3b for a CUDA tensor, on ``route`` (default
    ``backward_route(C)``)."""
    if not g.is_cuda:
        return warp_affine_bwd_plain(g, theta)
    n, h, w, c = _check_args(g, theta, "g")
    route = route or backward_route(c)
    if route not in ROUTES:
        raise ValueError(f"K3b has no route {route!r}; routes: "
                         f"{sorted(ROUTES)}")
    if route == "pixel" and c > PIXEL_MAX_CHANNELS:
        raise ValueError(f"K3b's pixel route takes at most "
                         f"{PIXEL_MAX_CHANNELS} channels, got {c}")
    dsrc = torch.empty_like(g)
    _cuda.launch("warp_affine_bwd", g.data_ptr(), theta.data_ptr(),
                 dsrc.data_ptr(), n, h, w, c, ROUTES[route])
    _cuda.LAUNCHES["warp_affine_bwd"] += 1
    ROUTE_LAUNCHES[route] += 1
    return dsrc


class _WarpAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, theta):
        ctx.save_for_backward(theta)
        return warp_affine_fwd(src, theta)

    @staticmethod
    def backward(ctx, g):
        (theta,) = ctx.saved_tensors
        if g.dtype != torch.float32:
            raise NotImplementedError(
                "bf16 training (half=True) is not ported: the warp's "
                "backward takes fp32 only")
        return warp_affine_bwd(g.contiguous(), theta), None


class _WarpAffinePair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, score, theta):
        ctx.save_for_backward(theta)
        return warp_affine_pair_fwd(feat, score, theta)

    @staticmethod
    def backward(ctx, g, g_score):
        (theta,) = ctx.saved_tensors
        return (warp_affine_bwd(g.contiguous(), theta),
                warp_affine_bwd(g_score.contiguous(), theta), None)


def warp_affine_pair(feat: torch.Tensor, score: torch.Tensor,
                     theta: torch.Tensor):
    """Two fp32 maps warped under one theta, ``(warp_affine(feat, theta),
    warp_affine(score, theta))`` bit for bit: on the card one K3 launch
    forward and two K3b launches (each on its route) backward. theta must
    not require a gradient."""
    if theta.requires_grad and torch.is_grad_enabled():
        raise ValueError("warp_affine_pair gives theta no gradient; pass a "
                         "theta that does not require one")
    return _WarpAffinePair.apply(feat, score, theta)


def warp_affine(src: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Exact bilinear affine warp. src (N, H, W, C) fp32 or bf16, theta
    (N, 2, 3) fp32 -> (N, H, W, C) in src's type. A CPU tensor takes the
    plain versions; a CUDA tensor launches K3 and, in the backward (fp32
    only), K3b. theta must not require a gradient."""
    if theta.requires_grad and torch.is_grad_enabled():
        raise ValueError("warp_affine gives theta no gradient; pass a theta "
                         "that does not require one")
    return _WarpAffine.apply(src, theta)
