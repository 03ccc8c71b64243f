"""The port's forward kernels against the JAX package, on the CPU, and
every kernel against its plain version on the card.

For each of K1 (deformable conv), K2 (pillar canvas) and K3 (affine warp)
the plain PyTorch version, which the wrapper takes for a CPU tensor, is held
against the JAX Pallas kernel (interpret mode, as the JAX package's own
tests run it) and against the JAX gather/scatter formulation, on inputs
made with numpy from a seed. The CUDA halves (kernel vs plain version on
the card), those of the backward kernels K1b, K2b and K3b and of the
camera path's K4 and K4b (top-K depth splat) included, carry the ``cuda``
marker and skip without a card (K1 and K1b at the four shapes of the port's
paths, on their tensor-core route, and at ragged shapes on the general one);
what the K1 / K1b, K2b and K4 wrappers decide in Python (the route, the
scratch sizes, the refusal, the plain reference of K4's row order) and the
3xTF32 split are held on the CPU; their inputs come from ``deform_case``,
``canvas_case`` and ``splat_case``, which ``test_torch_train.py`` and
``test_torch_camera.py`` share.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import bf16_steps_apart
from gencomm_tpu_torch.ops._cuda import LAUNCHES
from gencomm_tpu_torch.ops.deform_conv import (
    HALF_ROUTE_LAUNCHES, MAX_OFFSET, ROUTE_LAUNCHES, backward_scratch,
    deform_conv3x3, deform_conv3x3_bwd, deform_conv3x3_bwd_plain,
    deform_conv3x3_clamped, deform_conv3x3_plain, kernel_route,
)
from gencomm_tpu_torch.ops import pillar_canvas as pillar_canvas_ops
from gencomm_tpu_torch.ops.pillar_canvas import (
    backward_route, pillar_canvas, pillar_canvas_bwd,
    pillar_canvas_bwd_plain, pillar_canvas_plain,
)
from gencomm_tpu_torch.ops.splat import (
    forward_scratch, sort_ids, splat_topk, splat_topk_bwd,
    splat_topk_bwd_plain, splat_topk_fwd, splat_topk_plain,
    splat_topk_with_order,
)
from gencomm_tpu_torch.ops.warp import (
    FORWARD_PIXEL_MAX_CHANNELS, FORWARD_ROUTE_LAUNCHES,
    ROUTE_LAUNCHES as WARP_ROUTE_LAUNCHES, _corners, _source_window,
    forward_route, warp_affine, warp_affine_bwd, warp_affine_bwd_plain,
    warp_affine_pair, warp_affine_plain,
)

# rotations, a shear, a scale, translations pushing part of the map out of
# range, and a translation beyond the map (all samples out of range)
THETAS = np.asarray([
    [[1.0, 0, 0], [0, 1.0, 0]],
    [[0.9, -0.2, 0.1], [0.2, 0.9, -0.05]],
    [[0.5, 0.86, 0.3], [-0.86, 0.5, 0.2]],
    [[1.3, 0.0, -0.4], [0.0, 0.7, 0.6]],
    [[-1.0, 0.0, 0.5], [0.0, -1.0, -0.7]],
    [[1.0, 0.0, 2.5], [0.0, 1.0, 0.0]],
], np.float32)
# K3b's window rule at its edges: a zero theta (every output samples the
# centre: a singular M, the whole map), a 4x zoom (up to 16 outputs a source
# pixel) and a nearly singular shear (|det| ~ 1e-6: windows up to the map)
EXTRA_THETAS = np.asarray([
    [[0.0, 0, 0], [0, 0.0, 0]],
    [[0.25, 0, 0.1], [0, 0.25, -0.05]],
    [[1.0, 0.5, 0.1], [2.0, 1.000001, -0.2]],
], np.float32)


@pytest.fixture(scope="module")
def jx():
    """The JAX references as numpy-in, numpy-out functions, imported here
    so that the card's halves of this file also run where JAX is not
    installed."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from gencomm_tpu.native import stripe_pad_sorted
    from gencomm_tpu.ops.deform import deform_conv3x3_nhwc
    from gencomm_tpu.ops.deform_pallas import (
        deform_conv3x3_auto, deform_conv3x3_mxu,
    )
    from gencomm_tpu.ops.pillar_pallas import (
        striped_pillar_canvas, striped_pillar_canvas_reference,
    )
    from gencomm_tpu.ops.warp import warp_affine_nhwc
    from gencomm_tpu.ops.warp_pallas import warp_affine_mxu

    def numpy_fn(fn):
        return lambda *args, **kw: np.array(fn(*(
            jnp.asarray(a) if isinstance(a, np.ndarray) else a
            for a in args), **kw).astype(jnp.float32))

    def bf16_rows(x):
        return jnp.asarray(x).astype(jnp.bfloat16)

    def warp_vjp(fn):
        # d src of ``fn(src, theta)`` for the cotangent g, as numpy
        def vjp(src, theta, g):
            _, pull = jax.vjp(lambda s: fn(s, jnp.asarray(theta)),
                              jnp.asarray(src))
            return np.asarray(pull(jnp.asarray(g))[0])
        return vjp

    return SimpleNamespace(
        deform_mxu=numpy_fn(deform_conv3x3_mxu),
        deform_gather=numpy_fn(deform_conv3x3_nhwc),
        deform_auto=numpy_fn(deform_conv3x3_auto),
        canvas_reference=numpy_fn(striped_pillar_canvas_reference),
        canvas_kernel=numpy_fn(striped_pillar_canvas),
        stripe_pad_sorted=stripe_pad_sorted, bf16_rows=bf16_rows,
        warp_gather=numpy_fn(warp_affine_nhwc),
        warp_mxu=numpy_fn(warp_affine_mxu),
        warp_gather_vjp=warp_vjp(warp_affine_nhwc),
        warp_mxu_vjp=warp_vjp(warp_affine_mxu))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _deform_inputs(seed, b=2, h=12, w=16, cin=8, cout=4, scale=2.0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    off = (rng.randn(b, h, w, 18) * scale).astype(np.float32)
    wt = (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32)
    return x, off, wt


# ---------------------------------------------------------------- K1
@pytest.mark.parametrize("seed,shape", [
    (0, (2, 12, 16, 8, 4)),
    (1, (1, 9, 7, 5, 3)),     # odd sizes, a band taller than the map
    (2, (2, 14, 20, 16, 8)),
])
def test_deform_plain_matches_jax(jx, seed, shape):
    b, h, w, cin, cout = shape
    x, off, wt = _deform_inputs(seed, b, h, w, cin, cout)
    off = np.clip(off, -MAX_OFFSET, MAX_OFFSET)
    got = deform_conv3x3_plain(torch.from_numpy(x), torch.from_numpy(off),
                               torch.from_numpy(wt)).numpy()
    want_mxu = jx.deform_mxu(x, off, wt)
    want_gather = jx.deform_gather(x, off, wt)
    # fp32, sums of 9*Cin products in another order: 1e-4
    np.testing.assert_allclose(got, want_gather, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want_mxu, rtol=1e-4, atol=1e-4)


def test_deform_clamps_offsets_beyond_the_limit(jx):
    x, off, wt = _deform_inputs(5, scale=20.0)
    bias = np.linspace(-1, 1, wt.shape[-1]).astype(np.float32)
    got = deform_conv3x3_clamped(torch.from_numpy(x), torch.from_numpy(off),
                                 torch.from_numpy(wt),
                                 torch.from_numpy(bias)).numpy()
    want = jx.deform_auto(x, off, wt, bias)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_deform_wrapper_takes_plain_version_on_cpu():
    x, off, wt = (torch.from_numpy(a) for a in _deform_inputs(3))
    before = LAUNCHES["deform_conv3x3"]
    assert torch.equal(deform_conv3x3(x, off, wt),
                       deform_conv3x3_plain(x, off, wt))
    assert LAUNCHES["deform_conv3x3"] == before


@pytest.mark.cuda
def test_deform_kernel_matches_plain_on_card(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, off, wt = (torch.from_numpy(a).to(cuda)
                  for a in _deform_inputs(4, 2, 20, 36, 40, 70, scale=3.0))
    off = off.clamp(-MAX_OFFSET, MAX_OFFSET)
    got = deform_conv3x3(x, off, wt)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(),
                               deform_conv3x3_plain(x, off, wt).cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


# K1 / K1b pick a kernel route from the channel counts, in Python
@pytest.mark.parametrize("cin,cout,backward,route", [
    (128, 64, False, "mma"), (128, 64, True, "mma"), (32, 64, True, "mma"),
    (256, 64, False, "mma"), (40, 70, False, "general"),
    (40, 70, True, "general"), (128, 32, True, "general"),
    (48, 64, False, "general"), (6, 5, True, "general"),
])
def test_deform_route_follows_channel_counts(cin, cout, backward, route):
    assert kernel_route(cin, cout, backward) == route


def test_deform_backward_refuses_channel_counts_no_route_takes():
    # Cout 256 keeps the tensor-core route out, and the general route's
    # input pass would need 633 KB of shared memory
    with pytest.raises(ValueError, match="no kernel route takes Cin 512"):
        kernel_route(512, 256, backward=True)
    assert kernel_route(512, 256) == "general"  # the forward has no such limit
    assert kernel_route(512, 64, backward=True) == "mma"


@pytest.mark.parametrize("route,npix,cin,cout,sms,nsplit,floats", [
    # 512 tiles of 64 pixels, 4 channel slices x 3 tap rows, 3 blocks an SM
    ("mma", 4 * 64 * 128, 128, 64, 132, 33,
     33 * 9 * 128 * 64 + 4 * 32768 * 18),
    ("mma", 100, 32, 64, 132, 2, 2 * 9 * 32 * 64 + 100 * 18),
    ("mma", 4 * 64 * 64, 128, 64, 8, 2, 2 * 9 * 128 * 64 + 4 * 16384 * 18),
    ("general", 4 * 64 * 128, 40, 70, 132, 16, 16 * 9 * 40 * 70),
    ("general", 99, 6, 5, 132, 1, 9 * 6 * 5),
])
def test_deform_backward_scratch_sizes(route, npix, cin, cout, sms, nsplit,
                                       floats):
    assert backward_scratch(route, npix, cin, cout, sms) == (nsplit, floats)


def _tf32_cut(a):
    """fp32 cut to tf32 (sign, exponent, 10 mantissa bits), as the tensor
    core reads an operand."""
    return (a.view(torch.int32) & -8192).view(torch.float32)


def test_3xtf32_split_holds_k1_tolerance_at_depth_1152():
    """The split of csrc/deform_common.cuh emulated in PyTorch: hi = a cut
    to tf32, lo = a - hi cut again; lo*hi + hi*lo + hi*hi with fp32 sums.
    At K1's depth (9 x 128) it stays inside K1's tolerance, where one TF32
    product does not come close."""
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(256, 1152).astype(np.float32))
    b = torch.from_numpy((rng.randn(1152, 64) * 0.1).astype(np.float32))
    want = a.double() @ b.double()
    a_hi, b_hi = _tf32_cut(a), _tf32_cut(b)
    a_lo, b_lo = _tf32_cut(a - a_hi), _tf32_cut(b - b_hi)
    assert torch.equal(a_hi + (a - a_hi), a)  # the remainder is exact
    got = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    err3 = float((got.double() - want).abs().max())
    err1 = float(((a_hi @ b_hi).double() - want).abs().max())
    assert err3 <= 0.1 * tol
    assert err1 > 20 * err3


# the shapes the port's paths give K1 and K1b (the tensor-core route) and
# one ragged shape (the general route)
DEFORM_CARD_SHAPES = [(2, 64, 128, 128, 64), (4, 64, 128, 128, 64),
                      (2, 64, 64, 128, 64), (4, 64, 64, 128, 64),
                      (1, 13, 21, 24, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DEFORM_CARD_SHAPES)
def test_deform_kernel_matches_plain_at_path_shapes_on_card(cuda, shape):
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, w, cin, cout = shape
    x, off, wt = (torch.from_numpy(a).to(cuda)
                  for a in _deform_inputs(6, b, h, w, cin, cout, scale=2.0))
    off = off.clamp(-MAX_OFFSET, MAX_OFFSET)
    route = kernel_route(cin, cout)
    before = ROUTE_LAUNCHES["deform_conv3x3"][route]
    got = deform_conv3x3(x, off, wt)
    torch.cuda.synchronize()
    assert ROUTE_LAUNCHES["deform_conv3x3"][route] == before + 1
    # fp32 sums of 9 * Cin products in another order (3xTF32 keeps fp32
    # level): 1e-4 of the largest value
    _close(got.cpu().numpy(), deform_conv3x3_plain(x, off, wt).cpu().numpy(),
           1e-4, "out")


# K1's bf16 instantiation (half=True): the eval paths' maps, both routes,
# and maps whose W is no multiple of the 64-pixel tile on the tensor-core
# route (tiles that cross rows and images)
DEFORM_BF16_CARD_SHAPES = [(2, 64, 128, 128, 64), (2, 64, 64, 128, 64),
                           (1, 13, 21, 24, 10), (2, 20, 36, 40, 70),
                           (2, 20, 36, 64, 64), (1, 9, 100, 32, 64)]


def _deform_bf16_checks(x, off, wt, route):
    """K1 bf16 on the card: the launch counts, two launches bit-equal,
    within one bf16 step of the fp32 kernel's rounded output, and within the
    plain version's tolerance."""
    before = (LAUNCHES["deform_conv3x3_bf16"],
              HALF_ROUTE_LAUNCHES["deform_conv3x3_bf16"][route])
    got = deform_conv3x3(x, off, wt)
    again = deform_conv3x3(x, off, wt)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert (LAUNCHES["deform_conv3x3_bf16"],
            HALF_ROUTE_LAUNCHES["deform_conv3x3_bf16"][route]) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(got, again)
    # the tensor-core route's split bf16 product sums in another order than
    # the fp32 kernel: a rounded output may land one bf16 step away
    ref = deform_conv3x3(x.float(), off, wt).to(torch.bfloat16)
    assert bf16_steps_apart(got, ref)[1] == 0
    # against the plain version: fp32 sums in another order (1e-4), then
    # one rounding each, which may land one bf16 step (2^-7 of the largest
    # value) apart
    want = deform_conv3x3_plain(x, off, wt).float().cpu().numpy()
    _close(got.float().cpu().numpy(), want, 1e-4 + 2.0 ** -7, "out")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DEFORM_BF16_CARD_SHAPES)
def test_deform_bf16_kernel_matches_plain_on_card(cuda, shape):
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, w, cin, cout = shape
    x, off, wt = (torch.from_numpy(a).to(cuda)
                  for a in _deform_inputs(8, b, h, w, cin, cout, scale=3.0))
    x, off = x.to(torch.bfloat16), off.clamp(-MAX_OFFSET, MAX_OFFSET)
    _deform_bf16_checks(x, off, wt, kernel_route(cin, cout))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 24, 40, 128, 64), (1, 12, 70, 32, 64)])
def test_deform_bf16_kernel_far_offsets_on_card(cuda, shape):
    """Offsets up to +-12, not clamped: taps leave the staged band and the
    map on all four sides."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, w, cin, cout = shape
    x, off, wt = (torch.from_numpy(a).to(cuda)
                  for a in _deform_inputs(10, b, h, w, cin, cout, scale=6.0))
    x, off = x.to(torch.bfloat16), off.clamp(-12.0, 12.0)
    assert float(off.min()) < -10 and float(off.max()) > 10
    _deform_bf16_checks(x, off, wt, kernel_route(cin, cout))


@pytest.mark.cuda
def test_deform_bf16_backward_is_refused_on_card(cuda):
    x, off, wt = (torch.from_numpy(a).to(cuda)
                  for a in _deform_inputs(9, 1, 8, 8, 32, 64))
    g = torch.zeros(1, 8, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="x must be torch.float32"):
        deform_conv3x3_bwd(x.to(torch.bfloat16), off, wt, g)
    with pytest.raises(ValueError, match="g must be torch.float32"):
        deform_conv3x3_bwd(x, off, wt, g.to(torch.bfloat16))
    with pytest.raises(ValueError, match="x must be torch.float32 or"):
        deform_conv3x3(x.half(), off, wt)


# ---------------------------------------------------------------- K2
def _canvas_rows(seed, a=3, p=2000, c=64, ncell=64 * 64):
    """Decorator-like rows: sorted gids per agent, invalid rows (gid ncell,
    zero features) last, non-negative bf16-representable features."""
    rng = np.random.default_rng(seed)
    feats, gids, valid = [], [], []
    for _ in range(a):
        n_real = int(rng.integers(p // 4, p))
        cells = np.sort(rng.choice(ncell, size=300, replace=False))
        g = np.full(p, ncell, np.int32)
        g[:n_real] = np.sort(rng.choice(cells, size=n_real))
        v = np.arange(p) < n_real
        f = np.abs(rng.normal(size=(p, c))).astype(np.float32)
        f[~v] = 0
        feats.append(f), gids.append(g), valid.append(v)
    return np.stack(feats), np.stack(gids), np.stack(valid)


def _bits(t):
    return t.contiguous().view(torch.int16).numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_canvas_plain_bit_exact_vs_jax(jx, seed):
    a, c, ncell = 3, 64, 64 * 64
    feats, gids, valid = _canvas_rows(seed, a=a, c=c, ncell=ncell)
    rows16 = torch.from_numpy(feats.reshape(-1, c)).to(torch.bfloat16)
    flat_gids = np.minimum(gids.reshape(-1), ncell - 1).astype(np.int32)
    got = pillar_canvas_plain(rows16, torch.from_numpy(flat_gids), a, ncell)

    ref = jx.canvas_reference(jx.bf16_rows(feats.reshape(-1, c)), flat_gids,
                              a, ncell)
    ref = torch.from_numpy(ref).to(torch.bfloat16)
    np.testing.assert_array_equal(_bits(got), _bits(ref))

    # the TPU kernel, on the stripe-padded copy of the same rows
    t, r = 256, 128
    fs, gs, vs = jx.stripe_pad_sorted(feats, gids, valid, ncell, t, r)
    xs = jx.bf16_rows(np.where(vs[..., None], fs, 0).reshape(-1, c))
    kern = jx.canvas_kernel(xs, gs.reshape(-1), a, ncell, t, r,
                            interpret=True)
    kern = torch.from_numpy(kern).to(torch.bfloat16)
    np.testing.assert_array_equal(_bits(got), _bits(kern))
    assert int((got.float() > 0).any(-1).sum()) > 0


def test_canvas_wrapper_takes_plain_version_on_cpu():
    feats, gids, _ = _canvas_rows(2, a=2, c=8, ncell=4096)
    rows = torch.from_numpy(feats.reshape(-1, 8)).to(torch.bfloat16)
    g = torch.from_numpy(gids.reshape(-1))
    before = LAUNCHES["pillar_canvas"]
    assert torch.equal(pillar_canvas(rows, g, 2, 4096),
                       pillar_canvas_plain(rows, g, 2, 4096))
    assert LAUNCHES["pillar_canvas"] == before


@pytest.mark.cuda
def test_canvas_kernel_bit_exact_on_card(cuda):
    a, c, ncell = 3, 64, 64 * 64
    feats, gids, _ = _canvas_rows(7, a=a, c=c, ncell=ncell)
    rows = torch.from_numpy(feats.reshape(-1, c)).to(cuda, torch.bfloat16)
    g = torch.from_numpy(gids.reshape(-1)).to(cuda)
    got = pillar_canvas(rows, g, a, ncell)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(_bits(got.cpu()),
                                  _bits(pillar_canvas_plain(rows, g, a, ncell).cpu()))


def canvas_edge_case(kind, c=64, ncell=5000):
    """(rows bf16, raw gids int32, agents, ncell) of a layout at K2's edges:
    runs over many 32-row chunks and across agents, an empty agent, empty
    ranges of cells at both ends (and at the edges of the 256-cell tiles,
    2048-cell clusters of the tile variant in ``csrc/variants``), -0.0
    rows, raw ids. Gids are sorted within each agent and not clamped."""
    rng = np.random.default_rng(["one_cell", "invalid_tail", "empty_agent",
                                 "gaps", "split_runs", "negative_zero",
                                 "raw_ids"].index(kind))
    a, p = 2, 3000

    def spread(n, lo=0, hi=ncell):
        return np.sort(rng.integers(lo, hi, n)).astype(np.int32)

    feats = np.abs(rng.normal(size=(a, p, c))).astype(np.float32)
    gids = np.stack([spread(p) for _ in range(a)])
    if kind == "one_cell":        # every row of agent 0 in one cell
        gids[0] = 700
    elif kind == "invalid_tail":  # agent 1: 10,000 zeroed rows clamped last
        p = 12000
        feats = np.abs(rng.normal(size=(a, p, c))).astype(np.float32)
        gids = np.stack([spread(p), np.full(p, ncell, np.int32)])
        gids[1, :2000] = spread(2000)
        feats[1, 2000:] = 0.0
    elif kind == "empty_agent":   # agent 1 holds only invalid rows
        gids[1] = ncell
        feats[1] = 0.0
    elif kind == "gaps":          # no rows in the first and last clusters
        gids = np.stack([spread(p, 2100, 3900) for _ in range(a)])
    elif kind == "split_runs":    # long runs at tile and cluster edges
        cells = np.repeat([255, 256, 2047, 2048, 4095], [700, 40, 1500, 33, 727])
        gids = np.stack([cells.astype(np.int32)] * a)
    elif kind == "negative_zero":  # -0.0 and negative rows, whole cells of them
        feats = rng.normal(size=(a, p, c)).astype(np.float32)
        feats[:, ::3] = -0.0
        feats[:, :400] = -0.0
        gids[:, :400] = np.arange(400, dtype=np.int32)[None] // 7
        feats[:, 400:] = np.where(gids[:, 400:, None] % 5 == 0, -0.0,
                                  feats[:, 400:])
    elif kind == "raw_ids":       # ids below 0 and from ncell up, not zeroed
        gids[:, :50] = np.arange(-50, 0, dtype=np.int32)[None]
        gids[:, -60:] = ncell + np.arange(60, dtype=np.int32)[None]
    rows = torch.from_numpy(feats.reshape(-1, c)).to(torch.bfloat16)
    return rows, torch.from_numpy(gids.reshape(-1).copy()), a, ncell


@pytest.mark.parametrize("kind", ["one_cell", "invalid_tail", "empty_agent",
                                  "gaps", "split_runs", "negative_zero",
                                  "raw_ids"])
def test_canvas_edge_cases_are_sorted_and_sized(kind):
    """The layouts the card cases below hand K2: gids sorted within each
    agent (the kernel's contract), raw ids where the case needs them."""
    rows, gids, a, ncell = canvas_edge_case(kind)
    per = gids.view(a, -1)
    assert rows.shape[0] == gids.shape[0] and rows.shape[0] % a == 0
    assert bool((per[:, 1:] >= per[:, :-1]).all())
    assert (int(gids.min()) < 0) == (kind == "raw_ids")
    canvas = pillar_canvas_plain(rows, gids, a, ncell)
    assert canvas.shape == (a, ncell, rows.shape[1])
    assert not bool((canvas.float() < 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["one_cell", "invalid_tail", "empty_agent",
                                  "gaps", "split_runs", "negative_zero",
                                  "raw_ids"])
def test_canvas_kernel_edge_layouts_bit_exact_on_card(cuda, kind):
    rows, gids, a, ncell = canvas_edge_case(kind)
    rows, gids = rows.to(cuda), gids.to(cuda)
    got = pillar_canvas(rows, gids, a, ncell)
    again = pillar_canvas(rows, gids, a, ncell)
    torch.cuda.synchronize()
    want = pillar_canvas_plain(rows, gids, a, ncell)
    np.testing.assert_array_equal(_bits(got.cpu()), _bits(want.cpu()))
    np.testing.assert_array_equal(_bits(again.cpu()), _bits(want.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 6])
def test_canvas_kernel_without_rows_writes_zeros_on_card(cuda, c):
    rows = torch.zeros(0, c, dtype=torch.bfloat16, device=cuda)
    gids = torch.zeros(0, dtype=torch.int32, device=cuda)
    got = pillar_canvas(rows, gids, 2, 1000)
    torch.cuda.synchronize()
    assert got.shape == (2, 1000, c) and not bool(got.view(torch.int16).any())


# ---------------------------------------------------------------- K3
@pytest.mark.parametrize("h,w,c", [(16, 24, 8), (12, 16, 3), (9, 20, 4)])
def test_warp_plain_matches_jax(jx, h, w, c):
    n = len(THETAS)
    src = np.random.RandomState(h * w + c).randn(n, h, w, c).astype(np.float32)
    got = warp_affine_plain(torch.from_numpy(src),
                            torch.from_numpy(THETAS)).numpy()
    want_gather = jx.warp_gather(src, THETAS)
    want_mxu = jx.warp_mxu(src, THETAS)
    # fp32 bilinear blends of 4 corners; the gather rounds like the port,
    # the MXU kernel sums a whole row of triangle weights: 1e-5 / 1e-4
    np.testing.assert_allclose(got, want_gather, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_mxu, rtol=1e-4, atol=1e-4)
    assert np.all(got[-1] == 0)  # the last theta samples only outside


def test_warp_wrapper_takes_plain_version_on_cpu():
    src = torch.randn(len(THETAS), 8, 8, 4, generator=torch.Generator().manual_seed(0))
    th = torch.from_numpy(THETAS)
    before = LAUNCHES["warp_affine"]
    assert torch.equal(warp_affine(src, th), warp_affine_plain(src, th))
    assert LAUNCHES["warp_affine"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("c", [128, 6])
def test_warp_kernel_matches_plain_on_card(cuda, c):
    src = torch.from_numpy(np.random.RandomState(c).randn(
        len(THETAS), 32, 48, c).astype(np.float32)).to(cuda)
    th = torch.from_numpy(THETAS).to(cuda)
    got = warp_affine(src, th)
    torch.cuda.synchronize()
    # on the card the plain version's scalar divisions round the sampling
    # coordinate (up to 48 px) differently in the last bit; the blend then
    # moves by up to one coordinate ulp times the largest neighbour step
    tol = 4.0 * 48 * 2.0 ** -23 * float(src.abs().max())
    np.testing.assert_allclose(got.cpu().numpy(),
                               warp_affine_plain(src, th).cpu().numpy(),
                               rtol=0, atol=tol)


# K3's bf16 instantiation (half=True): the eval paths' maps, one image, a
# W no multiple of the row kernel's 32 pixels with 3 vectors a pixel, and
# the scalar path (channels no multiple of 8)
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 128, 128), (2, 64, 64, 128),
                                   (1, 64, 128, 128), (3, 20, 37, 24),
                                   (len(THETAS), 32, 48, 6), (2, 9, 13, 12)])
def test_warp_bf16_kernel_matches_plain_on_card(cuda, shape):
    n = shape[0]
    src = torch.from_numpy(np.random.RandomState(shape[-1]).randn(
        *shape).astype(np.float32)).to(cuda, torch.bfloat16)
    th = torch.from_numpy(np.resize(THETAS, (n, 2, 3))).to(cuda)
    before = LAUNCHES["warp_affine_bf16"]
    got = warp_affine(src, th)
    again = warp_affine(src, th)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert LAUNCHES["warp_affine_bf16"] == before + 2
    assert torch.equal(got, again)
    # the fp32 kernel's coordinate chain and blend on the widened map,
    # rounded once: bit for bit
    assert torch.equal(got, warp_affine(src.float(), th).to(torch.bfloat16))
    # against the plain version: the fp32 tolerance of
    # test_warp_kernel_matches_plain_on_card, then one rounding each (one
    # bf16 step of the largest value)
    scale = float(src.float().abs().max())
    tol = 4.0 * max(shape[1:3]) * 2.0 ** -23 * scale + 2.0 ** -7 * scale
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        warp_affine_plain(src, th).float().cpu().numpy(), rtol=0, atol=tol)


@pytest.mark.cuda
def test_warp_bf16_backward_is_refused_on_card(cuda):
    g = torch.zeros(len(THETAS), 8, 8, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="g must be torch.float32"):
        warp_affine_bwd(g, torch.from_numpy(THETAS).to(cuda))


# K3's routes and its pair launch
@pytest.mark.parametrize("c,aligned,route", [
    (1, True, "pixel"), (2, True, "pixel"), (3, False, "pixel"),
    (4, True, "rows"), (4, False, "pixel"), (5, True, "scalar"),
    (8, True, "rows"), (8, False, "scalar"), (17, True, "scalar"),
    (64, True, "rows"), (65, True, "scalar"), (128, True, "rows"),
    (128, False, "scalar"), (256, True, "rows"), (257, True, "scalar")])
def test_warp_forward_route_follows_width_and_alignment(c, aligned, route):
    """K3's route (csrc/warp_affine.cu:plan_for, mirrored for the counts):
    16-byte vectors where C is a multiple of 4 and the maps are aligned, a
    thread a pixel up to FORWARD_PIXEL_MAX_CHANNELS channels otherwise,
    single channels over lanes beyond."""
    assert forward_route(c, aligned) == route
    assert FORWARD_PIXEL_MAX_CHANNELS == 4


@pytest.mark.parametrize("c,vector,route", [(8, 8, "rows"), (4, 8, "pixel"),
                                            (12, 8, "scalar"), (24, 8, "rows"),
                                            (20, 8, "scalar")])
def test_warp_forward_route_of_bf16_maps(c, vector, route):
    """bf16 maps take 8-channel vectors on the rows route."""
    assert forward_route(c, True, vector) == route


def _pair_inputs(seed, n=len(THETAS), h=12, w=20, c=6, cs=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, h, w, c).astype(np.float32),
            rng.uniform(0.05, 1.0, (n, h, w, cs)).astype(np.float32),
            np.resize(THETAS, (n, 2, 3)))


@pytest.mark.parametrize("c,cs", [(6, 1), (8, 1), (5, 2)])
def test_warp_pair_on_cpu_equals_two_warps_and_jax(jx, c, cs):
    """warp_affine_pair on the CPU: the plain version twice, bit for bit,
    no kernel launch, and JAX's gather warp of the two concatenated (the
    JAX pyramid's form) within the 1e-5 of test_warp_plain_matches_jax."""
    feat, score, th = _pair_inputs(c + cs, c=c, cs=cs)
    tf, ts, tt = (torch.from_numpy(a) for a in (feat, score, th))
    before = LAUNCHES["warp_affine"]
    got, got_s = warp_affine_pair(tf, ts, tt)
    assert LAUNCHES["warp_affine"] == before
    assert torch.equal(got, warp_affine_plain(tf, tt))
    assert torch.equal(got_s, warp_affine_plain(ts, tt))
    want = jx.warp_gather(np.concatenate([feat, score], -1), th)
    np.testing.assert_allclose(got.numpy(), want[..., :c], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), want[..., c:], rtol=1e-5,
                               atol=1e-5)


def test_warp_pair_gradients_on_cpu_equal_two_warps():
    """The pair's backward is the two maps' own: K3b (its plain version
    here) on each cotangent, bit for bit; theta gets none."""
    feat, score, th = _pair_inputs(3)
    tt = torch.from_numpy(th)
    f1, s1 = (torch.from_numpy(a).requires_grad_(True) for a in (feat, score))
    f2, s2 = (torch.from_numpy(a).requires_grad_(True) for a in (feat, score))
    r = torch.from_numpy(np.random.RandomState(4).randn(*feat.shape)
                         .astype(np.float32))
    a, b = warp_affine_pair(f1, s1, tt)
    ((a * r).sum() + (b * 3.0).sum()).backward()
    ((warp_affine(f2, tt) * r).sum() + (warp_affine(s2, tt) * 3.0).sum()
     ).backward()
    assert torch.equal(f1.grad, f2.grad) and torch.equal(s1.grad, s2.grad)
    with pytest.raises(ValueError, match="no gradient"):
        warp_affine_pair(f1, s1, tt.clone().requires_grad_(True))


def _offset(t):
    """A contiguous copy of ``t`` 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _warp_tol(src):
    # test_warp_kernel_matches_plain_on_card's tolerance
    return 4.0 * max(src.shape[1:3]) * 2.0 ** -23 * float(src.abs().max())


def _warp_on_card(src, th, route):
    before = dict(FORWARD_ROUTE_LAUNCHES)
    got = warp_affine(src, th)
    torch.cuda.synchronize()
    assert FORWARD_ROUTE_LAUNCHES[route] == before[route] + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 8, 64, 65, 128, 256])
def test_warp_routes_match_plain_on_card(cuda, c, offset):
    """Every route of K3 against its plain version: the width picks it, a
    view 4 bytes off a 16-byte boundary takes it off rows; W = 37 is no
    multiple of a block's run of pixels on any route."""
    src = torch.from_numpy(np.random.RandomState(c).randn(
        len(THETAS), 24, 37, c).astype(np.float32)).to(cuda)
    if offset:
        src = _offset(src)
    assert (src.data_ptr() % 16 == 0) != offset
    th = torch.from_numpy(THETAS).to(cuda)
    route = forward_route(c, not offset)
    got = _warp_on_card(src, th, route)
    np.testing.assert_allclose(got.cpu().numpy(),
                               warp_affine_plain(src, th).cpu().numpy(),
                               rtol=0, atol=_warp_tol(src))
    assert torch.equal(got, warp_affine(src, th))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 8, 12, 16, 64, 128, 256])
def test_warp_rows_route_bit_equal_to_the_others_on_card(cuda, c):
    """The rows route and the one the same map takes 4 bytes off a 16-byte
    boundary (pixel up to FORWARD_PIXEL_MAX_CHANNELS channels, scalar
    beyond): the same bits."""
    src = torch.from_numpy(np.random.RandomState(c + 7).randn(
        len(THETAS), 20, 29, c).astype(np.float32)).to(cuda)
    th = torch.from_numpy(THETAS).to(cuda)
    rows = _warp_on_card(src, th, "rows")
    other = _warp_on_card(_offset(src), th, forward_route(c, False))
    assert torch.equal(rows, other)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(0, 8, 8, 64), (2, 0, 8, 64), (2, 8, 0, 64),
                                   (0, 8, 8, 1), (2, 8, 0, 1)])
def test_warp_empty_maps_on_card(cuda, shape):
    """A map with no pixel launches nothing and returns an empty map."""
    src = torch.zeros(shape, device=cuda)
    th = torch.from_numpy(np.resize(THETAS, (shape[0], 2, 3))).to(cuda)
    got = warp_affine(src, th)
    torch.cuda.synchronize()
    assert got.shape == shape
    if shape[0]:
        g, gs = warp_affine_pair(src, src[..., :1].contiguous(), th)
        torch.cuda.synchronize()
        assert g.shape == shape and gs.shape == shape[:3] + (1,)


@pytest.mark.cuda
@pytest.mark.parametrize("c,cs,offset", [
    (64, 1, False), (128, 1, False), (256, 1, False), (5, 2, False),
    (128, 3, True), (1, 1, False)])
def test_warp_pair_bit_equal_to_two_launches_on_card(cuda, c, cs, offset):
    """One pair launch against the two maps' own launches: the same bits,
    one K3 launch, counted on the first map's route; the backward is their
    two K3b launches."""
    feat, score, th = _pair_inputs(c * 10 + cs, h=24, w=37, c=c, cs=cs)
    feat, score, th = (torch.from_numpy(a).to(cuda)
                       for a in (feat, score, th))
    if offset:
        feat = _offset(feat)
    route = forward_route(c, not offset)
    before, routes = LAUNCHES["warp_affine"], dict(FORWARD_ROUTE_LAUNCHES)
    got, got_s = warp_affine_pair(feat, score, th)
    torch.cuda.synchronize()
    assert LAUNCHES["warp_affine"] == before + 1
    assert FORWARD_ROUTE_LAUNCHES[route] == routes[route] + 1
    assert torch.equal(got, warp_affine(feat, th))
    assert torch.equal(got_s, warp_affine(score, th))
    f1, s1 = (t.clone().requires_grad_(True) for t in (feat, score))
    before = LAUNCHES["warp_affine_bwd"]
    a, b = warp_affine_pair(f1, s1, th)
    (a.sum() + (b * 2.0).sum()).backward()
    assert LAUNCHES["warp_affine_bwd"] == before + 2
    assert torch.equal(f1.grad, warp_affine_bwd(torch.ones_like(feat), th))
    assert torch.equal(s1.grad, warp_affine_bwd(
        torch.full_like(score, 2.0), th))


@pytest.mark.cuda
def test_warp_pair_refuses_mismatched_maps_on_card(cuda):
    th = torch.from_numpy(THETAS).to(cuda)
    feat = torch.zeros(len(THETAS), 8, 8, 4, device=cuda)
    with pytest.raises(ValueError, match="one N, H, W"):
        warp_affine_pair(feat, torch.zeros(len(THETAS), 8, 9, 1,
                                           device=cuda), th)
    with pytest.raises(ValueError, match="score must be torch.float32"):
        warp_affine_pair(feat, torch.zeros(len(THETAS), 8, 8, 1, device=cuda,
                                           dtype=torch.bfloat16), th)


# ---------------------------------------------------------------- backward
def deform_case(kind, seed=0, b=2, h=12, w=16, cin=8, cout=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    wt = (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32)
    g = rng.randn(b, h, w, cout).astype(np.float32)
    if kind == "integer":
        # saturated and integer offsets: every sample sits on a pixel, where
        # the floor convention is one-sided
        off = rng.choice([-4.0, -2.0, -1.0, 0.0, 1.0, 3.0, 4.0],
                         size=(b, h, w, 18)).astype(np.float32)
    else:
        off = np.clip(rng.randn(b, h, w, 18) * 2.0, -MAX_OFFSET, MAX_OFFSET)
        off = off.astype(np.float32)
        off.reshape(-1)[::7] = MAX_OFFSET  # some exactly on the bound
        off.reshape(-1)[3::11] = -MAX_OFFSET
    return x, off, wt, g


def canvas_case(seed, a=3, p=700, c=8, ncell=64):
    """Sorted rows per agent with constructed ties: runs of 1..5 rows where
    channels 0-3 tie at the run's max (2 and 3 rows among them), all-zero
    runs, one run of 300 tied rows (its count stops at 256 in bf16), and
    the zeroed invalid tail clamped into the last cell (long in agent 0,
    where that cell is otherwise empty; agent 1 holds a positive row
    there)."""
    rng = np.random.default_rng(seed)
    feats = np.zeros((a, p, c), np.float32)
    gids = np.full((a, p), ncell, np.int32)
    for ai in range(a):
        r, cell = 0, 0
        tail = 350 if ai == 0 else 60
        while r < p - tail and cell < ncell - 1:
            n = 300 if (ai == 2 and cell == 5) else int(rng.integers(1, 6))
            n = min(n, p - tail - r)
            vals = np.abs(rng.normal(size=(n, c))).astype(np.float32)
            kind = rng.integers(0, 4)
            if kind == 0:
                vals[:] = 0.0                       # an all-zero cell
            elif kind >= 2:
                vals[:, :4] = vals[0, :4]           # ties on channels 0-3
            feats[ai, r:r + n] = vals
            gids[ai, r:r + n] = cell
            r += n
            cell += int(rng.integers(1, 3))
        if ai == 1:
            gids[ai, r] = ncell - 1
            feats[ai, r] = 1.5
    rows = torch.from_numpy(feats.reshape(-1, c)).to(torch.bfloat16)
    flat = np.minimum(gids.reshape(-1), ncell - 1).astype(np.int32)
    gout = torch.from_numpy(rng.normal(size=(a, ncell, c)).astype(
        np.float32)).to(torch.bfloat16)
    return rows, torch.from_numpy(flat), gout


def _close(got, want, tol, what=""):
    """|got - want| <= tol * max(1, max|want|) elementwise."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 20, 36, 40, 70), (1, 9, 11, 6, 5)])
def test_deform_bwd_kernel_matches_plain_on_card(cuda, shape):
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, w, cin, cout = shape
    x, off, wt, g = (_t(a).to(cuda) for a in deform_case(
        "fractional", 5, b, h, w, cin, cout))
    got = deform_conv3x3_bwd(x, off, wt, g)
    torch.cuda.synchronize()
    want = deform_conv3x3_bwd_plain(x, off, wt, g)
    for name, gv, wv in zip(("dx", "doff", "dweight"), got, want):
        _close(gv.cpu().numpy(), wv.cpu().numpy(), 1e-4, name)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DEFORM_CARD_SHAPES)
def test_deform_bwd_kernel_far_offsets_at_path_shapes_on_card(cuda, shape):
    """Offsets up to +-9 (the kernel does not clip): every in-map corner is
    added wherever it lies, none is dropped."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, w, cin, cout = shape
    x, _, wt, g = deform_case("fractional", 7, b, h, w, cin, cout)
    off = np.clip(np.random.RandomState(8).randn(b, h, w, 18) * 3.0, -9, 9)
    assert (np.abs(off) > MAX_OFFSET).mean() > 0.1
    x, off, wt, g = (_t(a).to(cuda) for a in (x, off.astype(np.float32), wt, g))
    route = kernel_route(cin, cout, backward=True)
    before = ROUTE_LAUNCHES["deform_conv3x3_bwd"][route]
    got = deform_conv3x3_bwd(x, off, wt, g)
    torch.cuda.synchronize()
    assert ROUTE_LAUNCHES["deform_conv3x3_bwd"][route] == before + 1
    want = deform_conv3x3_bwd_plain(x, off, wt, g)
    for name, gv, wv in zip(("dx", "doff", "dweight"), got, want):
        _close(gv.cpu().numpy(), wv.cpu().numpy(), 1e-4, name)


@pytest.mark.cuda
def test_deform_bwd_dweight_and_doffsets_repeat_bit_for_bit_on_card(cuda):
    x, off, wt, g = (_t(a).to(cuda) for a in deform_case(
        "fractional", 9, 4, 64, 64, 128, 64))
    first = deform_conv3x3_bwd(x, off, wt, g)
    second = deform_conv3x3_bwd(x, off, wt, g)
    torch.cuda.synchronize()
    assert torch.equal(first[2], second[2])  # partials added in a fixed order
    assert torch.equal(first[1], second[1])  # plain stores, then a fixed order


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_canvas_bwd_kernel_bit_exact_on_card(cuda, seed):
    a, ncell = 3, 64
    rows, gids, gout = (t.to(cuda) for t in canvas_case(seed, a=a,
                                                         ncell=ncell))
    canvas = pillar_canvas_plain(rows, gids, a, ncell)
    got = pillar_canvas_bwd(rows, gids, canvas, gout, a, ncell)
    torch.cuda.synchronize()
    want = pillar_canvas_bwd_plain(rows, gids, canvas, gout, a, ncell)
    np.testing.assert_array_equal(_bits(got.cpu()), _bits(want.cpu()))


# K2b picks a kernel route from the channel count, in Python
@pytest.mark.parametrize("channels,m,cells,route", [
    (64, 120000, 4 * 131072, "rows64"), (64, 0, 0, "rows64"),
    (8, 2100, 192, "general"), (6, 3000, 600, "general"),
    (128, 120000, 4 * 131072, "general"),
    (64, 2 ** 31, 1000, "general"),   # rows64 indexes rows and cells by int32
    (64, 1000, 2 ** 31, "general"),
])
def test_canvas_bwd_route_follows_channels_and_sizes(channels, m, cells, route):
    assert backward_route(channels, m, cells) == route


@pytest.mark.parametrize("route,m,c,ints", [
    # 3750 chunks of 32 rows: 64 tie counters each, and 2 ints of mark
    ("rows64", 120000, 64, 3750 * 66),
    ("rows64", 33, 64, 2 * 66),
    ("general", 120000, 64, 3750 * 64),
    ("general", 2100, 6, 66 * 6),
])
def test_canvas_bwd_scratch_sizes(route, m, c, ints):
    assert pillar_canvas_ops.backward_scratch(route, m, c) == ints


def _canvas_bwd_bit_exact_on(cuda, rows, gids, gout, a, ncell, route):
    rows, gids, gout = (t.to(cuda) for t in (rows, gids, gout))
    canvas = pillar_canvas_plain(rows, gids, a, ncell)
    before = pillar_canvas_ops.ROUTE_LAUNCHES[route]
    got = pillar_canvas_bwd(rows, gids, canvas, gout, a, ncell)
    torch.cuda.synchronize()
    assert pillar_canvas_ops.ROUTE_LAUNCHES[route] == before + 1
    want = pillar_canvas_bwd_plain(rows, gids, canvas, gout, a, ncell)
    np.testing.assert_array_equal(_bits(got.cpu()), _bits(want.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("seed,c,route", [(0, 64, "rows64"), (1, 64, "rows64"),
                                          (2, 6, "general")])
def test_canvas_bwd_routes_bit_exact_on_card(cuda, seed, c, route):
    """``canvas_case`` at 64 channels (the 300-row tied run fills several
    chunks, the 350-row zero tail passes the bf16 count limit, agents start
    at row 700, inside a chunk) and at an odd number of channel pairs."""
    rows, gids, gout = canvas_case(seed, a=3, c=c, ncell=64)
    _canvas_bwd_bit_exact_on(cuda, rows, gids, gout, 3, 64, route)


def canvas_runs_case(runs_per_agent, c, ncell, seed):
    """Rows of the given run lengths per agent (cell ids ascend from 7 in
    every agent, so a run that ends one agent and the run that starts the
    next share their gid); values from a few levels so that rows tie at the
    max; every third run is all zero."""
    rng = np.random.default_rng(seed)
    feats, gids = [], []
    for runs in runs_per_agent:
        for i, n in enumerate(runs):
            vals = rng.integers(0, 4, (n, c)).astype(np.float32) * 0.75
            if i % 3 == 2:
                vals[:] = 0.0
            feats.append(vals)
            gids.append(np.full(n, 7 + 2 * i, np.int32))
    rows = torch.from_numpy(np.concatenate(feats)).to(torch.bfloat16)
    gout = torch.from_numpy(rng.normal(size=(len(runs_per_agent), ncell, c))
                            .astype(np.float32)).to(torch.bfloat16)
    return rows, torch.from_numpy(np.concatenate(gids)), gout


@pytest.mark.cuda
@pytest.mark.parametrize("runs", [
    [[30, 66, 4], [3, 1, 1, 40, 55], [100]],
    [[4, 6], [10], [1] * 10, [3, 7], [2, 2, 6], [10], [9, 1]],
])
def test_canvas_bwd_runs_across_chunks_and_agents_on_card(cuda, runs):
    """100 rows an agent, so agents start inside a chunk. Agent 0: a run of
    66 rows from row 30 (three chunks, the middle one filled: counted
    through the slots) and a last run whose gid the next agent's first run
    shares; agent 1: a run of 40 rows over two chunks that fills neither
    (finished from the neighbour chunk's rows), then a run to the end. And
    10 rows an agent: several agents in one chunk."""
    rows, gids, gout = canvas_runs_case(runs, 64, 40, seed=3)
    assert rows.shape[0] == len(runs) * sum(runs[0])
    _canvas_bwd_bit_exact_on(cuda, rows, gids, gout, len(runs), 40, "rows64")


@pytest.mark.cuda
def test_canvas_bwd_bit_exact_at_the_train_step_size_on_card(cuda):
    """4 x 30,000 rows of 64 channels in 4 x 131,072 cells, with run lengths
    like the sampler's: 1.5 rows a run, and a clamped tail of thousands of
    zero rows in two of the agents."""
    rng = np.random.default_rng(11)
    a, p, c, ncell = 4, 30000, 64, 131072
    feats = np.zeros((a, p, c), np.float32)
    gids = np.full((a, p), ncell, np.int32)
    for ai, tail in enumerate((1, 7437, 0, 10831)):
        real = p - tail
        lengths = rng.geometric(1 / 1.5, size=real)
        lengths = lengths[np.cumsum(lengths) <= real]
        cells = np.sort(rng.choice(ncell - 1, size=lengths.size + 1,
                                   replace=False))
        g = np.repeat(cells[:-1], lengths)
        g = np.concatenate([g, np.full(real - g.size, cells[-1])])
        gids[ai, :real] = g
        feats[ai, :real] = rng.integers(0, 6, (real, c)) * 0.5
    rows = torch.from_numpy(feats.reshape(-1, c)).to(torch.bfloat16)
    flat = torch.from_numpy(np.minimum(gids.reshape(-1), ncell - 1))
    gout = torch.from_numpy(rng.normal(size=(a, ncell, c)).astype(
        np.float32)).to(torch.bfloat16)
    _canvas_bwd_bit_exact_on(cuda, rows, flat, gout, a, ncell, "rows64")


@pytest.mark.cuda
@pytest.mark.parametrize("c", [128, 6])
def test_warp_bwd_kernel_matches_plain_on_card(cuda, c):
    rng = np.random.RandomState(c)
    g = _t(rng.randn(len(THETAS), 32, 48, c).astype(np.float32)).to(cuda)
    th = _t(THETAS).to(cuda)
    got = warp_affine_bwd(g, th)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(),
                               warp_affine_bwd_plain(g, th).cpu().numpy(),
                               rtol=0, atol=_warp_bwd_tolerance(g, 48))


def _warp_bwd_tolerance(g, w):
    # the plain version's coordinate may differ in its last bit on the card
    # (see the forward's test); each source pixel gathers a few weights
    return 16.0 * w * 2.0 ** -23 * float(g.abs().max())


@pytest.mark.parametrize("which", [f"THETAS[{i}]" for i in range(len(THETAS))]
                         + [f"EXTRA_THETAS[{i}]" for i in range(len(EXTRA_THETAS))])
def test_warp_bwd_window_holds_every_corner(which):
    """K3b gathers each source pixel's sum from the outputs in its window
    (``_source_window`` mirrors the kernel's rule): every (output, corner)
    pair that the scatter of ``_corners`` adds must lie in the window of
    the corner's source pixel."""
    theta = torch.from_numpy(eval(which)[None])
    n, h, w = 1, 32, 48
    x0, x1, y0, y1 = _source_window(theta, h, w)
    yo, xo = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    pairs = 0
    for idx, inb, _ in _corners(n, h, w, theta):
        iy, ix = idx[0] // w, idx[0] % w
        inside = ((x0[0, iy, ix] <= xo) & (xo <= x1[0, iy, ix])
                  & (y0[0, iy, ix] <= yo) & (yo <= y1[0, iy, ix]))
        assert not bool((inb[0] & ~inside).any()), which
        pairs += int(inb.sum())
    sizes = (x1 - x0 + 1).clamp(min=0) * (y1 - y0 + 1).clamp(min=0)
    assert int(sizes.sum()) >= pairs
    if which == "EXTRA_THETAS[0]":  # singular: the whole map
        assert bool((sizes == h * w).all())
    if which == "THETAS[0]":  # identity: a 3 x 3 box at most
        assert int(sizes.max()) <= 9


@pytest.mark.parametrize("h,w,c", [(16, 24, 8), (9, 20, 3)])
def test_warp_bwd_plain_matches_jax_vjp_on_extra_thetas(jx, h, w, c):
    rng = np.random.RandomState(h * w + c)
    n = len(EXTRA_THETAS)
    src = rng.randn(n, h, w, c).astype(np.float32)
    g = rng.randn(n, h, w, c).astype(np.float32)
    got = warp_affine_bwd_plain(_t(g), _t(EXTRA_THETAS)).numpy()
    # fp32 sums of up to h * w weighted terms (the singular and nearly
    # singular thetas) in another order; the weights round alike
    _close(got, jx.warp_gather_vjp(src, EXTRA_THETAS, g), 1e-5, "gather")
    _close(got, jx.warp_mxu_vjp(src, EXTRA_THETAS, g), 1e-5, "mxu")


def test_warp_bwd_plain_matches_jax_vjp_at_one_channel(jx):
    """K3b's plain version on a one-channel map, as the pyramid's
    occupancy scores (a level narrowed to 16 x 32), against JAX's VJPs."""
    rng = np.random.RandomState(31)
    thetas = THETAS[:4]
    src = rng.randn(len(thetas), 16, 32, 1).astype(np.float32)
    g = rng.randn(len(thetas), 16, 32, 1).astype(np.float32)
    got = warp_affine_bwd_plain(_t(g), _t(thetas)).numpy()
    # fp32 sums of up to 16 weighted terms in another order
    _close(got, jx.warp_gather_vjp(src, thetas, g), 1e-5, "gather")
    _close(got, jx.warp_mxu_vjp(src, thetas, g), 1e-5, "mxu")


@pytest.mark.parametrize("c,route", [(1, "pixel"), (2, "pixel"), (3, "pixel"),
                                     (4, "pixel"), (6, "pixel"), (64, "warp")])
def test_warp_bwd_route_follows_channels(c, route):
    """K3b's route by channel count: one thread a source pixel up to
    PIXEL_MAX_CHANNELS (it beat the warp route at every width up to 8 on an
    H100), a warp for four pixels beyond."""
    from gencomm_tpu_torch.ops.warp import PIXEL_MAX_CHANNELS, backward_route

    assert backward_route(c) == route
    assert PIXEL_MAX_CHANNELS == 8


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 2, 3])
def test_warp_bwd_pixel_route_matches_warp_route_on_card(cuda, c):
    """K3b's pixel route on narrow maps: the warp route's bits, within the
    plain version's tolerance, the same bits on two launches, on rigid,
    sheared, zoomed and singular thetas."""
    rng = np.random.RandomState(c + 40)
    thetas = np.concatenate([THETAS, EXTRA_THETAS])
    g = _t(rng.randn(len(thetas), 32, 48, c).astype(np.float32)).to(cuda)
    th = _t(thetas).to(cuda)
    before = dict(WARP_ROUTE_LAUNCHES)
    pixel = warp_affine_bwd(g, th, "pixel")
    again = warp_affine_bwd(g, th, "pixel")
    wide = warp_affine_bwd(g, th, "warp")
    torch.cuda.synchronize()
    assert WARP_ROUTE_LAUNCHES["pixel"] == before["pixel"] + 2
    assert WARP_ROUTE_LAUNCHES["warp"] == before["warp"] + 1
    assert torch.equal(pixel, wide) and torch.equal(pixel, again)
    np.testing.assert_allclose(pixel.cpu().numpy(),
                               warp_affine_bwd_plain(g, th).cpu().numpy(),
                               rtol=0, atol=_warp_bwd_tolerance(g, 48))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [128, 6])
def test_warp_bwd_kernel_matches_plain_on_extra_thetas_on_card(cuda, c):
    rng = np.random.RandomState(c + 1)
    g = _t(rng.randn(len(EXTRA_THETAS), 32, 48, c).astype(np.float32)).to(cuda)
    th = _t(EXTRA_THETAS).to(cuda)
    got = warp_affine_bwd(g, th)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(),
                               warp_affine_bwd_plain(g, th).cpu().numpy(),
                               rtol=0, atol=_warp_bwd_tolerance(g, 48))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [128, 6])
def test_warp_bwd_kernel_repeats_bit_for_bit_on_card(cuda, c):
    rng = np.random.RandomState(c + 2)
    thetas = np.concatenate([THETAS, EXTRA_THETAS])
    g = _t(rng.randn(len(thetas), 32, 48, c).astype(np.float32)).to(cuda)
    th = _t(thetas).to(cuda)
    first, second = warp_affine_bwd(g, th), warp_affine_bwd(g, th)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# ---------------------------------------------------------------- K4, K4b
def splat_case(kind, seed=0, p=300, k=4, c=128, s=900):
    """dvals (p, k), feats (p, c), ids (p, k) int32, a canvas cotangent
    (s, c) and s. ``dropped``: collisions and ids >= s, which drop;
    ``empty_range``: cells 200 .. s - 1 receive nothing; ``long_run``: a
    third of the rows in one cell; ``all_dropped``: every id >= s."""
    rng = np.random.default_rng(seed)
    dvals = rng.random((p, k), dtype=np.float32)
    feats = rng.standard_normal((p, c), dtype=np.float32)
    if kind == "dropped":
        ids = rng.integers(0, s + 300, (p, k))
    elif kind == "empty_range":
        ids = rng.integers(0, 200, (p, k))
    elif kind == "long_run":
        ids = rng.integers(0, s, (p, k))
        ids[:p // 3] = 517
    else:
        ids = np.full((p, k), s + 5)
    g = rng.standard_normal((s, c), dtype=np.float32)
    return dvals, feats, ids.astype(np.int32), g, s


SPLAT_CARD_CASES = [("dropped", 300, 4, 128), ("empty_range", 777, 3, 16),
                    ("long_run", 3000, 4, 128), ("long_run", 50, 8, 256),
                    ("all_dropped", 300, 4, 128), ("dropped", 33, 1, 4)]


def _splat_checks_on_card(dvals, feats, ids, s, bf16_rows=False):
    """K4 against its plain version, against itself on a second launch, and
    its row order against the stable sort's."""
    want = splat_topk_plain(dvals, feats, ids, s, bf16_rows)
    before = LAUNCHES["splat_topk"]
    got, sids, order = splat_topk_with_order(dvals, feats, ids, s, bf16_rows)
    torch.cuda.synchronize()
    assert LAUNCHES["splat_topk"] == before + 1
    # fp32 sums of up to 4000 rows in another order (the plain index_add_
    # uses atomics on the card): 1e-5 of the largest value
    _close(got.cpu().numpy(), want.cpu().numpy(), 1e-5, "canvas")
    # the kernel sums each cell in one fixed order
    assert torch.equal(got, splat_topk_fwd(dvals, feats, ids, s, bf16_rows))
    assert bool((got[(want == 0).all(-1)] == 0).all())
    kept = int(((ids >= 0) & (ids < s)).sum())
    want_sids, want_order = sort_ids(ids, s)
    assert sids.numel() == kept
    assert torch.equal(order, want_order[:kept])
    assert torch.equal(sids, want_sids[:kept])


@pytest.mark.cuda
@pytest.mark.parametrize("bf16_rows", [False, True])
@pytest.mark.parametrize("kind,p,k,c", SPLAT_CARD_CASES)
def test_splat_kernel_matches_plain_on_card(cuda, kind, p, k, c, bf16_rows):
    dvals, feats, ids, _, s = splat_case(kind, 3, p, k, c)
    ids[-5:] = -2  # negative ids drop like ids >= s
    _splat_checks_on_card(*(_t(a).to(cuda) for a in (dvals, feats, ids)), s,
                          bf16_rows)


@pytest.mark.cuda
@pytest.mark.parametrize("p,cells", [(24576, 131072), (49152, 262144)])
def test_splat_kernel_at_the_camera_paths_sizes_on_card(cuda, p, cells):
    """top-8 of 128 channels at the camera eval frame's and train step's
    sizes, with ids like the paths': a third dropped, the rest in a few
    thousand cells, some of which collect hundreds of rows."""
    rng = np.random.default_rng(p)
    k, c = 8, 128
    hot = rng.choice(cells, size=cells // 27, replace=False)
    weights = rng.lognormal(0.0, 0.9, size=hot.size)
    ids = rng.choice(hot, size=(p, k), p=weights / weights.sum())
    ids[rng.random((p, k)) < 0.3] = cells  # out of the grid
    assert np.bincount(ids[ids < cells]).max() > 200
    dvals = rng.random((p, k), dtype=np.float32)
    feats = rng.standard_normal((p, c), dtype=np.float32)
    _splat_checks_on_card(*(_t(a).to(cuda) for a in
                            (dvals, feats, ids.astype(np.int32))), cells)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["one_cell", "every_cell_once", "odd_cells",
                                  "no_rows"])
def test_splat_kernel_edge_layouts_on_card(cuda, kind):
    """All rows in one cell (one segment of 4,000 rows); every cell hit
    exactly once; a cell count that no block or tile size divides; no
    pixels at all (the canvas is all zeros)."""
    rng = np.random.default_rng(len(kind))
    p, k, c = (0 if kind == "no_rows" else 1000), 4, 16
    if kind == "no_rows":
        s, ids = 5000, np.zeros((0, k))
    elif kind == "one_cell":
        s, ids = 777, np.full((p, k), 123)
    elif kind == "every_cell_once":
        s, ids = p * k, rng.permutation(p * k).reshape(p, k)
    else:
        s = 100003
        ids = rng.integers(-3, s + 3, (p, k))
        ids[:4] = [[0, s - 1, s, -1]] * 4  # both ends, and just outside
    dvals = rng.random((p, k), dtype=np.float32)
    feats = rng.standard_normal((p, c), dtype=np.float32)
    _splat_checks_on_card(*(_t(a).to(cuda) for a in
                            (dvals, feats, ids.astype(np.int32))), s)


# the plain reference of the order K4 sums in
@pytest.mark.parametrize("ids,num_cells,sids,order", [
    # equal ids keep their row order (stable)
    ([[3, 1], [3, 0], [1, 3]], 4, [0, 1, 1, 3, 3, 3], [3, 1, 4, 0, 2, 5]),
    # ids >= num_cells are dropped: they sort last, in row order
    ([[5, 2], [9, 2], [0, 4]], 4, [0, 2, 2, 4, 4, 4], [4, 1, 3, 0, 2, 5]),
    # negative ids are dropped like ids >= num_cells
    ([[-1, 2], [1, -7], [2, 3]], 3, [1, 2, 2, 3, 3, 3], [2, 1, 4, 0, 3, 5]),
])
def test_splat_order_reference(ids, num_cells, sids, order):
    got_sids, got_order = sort_ids(torch.tensor(ids, dtype=torch.int32),
                                   num_cells)
    assert got_sids.dtype == got_order.dtype == torch.int32
    assert got_sids.tolist() == sids
    assert got_order.tolist() == order


@pytest.mark.parametrize("m,cells,c,ints,floats", [
    # counters and local offsets (cells + 1 each), ticket, tile offsets
    # (tiles + 1), four ints a row; two piece sums a chunk of 32 rows
    (196608, 131072, 128, 2 * 131073 + 1 + 129 + 1 + 4 * 196608,
     2 * 6144 * 128),
    (393216, 262144, 128, 2 * 262145 + 1 + 257 + 1 + 4 * 393216,
     2 * 12288 * 128),
    (33, 1023, 4, 2 * 1024 + 1 + 1 + 1 + 4 * 33, 2 * 2 * 4),
    (0, 5, 8, 2 * 6 + 1 + 1 + 1, 0),
])
def test_splat_forward_scratch_sizes(m, cells, c, ints, floats):
    assert forward_scratch(m, cells, c) == (ints, floats)


def test_splat_wrapper_takes_plain_version_on_cpu():
    dvals, feats, ids, _, s = splat_case("dropped", 1, p=40, k=3, c=8)
    dvals, feats, ids = (_t(a) for a in (dvals, feats, ids))
    before = LAUNCHES["splat_topk"]
    assert torch.equal(splat_topk_fwd(dvals, feats, ids, s),
                       splat_topk_plain(dvals, feats, ids, s))
    assert LAUNCHES["splat_topk"] == before


# K4b holds one float4 of channels per lane: at most 128 channels
SPLAT_BWD_CARD_CASES = [case if case[3] <= 128 else case[:3] + (64,)
                        for case in SPLAT_CARD_CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,p,k,c", SPLAT_BWD_CARD_CASES)
def test_splat_bwd_kernel_matches_plain_on_card(cuda, kind, p, k, c):
    dvals, feats, ids, g, s = splat_case(kind, 4, p, k, c)
    ids[-5:] = -2
    dvals, feats, ids, g = (_t(a).to(cuda) for a in (dvals, feats, ids, g))
    got = splat_topk_bwd(dvals, feats, ids, g, s)
    torch.cuda.synchronize()
    want = splat_topk_bwd_plain(dvals, feats, ids, g, s)
    # fp32 sums of c products / k rows in another order: 1e-5
    for name, gv, wv in zip(("d_dvals", "d_feats"), got, want):
        _close(gv.cpu().numpy(), wv.cpu().numpy(), 1e-5, name)
    # through autograd the wrapper launches both kernels
    td, tf = dvals.clone().requires_grad_(), feats.clone().requires_grad_()
    before = LAUNCHES["splat_topk_bwd"]
    splat_topk(td, tf, ids, s).backward(g)
    assert LAUNCHES["splat_topk_bwd"] == before + 1
    assert torch.equal(td.grad, got[0]) and torch.equal(tf.grad, got[1])


@pytest.mark.cuda
def test_splat_kernel_refuses_what_it_does_not_take(cuda):
    dvals, feats, ids, _, s = splat_case("dropped", 5, c=6)
    dvals, feats, ids = (_t(a).to(cuda) for a in (dvals, feats, ids))
    with pytest.raises(ValueError, match="multiple of 4"):
        splat_topk_fwd(dvals, feats, ids, s)
    with pytest.raises(ValueError, match="int32"):
        splat_topk_fwd(dvals, feats[:, :4].contiguous(), ids.long(), s)
    dvals, feats, ids, g, s = splat_case("dropped", 5, c=256)
    dvals, feats, ids, g = (_t(a).to(cuda) for a in (dvals, feats, ids, g))
    with pytest.raises(ValueError, match="at most 128 channels"):
        splat_topk_bwd(dvals, feats, ids, g, s)


def test_bf16_entries_live_in_the_fp32_sources():
    import os
    from gencomm_tpu_torch.ops import _cuda

    # one source, one nvcc, one library per kernel: the bf16 entries are
    # instantiations in their fp32 kernel's source
    assert _cuda.source("deform_conv_bf16") == "deform_conv"
    assert _cuda.source("warp_affine_bf16") == "warp_affine"
    assert _cuda.source("warp_affine") == "warp_affine"
    sources = {_cuda.source(n) for n in _cuda.SIGNATURES}
    assert len(sources) == 9  # K1-K4, K1b-K4b and N1 (the NMS keep-set)
    for src in sources:
        assert os.path.exists(os.path.join(_cuda.CSRC_DIR, f"{src}.cu")), src
    assert {"deform_conv3x3_bf16", "warp_affine_bf16"} <= set(LAUNCHES)


# ---------------------------------------------------------------- N1
def _nms_case(kind, k, seed=0, device="cpu"):
    """(overlap (k, k) bool, valid (k,) bool) in score order. "random":
    car-sized boxes at random in an area that grows with k (a few overlaps
    a box), 10% invalid; "chain": a suppression chain k boxes deep (box j
    overlaps box j + 1 only), all valid."""
    if kind == "chain":
        over = torch.zeros(k, k, dtype=torch.bool)
        idx = torch.arange(k - 1)
        over[idx, idx + 1] = True
        return over.to(device), torch.ones(k, dtype=torch.bool, device=device)
    rng = np.random.RandomState(seed)
    side = 2.0 * k ** 0.5
    boxes = np.stack([rng.uniform(-side, side, k), rng.uniform(-side, side, k),
                      np.full(k, -1.0), np.full(k, 1.56),
                      rng.uniform(1.5, 2.0, k), rng.uniform(3.5, 4.5, k),
                      rng.uniform(-np.pi, np.pi, k)], -1).astype(np.float32)
    from gencomm_tpu_torch.utils.box_utils import boxes_to_corners_3d
    from gencomm_tpu_torch.ops.nms import overlap_matrix

    quads = boxes_to_corners_3d(torch.from_numpy(boxes), "hwl")[:, :4, :2]
    valid = torch.from_numpy(rng.uniform(0, 1, k) > 0.1)
    return overlap_matrix(quads.to(device), 0.15), valid.to(device)


def banded_nms_case(k, seed=0, band=48, density=0.06, device="cpu"):
    """(overlap (k, k) bool, valid (k,) bool): box j overlaps box i with
    probability ``density`` where j < i <= j + ``band``, 10% invalid; a few
    overlaps a box at any k, without the K^2 pairwise IoU of boxes."""
    rng = np.random.RandomState(seed)
    over = np.zeros((k, k), bool)
    for d in range(1, band + 1):
        idx = np.arange(k - d)
        over[idx, idx + d] = rng.uniform(0, 1, k - d) < density
    valid = rng.uniform(0, 1, k) > 0.1
    return (torch.from_numpy(over).to(device),
            torch.from_numpy(valid).to(device))


@pytest.mark.parametrize("k,route,words", [
    (1, "smem", 1), (512, "smem", 16), (1824, "smem", 57),
    (1825, "l2", 58), (2560, "l2", 80), (5120, "l2", 160),
    (8192, "l2", 256)])
def test_nms_storage_route_and_scratch_follow_k(k, route, words):
    """N1's storage rule (``csrc/nms_closure.cu``): the packed columns, 64
    W (W + 1) bytes, stay in the walking block's shared memory up to
    TRIANGLE_SMEM_BYTES (W <= 57, K <= 1,824), else its decider reads them
    from the L2; the global scratch holds the rows and the columns, 32 W
    (W + 1) words, on either route."""
    from gencomm_tpu_torch.ops.nms import (
        TRIANGLE_SMEM_BYTES, scratch_words, storage_route,
    )

    assert storage_route(k) == route
    assert scratch_words(k) == 32 * words * (words + 1)
    assert 64 * 57 * 58 <= TRIANGLE_SMEM_BYTES < 64 * 58 * 59


def test_nms_wrapper_takes_plain_version_on_cpu():
    from gencomm_tpu_torch.ops.nms import nms_closure, nms_closure_plain

    over, valid = _nms_case("random", 200, seed=4)
    before = LAUNCHES["nms_closure"]
    got = nms_closure(over, valid)
    assert torch.equal(got, nms_closure_plain(over, valid))
    assert 0 < int(got.sum()) < int(valid.sum())
    assert LAUNCHES["nms_closure"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "chain"])
@pytest.mark.parametrize("k", [512, 1024, 2560, 37])
def test_nms_kernel_matches_plain_on_card(cuda, kind, k):
    """N1 gives its plain version's keep mask bit for bit: K = 512 (eval,
    nms_topk), 1,024 and 2,560 (late fusion over 2 and 5 agents; 2,560 on
    storage route l2) and a ragged K, on random sets and on a chain K boxes
    deep."""
    from gencomm_tpu_torch.ops.nms import nms_closure, nms_closure_plain

    over, valid = _nms_case(kind, k, seed=k, device=cuda)
    before = LAUNCHES["nms_closure"]
    got = nms_closure(over, valid)
    torch.cuda.synchronize()
    assert LAUNCHES["nms_closure"] == before + 1
    want = nms_closure_plain(over, valid)
    assert torch.equal(got, want)
    if kind == "chain":
        assert torch.equal(got.cpu(), torch.arange(k) % 2 == 0)
    else:
        assert 0 < int(got.sum()) < int(valid.sum())
    assert torch.equal(nms_closure(over, valid), got)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4097, 5120, 8192])
def test_nms_kernel_matches_plain_past_4096_boxes_on_card(cuda, k):
    """N1 takes K past the 4,096 boxes its parent refused: banded random
    overlaps, bit for bit against the plain version and on two launches."""
    from gencomm_tpu_torch.ops.nms import nms_closure, nms_closure_plain

    over, valid = banded_nms_case(k, seed=k, device=cuda)
    got = nms_closure(over, valid)
    again = nms_closure(over, valid)
    torch.cuda.synchronize()
    want = nms_closure_plain(over, valid)
    assert torch.equal(got, want) and torch.equal(got, again)
    assert 0 < int(got.sum()) < int(valid.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("k,split,blocks_a_worker", [
    (12000, 2, 1), (12300, 1, 1), (25000, 1, 2)])
def test_nms_kernel_matches_plain_at_every_worker_layout_on_card(
        cuda, k, split, blocks_a_worker):
    """N1 past the layouts of K <= 8,192: two workers, then one, for each 32
    removed words, and at K = 25,000 (782 words in 25 blocks of 32, 24
    workers) a worker that walks two blocks of 32 words in turn. Banded
    random overlaps built on the card, bit for bit against the plain version
    and on two launches."""
    from gencomm_tpu_torch.ops.nms import nms_closure, nms_closure_plain

    words, workers = -(-k // 32), 24
    nblk = -(-words // 32)
    assert max(1, min(4, workers // nblk)) == split
    assert -(-nblk // (workers // split)) == blocks_a_worker
    gen = torch.Generator(device=cuda).manual_seed(k)
    over = (torch.rand(k, k, generator=gen, device=cuda) < 0.06).triu(1).tril(48)
    valid = torch.rand(k, generator=gen, device=cuda) > 0.1
    got = nms_closure(over, valid)
    again = nms_closure(over, valid)
    torch.cuda.synchronize()
    want = nms_closure_plain(over, valid)
    assert torch.equal(got, want) and torch.equal(got, again)
    assert 0 < int(got.sum()) < int(valid.sum())


@pytest.mark.cuda
def test_nms_kernel_on_two_streams_at_once_on_card(cuda):
    """Two N1 calls in flight at once, on two streams, share no state: each
    gives its plain version's keep mask, call after call."""
    from gencomm_tpu_torch.ops.nms import nms_closure, nms_closure_plain

    cases = [_nms_case("random", 2560, seed=5, device=cuda),
             banded_nms_case(5120, seed=6, device=cuda)]
    wants = [nms_closure_plain(over, valid) for over, valid in cases]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    gots = [[], []]
    for _ in range(8):
        for i, ((over, valid), s) in enumerate(zip(cases, streams)):
            with torch.cuda.stream(s):
                gots[i].append(nms_closure(over, valid))
    torch.cuda.synchronize()
    for want, got in zip(wants, gots):
        assert all(torch.equal(g, want) for g in got)


@pytest.mark.cuda
def test_run_stream_replays_a_captured_frame_bit_equal_to_run(cuda):
    """A tiny GenComm model on the card: run_stream captures one frame (K1,
    K2, K3 and N1 among its launches) and its replays give the detections of
    looped run with the same seeds, bit for bit."""
    from gencomm_tpu_torch.data.bucketing import trim_agent_slots
    from gencomm_tpu_torch.data.decorate import decorate_modality
    from gencomm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
    from gencomm_tpu_torch.models.heter_baseline import HeterModel
    from gencomm_tpu_torch.native import PillarVoxelizer
    from gencomm_tpu_torch.pipeline import InferencePipeline
    from gencomm_tpu_torch.weights import random_state_dict

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    lr, voxel = (-16.0, -8.0, -3.0, 16.0, 8.0, 1.0), (0.4, 0.4, 4.0)
    cfg = SyntheticConfig(lidar_range=lr, max_cav=3, num_agents=2,
                          points_per_agent=2048, num_vehicles=3,
                          points_per_vehicle=200, comm_range=10.0)
    scenes = SyntheticScenes(cfg)
    model = HeterModel(
        modality_args={"m1": {
            "encoder_args": {"voxel_size": list(voxel), "lidar_range": list(lr),
                             "pillar_vfe": {"use_norm": True,
                                            "num_filters": [32]}},
            "backbone_args": {"layer_nums": [1, 1], "layer_strides": [2, 2],
                              "num_filters": [32, 64],
                              "upsample_strides": [1, 2],
                              "num_upsample_filter": [32, 32]},
            "shrink_header": {"kernal_size": [3], "stride": [2],
                              "padding": [1], "dim": [64], "input_dim": 64}}},
        fusion_method="att", lidar_range=lr, anchor_number=2,
        use_gencomm=True, use_enhancer=True, device=cuda)
    model.load_state_dict(random_state_dict(model, seed=0))
    pipe = InferencePipeline(
        model, scenes.anchors,
        {"gt_range": list(lr), "target_args": {"score_threshold": 0.2},
         "nms_thresh": 0.15, "dir_args": {"dir_offset": 0.7853, "num_bins": 2},
         "nms_topk": 512}, device=cuda)
    vox = PillarVoxelizer(lr, voxel)
    frames = [decorate_modality(trim_agent_slots(scenes.sample(s, 1)), vox)
              for s in (3, 4, 5)]
    stacked = {k: np.stack([f[k] for f in frames]) for k in frames[0]}
    seeds = [7, 8, 9]
    got = pipe.run_stream(stacked, seeds)
    again = pipe.run_stream(stacked, seeds)
    (fg,) = pipe.graphs.values()
    assert fg.replays == 6
    for name in ("deform_conv3x3", "pillar_canvas", "warp_affine",
                 "nms_closure"):
        assert fg.launches.get(name, 0) >= 1, (name, fg.launches)
    for f, (frame, s) in enumerate(zip(frames, seeds)):
        want = pipe.run(frame, seed=s)
        for a, b, c in zip(got, again, want):
            assert torch.equal(a[f], c) and torch.equal(b[f], c)
