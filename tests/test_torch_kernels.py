"""The port's three kernels against the JAX package, on the CPU.

For each of K1 (deformable conv), K2 (pillar canvas) and K3 (affine warp)
the plain PyTorch version, which the wrapper takes for a CPU tensor, is held
against the JAX Pallas kernel (interpret mode, as the JAX package's own
tests run it) and against the JAX gather/scatter formulation, on inputs
made with numpy from a seed. The CUDA halves (kernel vs plain version on
the card) carry the ``cuda`` marker and skip without a card.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gencomm_tpu_torch.ops._cuda import LAUNCHES
from gencomm_tpu_torch.ops.deform_conv import (
    MAX_OFFSET, deform_conv3x3, deform_conv3x3_clamped, deform_conv3x3_plain,
)
from gencomm_tpu_torch.ops.pillar_canvas import pillar_canvas, pillar_canvas_plain
from gencomm_tpu_torch.ops.warp import warp_affine, warp_affine_plain

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


@pytest.fixture(scope="module")
def jx():
    """The JAX references as numpy-in, numpy-out functions, imported here
    so that the card's halves of this file also run where JAX is not
    installed."""
    pytest.importorskip("jax")
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

    return SimpleNamespace(
        deform_mxu=numpy_fn(deform_conv3x3_mxu),
        deform_gather=numpy_fn(deform_conv3x3_nhwc),
        deform_auto=numpy_fn(deform_conv3x3_auto),
        canvas_reference=numpy_fn(striped_pillar_canvas_reference),
        canvas_kernel=numpy_fn(striped_pillar_canvas),
        stripe_pad_sorted=stripe_pad_sorted, bf16_rows=bf16_rows,
        warp_gather=numpy_fn(warp_affine_nhwc),
        warp_mxu=numpy_fn(warp_affine_mxu))


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
    return t.view(torch.int16).numpy()


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
