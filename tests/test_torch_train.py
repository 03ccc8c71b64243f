"""The port's training slice against the JAX package and optax, on the CPU.

The backward kernels' plain versions (K1b deformable conv, K2b pillar
canvas, K3b affine warp), which the autograd functions take for CPU
tensors, are held against ``jax.vjp`` / ``jax.grad`` of the JAX package's
Pallas kernels (interpret mode, as its own tests run them) and gather /
scatter formulations. Then the labels, the loss, the train-mode norms, the
optimizer and one whole train step (losses, every parameter gradient, the
new running statistics and the parameters after one AdamW update). Inputs
are made with numpy from a seed; the diffusion noise is drawn once with
numpy and replayed into ``jax.random.normal``. The backward kernels'
CUDA halves (kernel vs plain version on the card) are in
``test_torch_kernels.py``, which the card's machine runs without JAX.
"""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax import linen as fnn

from gencomm_tpu.data import postprocessor as jax_post
from gencomm_tpu.data.synthetic import (
    SyntheticConfig as JaxSyntheticConfig, SyntheticScenes as JaxScenes,
)
from gencomm_tpu.loss.point_pillar_loss import (
    PointPillarGenCommLoss as JaxGenCommLoss,
)
from gencomm_tpu.models.encoders.point_pillar import (
    MaskedBatchNorm as JaxMaskedBN, PointPillarEncoder as JaxEncoder,
)
from gencomm_tpu.models.heads import DetectionHeads as JaxHeads
from gencomm_tpu.models.heter_baseline import HeterModel as JaxHeterModel
from gencomm_tpu.ops.deform import deform_conv3x3_nhwc
from gencomm_tpu.ops.deform_pallas import (
    deform_conv3x3_auto, deform_conv3x3_mxu,
)
from gencomm_tpu.ops.warp import warp_affine as jax_warp_nchw
from gencomm_tpu.ops.warp import warp_affine_nhwc
from gencomm_tpu.ops.warp_pallas import warp_affine_mxu
from gencomm_tpu.train import trainer as jax_trainer

from gencomm_tpu_torch.data import postprocessor as port_post
from gencomm_tpu_torch.data.bucketing import trim_agent_slots
from gencomm_tpu_torch.data.decorate import decorate_modality
from gencomm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from gencomm_tpu_torch.loss import build_loss
from gencomm_tpu_torch.models.encoders import point_pillar
from gencomm_tpu_torch.models.encoders.point_pillar import MaskedBatchNorm
from gencomm_tpu_torch.models.heads import DetectionHeads
from gencomm_tpu_torch.models.heter_baseline import HeterModel
from gencomm_tpu_torch.models.layers import BatchNorm
from gencomm_tpu_torch.native import PillarVoxelizer
from gencomm_tpu_torch.ops._cuda import LAUNCHES
from gencomm_tpu_torch.ops.deform_conv import (
    MAX_OFFSET, deform_conv3x3, deform_conv3x3_bwd, deform_conv3x3_bwd_plain,
    deform_conv3x3_clamped,
)
from gencomm_tpu_torch.ops.pillar_canvas import (
    pillar_canvas, pillar_canvas_bwd, pillar_canvas_bwd_plain,
    pillar_canvas_plain,
)
from gencomm_tpu_torch.ops.warp import (
    warp_affine, warp_affine_bwd, warp_affine_bwd_plain,
)
from gencomm_tpu_torch.pipeline import batch_to_device
from gencomm_tpu_torch.train.trainer import (
    backalign_frozen_modules, make_gmatch_train_step, make_lr_schedule,
    make_optimizer, make_train_step,
)
from gencomm_tpu_torch.weights import flax_grads_to_torch, flax_to_state_dict

from tests.test_torch_kernels import (
    THETAS, _bits, _close, _t, canvas_case as _canvas_case,
    deform_case as _deform_case,
)
from tests.test_torch_pipeline import LR, MODEL_KW, VOXEL

# configs/opv2v/gencomm/stage1/m1_att.yaml:108-141
HYPES = {
    "optimizer": {"core_method": "Adam", "lr": 0.002,
                  "args": {"eps": 1e-10, "weight_decay": 1e-4}},
    "lr_scheduler": {"core_method": "multistep", "gamma": 0.1,
                     "step_size": [10, 15]},
    "loss": {"core_method": "point_pillar_gencomm_loss", "args": {
        "pos_cls_weight": 2.0,
        "cls": {"type": "SigmoidFocalLoss", "alpha": 0.25, "gamma": 2.0,
                "weight": 2.0},
        "reg": {"type": "WeightedSmoothL1Loss", "sigma": 3.0,
                "codewise": True, "weight": 2.0},
        "dir": {"type": "WeightedSoftmaxClassificationLoss", "weight": 0.2,
                "args": {"dir_offset": 0.7853, "num_bins": 2,
                         "anchor_yaw": [0, 90]}},
        "generate_weight": 1}},
}


# ---------------------------------------------------------------- K1b
def _port_deform_bwd(x, off, wt, g):
    return [t.numpy() for t in deform_conv3x3_bwd_plain(
        _t(x), _t(off), _t(wt), _t(g))]


@pytest.mark.parametrize("kind,shape", [
    ("fractional", (2, 12, 16, 8, 4)),
    ("integer", (2, 12, 16, 8, 4)),
    ("fractional", (1, 9, 7, 5, 3)),   # odd sizes, a band taller than the map
])
def test_deform_bwd_plain_matches_pallas_vjp(kind, shape):
    b, h, w, cin, cout = shape
    x, off, wt, g = _deform_case(kind, 1, b, h, w, cin, cout)
    _, vjp = jax.vjp(deform_conv3x3_mxu, jnp.asarray(x), jnp.asarray(off),
                     jnp.asarray(wt))
    want = vjp(jnp.asarray(g))
    got = _port_deform_bwd(x, off, wt, g)
    # fp32: the TPU kernel forms the bilinear weights as max(0, 1 - |d|)
    # over a band of one-hot rows and sums in another order; 1e-4
    for name, gv, wv in zip(("dx", "doff", "dweight"), got, want):
        _close(gv, wv, 1e-4, name)


@pytest.mark.parametrize("kind", ["fractional", "integer"])
def test_deform_bwd_plain_matches_gather_grad(kind):
    x, off, wt, g = _deform_case(kind, 2)

    def f(a, o, k):
        return jnp.sum(deform_conv3x3_nhwc(a, o, k) * g)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(off),
                                          jnp.asarray(wt))
    got = _port_deform_bwd(x, off, wt, g)
    # the same four-corner arithmetic, sums in another order: 1e-5
    for name, gv, wv in zip(("dx", "doff", "dweight"), got, want):
        _close(gv, wv, 1e-5, name)


def test_deform_autograd_through_the_clamp_matches_jax():
    x, _, wt, g = _deform_case("fractional", 3)
    rng = np.random.RandomState(3)
    off = (rng.randn(*x.shape[:3], 18) * 4.0).astype(np.float32)
    off.reshape(-1)[::5] = MAX_OFFSET      # exactly on the bound: 0.5
    off.reshape(-1)[2::9] = -MAX_OFFSET
    bias = np.linspace(-1, 1, wt.shape[-1]).astype(np.float32)

    def f(a, o, k, bb):
        return jnp.sum(deform_conv3x3_auto(a, o, k, bb) * g)

    want = jax.grad(f, argnums=(0, 1, 2, 3))(*map(jnp.asarray,
                                                  (x, off, wt, bias)))
    xs, os_, ws, bs = (_t(a).requires_grad_() for a in (x, off, wt, bias))
    (deform_conv3x3_clamped(xs, os_, ws, bs) * _t(g)).sum().backward()
    for name, t, wv in zip(("dx", "doff", "dweight", "dbias"),
                           (xs, os_, ws, bs), want):
        _close(t.grad.numpy(), wv, 1e-5, name)
    # the clamp's tie rule: half the gradient at the bound, none beyond
    on_bound = np.abs(off) == MAX_OFFSET
    beyond = np.abs(off) > MAX_OFFSET
    assert on_bound.sum() > 0 and beyond.sum() > 0
    _, doff_inner, _ = deform_conv3x3_bwd_plain(
        _t(x), _t(np.clip(off, -MAX_OFFSET, MAX_OFFSET)), _t(wt), _t(g))
    np.testing.assert_allclose(os_.grad.numpy()[on_bound],
                               0.5 * doff_inner.numpy()[on_bound], rtol=1e-6)
    assert np.all(os_.grad.numpy()[beyond] == 0)


def test_deform_backward_takes_plain_version_on_cpu():
    x, off, wt, g = (_t(a) for a in _deform_case("fractional", 4))
    before = LAUNCHES["deform_conv3x3_bwd"]
    xs = x.clone().requires_grad_()
    (deform_conv3x3(xs, off, wt) * g).sum().backward()
    assert torch.equal(xs.grad, deform_conv3x3_bwd(x, off, wt, g)[0])
    assert torch.equal(xs.grad, deform_conv3x3_bwd_plain(x, off, wt, g)[0])
    assert LAUNCHES["deform_conv3x3_bwd"] == before


# ---------------------------------------------------------------- K2b
def _jax_canvas_vjp(rows, gids, gout, a, ncell):
    """The JAX decorated path's training scatter (point_pillar.py:172-189)
    and its VJP, on the same bf16 rows."""
    m, c = rows.shape
    agent = np.repeat(np.arange(a, dtype=np.int32), m // a)
    flat = jnp.asarray(agent * ncell + gids.numpy())
    x = jnp.asarray(rows.float().numpy()).astype(jnp.bfloat16)

    def scatter(r):
        canvas = jnp.zeros((a * ncell, c), jnp.bfloat16)
        return canvas.at[flat].max(r, indices_are_sorted=True)

    out, vjp = jax.vjp(scatter, x)
    (d,) = vjp(jnp.asarray(gout.float().numpy()).astype(
        jnp.bfloat16).reshape(a * ncell, c))
    to_t = lambda v: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.bfloat16)
    return to_t(out).reshape(a, ncell, c), to_t(d)


@pytest.mark.parametrize("seed", [0, 1])
def test_canvas_bwd_plain_bit_exact_vs_jax(seed):
    a, ncell = 3, 64
    rows, gids, gout = _canvas_case(seed, a=a, ncell=ncell)
    want_canvas, want = _jax_canvas_vjp(rows, gids, gout, a, ncell)
    canvas = pillar_canvas_plain(rows, gids, a, ncell)
    np.testing.assert_array_equal(_bits(canvas), _bits(want_canvas))
    got = pillar_canvas_bwd_plain(rows, gids, canvas, gout, a, ncell)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the constructed cases occur: rows that share a cell's max three ways,
    # and runs whose count stops at 256
    cells = (torch.arange(rows.shape[0]) // (rows.shape[0] // a)) * ncell \
        + gids.long()
    share = got.float() / gout.reshape(a * ncell, -1)[cells].float()
    assert ((share - 1 / 3).abs() < 0.01).any()
    assert ((share - 1 / 256).abs() < 1e-4).any()


def test_canvas_autograd_takes_plain_version_on_cpu():
    a, ncell = 3, 64
    rows, gids, gout = _canvas_case(2, a=a, ncell=ncell)
    r = rows.clone().requires_grad_()
    before = LAUNCHES["pillar_canvas_bwd"]
    out = pillar_canvas(r, gids, a, ncell)
    out.backward(gout)
    want = pillar_canvas_bwd(rows, gids, out.detach(), gout, a, ncell)
    np.testing.assert_array_equal(_bits(r.grad), _bits(want))
    assert LAUNCHES["pillar_canvas_bwd"] == before


def test_canvas_share_rounds_like_jax_for_every_count():
    # bf16(1 / n) for n = 1 .. 300 tied rows, with and without the zero
    # init tying: one cell per count
    counts = list(range(1, 301))
    rows, gids = [], []
    for cell, n in enumerate(counts):
        v = 0.0 if cell % 2 else 1.25
        rows.append(np.full((n, 2), v, np.float32))
        gids.append(np.full(n, cell, np.int32))
    rows = torch.from_numpy(np.concatenate(rows)).to(torch.bfloat16)
    gids = torch.from_numpy(np.concatenate(gids))
    ncell = len(counts)
    gout = torch.full((1, ncell, 2), 1.703125).to(torch.bfloat16)
    _, want = _jax_canvas_vjp(rows, gids, gout, 1, ncell)
    got = pillar_canvas_bwd_plain(rows, gids, pillar_canvas_plain(
        rows, gids, 1, ncell), gout, 1, ncell)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert float(got[0, 0]) == 1.703125  # one row
    assert float(got[1, 0]) == 0.5703125  # two zero rows and the zero init


# ---------------------------------------------------------------- K3b
@pytest.mark.parametrize("h,w,c", [(16, 24, 8), (9, 20, 3)])
def test_warp_bwd_plain_matches_jax_vjp(h, w, c):
    n = len(THETAS)
    rng = np.random.RandomState(h * w + c)
    src = rng.randn(n, h, w, c).astype(np.float32)
    g = rng.randn(n, h, w, c).astype(np.float32)
    th = jnp.asarray(THETAS)
    got = warp_affine_bwd_plain(_t(g), _t(THETAS)).numpy()
    _, vjp = jax.vjp(lambda s: jax_warp_nchw(s, th),
                     jnp.asarray(np.moveaxis(src, -1, 1)))
    want_nchw = np.moveaxis(np.asarray(vjp(jnp.asarray(
        np.moveaxis(g, -1, 1)))[0]), 1, -1)
    _, vjp = jax.vjp(lambda s: warp_affine_nhwc(s, th), jnp.asarray(src))
    want_nhwc = np.asarray(vjp(jnp.asarray(g))[0])
    _, vjp = jax.vjp(warp_affine_mxu, jnp.asarray(src), th)
    want_mxu, dtheta = vjp(jnp.asarray(g))
    # fp32 scatter-adds of <= a few corner weights per source pixel in
    # another order; the weights round alike (1e-5)
    _close(got, want_nchw, 1e-5, "gather (NCHW)")
    _close(got, want_nhwc, 1e-5, "gather (NHWC)")
    _close(got, want_mxu, 1e-5, "warp_affine_mxu")
    assert not np.any(np.asarray(dtheta))
    assert np.all(got[-1] == 0)  # the last theta samples only outside


def test_warp_autograd_takes_plain_version_and_refuses_theta_grad():
    rng = np.random.RandomState(0)
    src = _t(rng.randn(len(THETAS), 8, 8, 4).astype(np.float32))
    g = _t(rng.randn(len(THETAS), 8, 8, 4).astype(np.float32))
    th = _t(THETAS)
    s = src.clone().requires_grad_()
    before = LAUNCHES["warp_affine_bwd"]
    (warp_affine(s, th) * g).sum().backward()
    assert torch.equal(s.grad, warp_affine_bwd(g, th))
    assert LAUNCHES["warp_affine_bwd"] == before
    with pytest.raises(ValueError, match="theta"):
        warp_affine(s, th.clone().requires_grad_())


# ---------------------------------------------------------------- labels
@pytest.mark.parametrize("kw,seed", [
    ({}, 0),
    (dict(lidar_range=LR, points_per_agent=3000, num_vehicles=6,
          points_per_vehicle=60, comm_range=12.0), 3),
    (dict(num_agents=3, pos_threshold=0.5, neg_threshold=0.3), 11),
])
def test_synthetic_labels_equal(kw, seed):
    want = JaxScenes(JaxSyntheticConfig(**kw)).sample(seed, 2)
    got = SyntheticScenes(SyntheticConfig(**kw)).sample(seed, 2)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["pos_equal_one"].sum() > 0


def test_anchor_cache_keys_on_every_byte():
    anchors = port_post.generate_anchor_box(
        SyntheticScenes(SyntheticConfig(lidar_range=LR)).anchor_args)
    other = anchors.copy()
    mid = tuple(s // 2 for s in anchors.shape[:3])
    other[mid + (0,)] += 0.05  # one centre in the middle: not a regular grid
    assert (anchors.tobytes()[:256] == other.tobytes()[:256]
            and anchors.tobytes()[-256:] == other.tobytes()[-256:])
    # the JAX key conflates the two grids: the second gets the first's stats
    jax_post._ANCHOR_STATICS.clear()
    assert jax_post._anchor_statics(anchors, "hwl")["structured"]
    assert jax_post._anchor_statics(other, "hwl")["structured"]
    jax_post._ANCHOR_STATICS.clear()
    assert not jax_post._anchor_statics(other, "hwl")["structured"]
    jax_post._ANCHOR_STATICS.clear()
    # the port's does not
    assert port_post._anchor_statics(anchors, "hwl")["structured"]
    assert not port_post._anchor_statics(other, "hwl")["structured"]
    # the irregular grid takes the dense IoU path; its labels agree
    batch = SyntheticScenes(SyntheticConfig(lidar_range=LR)).sample(1, 1)
    want = jax_post.generate_label(batch["gt_boxes"][0], batch["gt_mask"][0],
                                   other, 0.6, 0.45)
    jax_post._ANCHOR_STATICS.clear()
    got = port_post.generate_label(batch["gt_boxes"][0], batch["gt_mask"][0],
                                   other, 0.6, 0.45)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["pos_equal_one"].sum() > 0


def test_per_agent_labels_raise():
    """The per-agent labels, which raised until the HEAL pyramid slice,
    now build: bit for bit the JAX sampler's
    (tests/test_torch_pyramid.py holds them with a camera agent too)."""
    kw = dict(lidar_range=LR, points_per_agent=3000, num_vehicles=6,
              points_per_vehicle=60, comm_range=12.0, per_agent_labels=True)
    want = JaxScenes(JaxSyntheticConfig(**kw)).sample(3, 2)
    got = SyntheticScenes(SyntheticConfig(**kw)).sample(3, 2)
    assert set(got) == set(want) and "targets_single" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------- loss
def test_gencomm_loss_matches_jax():
    scenes = SyntheticScenes(SyntheticConfig(lidar_range=LR,
                                             points_per_agent=3000,
                                             num_vehicles=6,
                                             points_per_vehicle=60))
    batch = scenes.sample(5, 2)
    rng = np.random.RandomState(5)
    hh, ww, na = batch["pos_equal_one"].shape[1:]
    out = {"cls_preds": rng.randn(2, hh, ww, na) * 2,
           "reg_preds": rng.randn(2, hh, ww, na * 7),
           "dir_preds": rng.randn(2, hh, ww, na * 2),
           "gt_feature": rng.randn(4, 6, 8, 16),
           "pred_feature": rng.randn(4, 6, 8, 16)}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    mask = np.array([True, True, True, False])
    labels = {k: batch[k] for k in ("pos_equal_one", "neg_equal_one",
                                    "targets")}
    want = JaxGenCommLoss(HYPES["loss"]["args"])(
        dict({k: jnp.asarray(v) for k, v in out.items()},
             feature_mask=jnp.asarray(mask)),
        {k: jnp.asarray(v) for k, v in labels.items()})
    got = build_loss(HYPES["loss"])(
        dict({k: _t(v) for k, v in out.items()}, feature_mask=_t(mask)),
        {k: _t(v) for k, v in labels.items()})
    assert set(got) == set(want)
    for k in want:  # fp32 sums over ~1e3 anchors in another order
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    # the codebook loss is ported (tests/test_torch_baselines.py); the
    # gradient-matching criterion is not
    with pytest.raises(NotImplementedError):
        build_loss({"core_method": "point_pillar_gmatch_loss", "args": {}})


# ---------------------------------------------------------------- norms
def test_batchnorm_train_matches_flax():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 6, 8) * 2 + 1).astype(np.float32)
    r = rng.randn(*x.shape).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-3)
    variables = bn.init(jax.random.PRNGKey(0), x)
    variables = {"params": {"scale": 1 + 0.1 * rng.randn(8),
                            "bias": 0.1 * rng.randn(8)},
                 "batch_stats": {"mean": 0.1 * rng.randn(8),
                                 "var": 1 + 0.1 * np.abs(rng.randn(8))}}
    variables = jax.tree_util.tree_map(lambda v: np.float32(v), variables)

    def f(v, a):
        y, mut = bn.apply(v, a, mutable=["batch_stats"])
        return jnp.sum(y * r), (y, mut["batch_stats"])

    (gv, gx), (y, stats) = jax.grad(f, argnums=(0, 1), has_aux=True)(
        variables, jnp.asarray(x))
    port = BatchNorm(8)
    port.load_state_dict(flax_to_state_dict(port, variables))
    port.train()
    xt = _t(x).requires_grad_()
    yt = port(xt)
    (yt * _t(r)).sum().backward()
    # fp32 reductions over 90 values in another order
    _close(yt.detach().numpy(), y, 1e-5, "y")
    _close(port.running_mean.numpy(), stats["mean"], 1e-6, "mean")
    _close(port.running_var.numpy(), stats["var"], 1e-6, "var")
    _close(xt.grad.numpy(), gx, 1e-4, "dx")
    _close(port.weight.grad.numpy(), gv["params"]["scale"], 1e-4, "dscale")
    port.eval()
    bn_eval = fnn.BatchNorm(use_running_average=True, momentum=0.99,
                            epsilon=1e-3)
    with torch.no_grad():
        _close(port(_t(x)).numpy(), bn_eval.apply(
            {"params": variables["params"], "batch_stats": stats}, x),
            1e-5, "eval after update")


@pytest.mark.parametrize("n_valid", [37, 0])
def test_masked_batchnorm_train_matches_jax(n_valid):
    rng = np.random.RandomState(n_valid)
    x = (rng.randn(64, 8) * 3 - 1).astype(np.float32)
    valid = np.zeros(64, bool)
    valid[rng.choice(64, n_valid, replace=False)] = True
    r = rng.randn(*x.shape).astype(np.float32)
    mbn = JaxMaskedBN()
    variables = {"params": {"scale": np.float32(1 + 0.1 * rng.randn(8)),
                            "bias": np.float32(0.1 * rng.randn(8))},
                 "batch_stats": {"mean": np.float32(0.1 * rng.randn(8)),
                                 "var": np.float32(1 + np.abs(rng.randn(8)))}}

    def f(v, a):
        y, mut = mbn.apply(v, a, jnp.asarray(valid), True,
                           mutable=["batch_stats"])
        return jnp.sum(y * r), (y, mut["batch_stats"])

    (gv, gx), (y, stats) = jax.grad(f, argnums=(0, 1), has_aux=True)(
        variables, jnp.asarray(x))
    port = MaskedBatchNorm(8)
    port.load_state_dict(flax_to_state_dict(port, variables))
    port.train()
    xt = _t(x).requires_grad_()
    yt = port(xt, _t(valid))
    (yt * _t(r)).sum().backward()
    _close(yt.detach().numpy(), y, 1e-5, "y")
    _close(port.running_mean.numpy(), stats["mean"], 1e-6, "mean")
    _close(port.running_var.numpy(), stats["var"], 1e-6, "var")
    _close(xt.grad.numpy(), gx, 1e-4, "dx")
    _close(port.bias.grad.numpy(), gv["params"]["bias"], 1e-5, "dbias")


# ---------------------------------------------------------------- optimizer
def test_lr_schedule_matches_optax_at_its_boundaries():
    spe = 7
    want = jax_trainer.make_lr_schedule(HYPES, steps_per_epoch=spe)
    got = make_lr_schedule(HYPES, steps_per_epoch=spe)
    for count in (0, 1, 69, 70, 71, 104, 105, 106, 500):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6,
                                   err_msg=str(count))
    opt, sched = make_optimizer(
        HYPES, [("w", torch.nn.Parameter(torch.zeros(1)))],
        steps_per_epoch=spe)
    for count in range(107):
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   float(want(count)), rtol=1e-6)
        opt.step()
        sched.step()


@pytest.mark.parametrize("weight_decay", [1e-4, 0.0])  # optax adamw / adam
def test_adamw_updates_match_optax_across_a_boundary(weight_decay):
    hypes = dict(HYPES, lr_scheduler={"core_method": "multistep",
                                      "gamma": 0.1, "step_size": [2, 4]},
                 optimizer={"core_method": "Adam", "lr": 0.002, "args": {
                     "eps": 1e-10, "weight_decay": weight_decay}})
    rng = np.random.RandomState(0)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * 10.0 ** rng.randint(-4, 1)).astype(np.float32)
              for s in shapes] for _ in range(6)]
    tx = jax_trainer.make_optimizer(hypes)
    jp = [jnp.asarray(p) for p in params0]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(_t(p.copy())) for p in params0]
    opt, sched = make_optimizer(hypes, [(str(i), p) for i, p in
                                        enumerate(tp)])
    for gs in grads:
        updates, state = tx.update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, gs):
            p.grad = _t(g)
        opt.step()
        sched.step()
    for p, q in zip(tp, jp):  # fp32 moments and square roots: 1e-6
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(q),
                                   rtol=1e-6, atol=1e-7)


def test_unported_training_options_raise():
    # freezing (a frozen predicate) is ported: tests/test_torch_workflow.py
    # so is supervise_single: tests/test_torch_pyramid.py
    model = HeterModel(**MODEL_KW, device="cpu")
    # BackAlign's freeze is ported (tests/test_torch_baselines.py)
    assert backalign_frozen_modules(
        {"model": {"args": {"ego_modality": "m2"}}}) == [
            "fusion_net", "heads", "branch_m2"]
    # distillation is ported: tests/test_torch_fusion.py
    with pytest.raises(NotImplementedError):
        make_gmatch_train_step(model)
    assert not model.training  # built in eval()


def test_flax_grads_to_torch_maps_layouts_and_raises_on_key_mismatch():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 6, 8).astype(np.float32)
    jheads = JaxHeads(2, 2, 1)
    params = jheads.init(jax.random.PRNGKey(0), x)["params"]
    grads = jax.grad(lambda p: sum(jnp.sum(o ** 2) for o in jheads.apply(
        {"params": p}, x)))(params)
    grads = jax.tree_util.tree_map(np.array, grads)
    heads = DetectionHeads(8, 2, 2)
    heads.load_state_dict(flax_to_state_dict(heads, {"params": params}))
    xt = _t(x).requires_grad_()
    sum((o ** 2).sum() for o in heads(xt)).backward()
    got = flax_grads_to_torch(heads, grads)
    assert set(got) == {n for n, _ in heads.named_parameters()}
    for name, p in heads.named_parameters():
        _close(p.grad.numpy(), got[name].numpy(), 1e-5, name)
    with pytest.raises(KeyError, match="stray_head"):
        flax_grads_to_torch(heads, dict(grads, stray_head={
            "kernel": np.zeros((1, 1, 8, 2), np.float32)}))
    with pytest.raises(KeyError, match="dir_head"):
        flax_grads_to_torch(heads, {k: v for k, v in grads.items()
                                    if k != "dir_head"})


# ---------------------------------------------------------------- the slice
def _random_variables(shapes, seed):
    """numpy values for a flax variables tree: He-scaled kernels, norm
    scales near 1, small biases, running statistics near (0, 1)."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        n = rng.randn(*s.shape).astype(np.float32)
        if name in ("scale",):
            return 1.0 + 0.1 * n
        if name in ("bias", "dcn_bias", "mean"):
            return 0.1 * n
        if name == "var":
            return 1.0 + 0.1 * np.abs(n)
        fan_in = int(np.prod(s.shape[:-1])) or 1
        return n * np.float32((2.0 / fan_in) ** 0.5)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def train_step_run():
    """One train step of the small GenComm model in both packages: the same
    batch (2 samples x 2 agents, labels), weights and diffusion noise."""
    cfg = SyntheticConfig(lidar_range=LR, max_cav=5, num_agents=2,
                          points_per_agent=3000, num_vehicles=6,
                          points_per_vehicle=60, comm_range=12.0)
    host = trim_agent_slots(SyntheticScenes(cfg).sample(seed=3, batch_size=2))
    # the labels' first two axes (2, H' = 10) must not look like (B, L)
    assert host["pos_equal_one"].shape[1] != 5
    batch = decorate_modality(host, PillarVoxelizer(LR, VOXEL))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JaxHeterModel(**MODEL_KW, fusion_args={"att": {"feat_dim": 32}},
                           in_head=32)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        b, train=False), jbatch)
    variables = _random_variables(shapes, seed=0)
    n_slots = batch["agent_mask"].size
    noise_rng = np.random.RandomState(7)
    noises = [noise_rng.randn(n_slots, 10, 20, 32).astype(np.float32)
              for _ in range(3)]
    criterion = JaxGenCommLoss(HYPES["loss"]["args"])

    def loss_fn(params):
        out, mutated = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jbatch, train=True, mutable=["batch_stats"],
            rngs={"diffusion": jax.random.PRNGKey(0)})
        losses = criterion(out, jbatch)
        return losses["total_loss"], (losses, mutated["batch_stats"])

    replay = iter(noises)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal",
                   lambda key, shape, dtype=jnp.float32: jnp.asarray(
                       next(replay)).reshape(shape).astype(dtype))
        grads, (jlosses, jstats) = jax.jit(jax.grad(loss_fn, has_aux=True))(
            variables["params"])
    tx = jax_trainer.make_optimizer(HYPES)
    updates, _ = tx.update(grads, tx.init(variables["params"]),
                           variables["params"])
    jparams = optax.apply_updates(variables["params"], updates)

    model = HeterModel(**MODEL_KW, device="cpu")
    model.load_state_dict(flax_to_state_dict(model, variables))
    opt, sched = make_optimizer(HYPES, model.named_parameters())
    step = make_train_step(model, build_loss(HYPES["loss"]), opt, sched)
    tbatch = batch_to_device(batch, "cpu")
    tnoises = [torch.from_numpy(n) for n in noises]
    real_canvas = point_pillar.pillar_canvas
    port_canvas = []

    def recorded_canvas(*args):
        port_canvas.append(real_canvas(*args))
        return port_canvas[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(point_pillar, "pillar_canvas", recorded_canvas)
        losses = step(tbatch, noises=tnoises)

    # the same gradients again, with the canvas values of the JAX encoder
    # (a few may differ by one bf16 ulp, see the gradient test)
    enc = {c: variables[c]["branch_m1"]["encoder"]
           for c in ("params", "batch_stats")}
    jcanvas, _ = JaxEncoder(voxel_size=VOXEL, lidar_range=LR,
                            num_filters=(16,)).apply(
        enc, None, None, True, decorated=jbatch["decorated_m1"],
        gids=jbatch["gids_m1"], dvalid=jbatch["dvalid_m1"],
        mutable=["batch_stats"])
    jcanvas = torch.from_numpy(np.array(jcanvas.astype(jnp.float32))).to(
        torch.bfloat16).reshape(port_canvas[0].shape)

    def jax_valued_canvas(*args):
        out = real_canvas(*args)
        return out + (jcanvas - out).detach()

    same_canvas = HeterModel(**MODEL_KW, device="cpu")
    same_canvas.load_state_dict(flax_to_state_dict(same_canvas, variables))
    same_canvas.train()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(point_pillar, "pillar_canvas", jax_valued_canvas)
        out = same_canvas(tbatch, noises=tnoises)
    build_loss(HYPES["loss"])(out, tbatch)["total_loss"].backward()
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return SimpleNamespace(
        model=model, losses=losses, opt=opt, same_canvas=same_canvas,
        canvas_flips=int((port_canvas[0].detach() != jcanvas).sum()),
        canvas_size=jcanvas.numel(),
        jlosses={k: float(v) for k, v in jlosses.items()},
        jgrads=flax_grads_to_torch(model, to_np(grads)),
        jstate=flax_to_state_dict(model, {"params": to_np(jparams),
                                          "batch_stats": to_np(jstats)}))


def test_train_step_losses_match_jax(train_step_run):
    run = train_step_run
    assert set(run.losses) == set(run.jlosses)
    for k, want in run.jlosses.items():
        # fp32 through ~40 layers, three UNet passes and their batch
        # statistics, in another summation order: 1e-4 relative
        np.testing.assert_allclose(float(run.losses[k]), want, rtol=1e-4,
                                   err_msg=k)


def _worst_grad_error(model, jgrads):
    """max over parameters of max|port - jax| / max|jax|."""
    worst = []
    for name, p in model.named_parameters():
        want = jgrads[name].numpy()
        scale = float(np.abs(want).max())
        assert scale > 0, f"{name} has no gradient in JAX"
        worst.append((float(np.abs(p.grad.numpy() - want).max()) / scale,
                      name))
    return max(worst)


def test_train_step_gradients_match_jax(train_step_run):
    run = train_step_run
    # the train-mode batch statistics of the PFN are summed in another
    # order, so a few pillar values round to neighbouring bf16 values
    # (5 of 204,800 here, one ulp = 0.4-0.8 %); the network's gradients
    # answer with up to ~2.5e-3 of their largest entry (1e-4 under a 1e-7
    # jitter of the input). Held to 5e-3 as they are ...
    assert 0 < run.canvas_flips <= 1e-4 * run.canvas_size
    err, name = _worst_grad_error(run.model, run.jgrads)
    assert err <= 5e-3, (err, name)
    # ... and to 1e-3 with the JAX canvas values (observed 5e-4: fp32 sums
    # in another order, and the ties the backward finds at the flipped
    # cells)
    err, name = _worst_grad_error(run.same_canvas, run.jgrads)
    assert err <= 1e-3, (err, name)


def test_train_step_running_stats_match_jax(train_step_run):
    run = train_step_run
    buffers = dict(run.model.named_buffers())
    assert len(buffers) > 0
    for name, t in buffers.items():
        _close(t.numpy(), run.jstate[name].numpy(), 1e-4, name)


def test_train_step_adamw_update_matches_optax(train_step_run):
    run = train_step_run
    lr = 0.002
    for name, p in run.model.named_parameters():
        want = run.jstate[name].numpy()
        got = p.detach().numpy()
        # the first Adam step moves each weight by ~lr * sign(grad) plus the
        # decay: where a gradient is below 1e-2 of its tensor's largest
        # entry (twice the gradient tolerance), its sign may differ
        g = run.jgrads[name].numpy()
        settled = np.abs(g) > 1e-2 * np.abs(g).max()
        np.testing.assert_allclose(got[settled], want[settled], rtol=0,
                                   atol=1e-6 + 1e-4 * lr, err_msg=name)
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 * lr + 1e-6,
                                   err_msg=name)
    assert run.opt.param_groups[0]["lr"] == lr
