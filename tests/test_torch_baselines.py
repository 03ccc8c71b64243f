"""The paper's heterogeneous baselines in the port against the JAX package,
on the CPU: BackAlign, CodeFilling, MPDA and STAMP (``adapterconvnext``).

The same seeded numpy inputs and the same weights (``weights.py`` carries
flax's variables) go through both packages:

- module by module: ``UMGMQuantizer`` at eval and in training (the Gumbel
  noise injected on both sides), every MPDA block (window and grid
  attention, the window-grid encoder, window and grid cross-attention,
  the leaky residual block at eval and in training, the learnable resizer
  on a growing map, the cross-domain encoder, the domain head and the
  gradient reversal's -9.1), ``ConvNeXtBlock``, ``_resize_and_fit`` on a
  shrink, a growth and a crop, ``StampAdapter``'s four methods and the
  three losses; outputs within 1e-4 x max(1, |ref|), gradients of a fixed
  random projection within 2e-3 of each one's largest entry;
- model by model: a narrowed yaml of each core (2 agents in 3 slots, 32
  channels, a 16 x 32 map that MPDA's windows of 8 divide; the camera
  modality replaced by a second, narrower pillar branch, whose JAX compile
  is short) at eval, and one train step with the method's loss and freeze
  against ``jax.grad``: losses within 1e-4 relative, each trainable
  parameter's gradient within 2e-3 of its largest entry. BackAlign's
  eval-time corruption and the codebook's Gumbel noise are injected:
  ``jax.random`` is patched for the test, the port's draw functions too;
- each freeze schedule's trainable set, ``heal_tools merge-final``, the
  inference report's code bytes per stage against the JAX package's
  ``code_stream_bytes``, the refusals that name ROADMAP item 16
  (``adapterdsa``, ``seg_head_args``, ``gmatch``), and suspected reference
  fault p: DAIR-V2X's MPDA map is not divided by its windows.

JAX is imported by the ``jx`` fixture.
"""

import argparse
import copy
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

from gencomm_tpu_torch.config import yaml_utils
from gencomm_tpu_torch.data.bucketing import trim_agent_slots
from gencomm_tpu_torch.loss import create_loss
from gencomm_tpu_torch.loss.point_pillar_loss import (
    AdapterLoss, PointPillarCodebookLoss, PointPillarMPDALoss,
)
from gencomm_tpu_torch.models import codebook, create_model, heter_baseline
from gencomm_tpu_torch.models import mpda
from gencomm_tpu_torch.models.aligners import ConvNeXtBlock
from gencomm_tpu_torch.models.heter_baseline import model_kwargs
from gencomm_tpu_torch.models.stamp import StampAdapter, _resize_and_fit
from gencomm_tpu_torch.pipeline import batch_to_device
from gencomm_tpu_torch.tools import heal_tools
from gencomm_tpu_torch.tools import train as train_cli
from gencomm_tpu_torch.tools.inference import comm_report
from gencomm_tpu_torch.train import checkpoint
from gencomm_tpu_torch.train.trainer import make_optimizer, make_train_step
from gencomm_tpu_torch.weights import flax_grads_to_torch, flax_to_state_dict

from tests.test_torch_kernels import _close, _t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINES = "configs/opv2v/baselines/stage2"
CONFIGS = {"backalign": f"{BASELINES}/backalign/m1m2_att.yaml",
           "codefilling": f"{BASELINES}/codefilling/m1m2_att.yaml",
           "mpda": f"{BASELINES}/mpda/m1m2_att.yaml",
           "stamp": f"{BASELINES}/stamp/m0m2_att.yaml"}
# 51.2 x 25.6 m at 0.4 m: a 128 x 64 canvas, heads on a 16 x 32 map
RANGE16 = [-25.6, -12.8, -3.0, 25.6, 12.8, 1.0]
TOL = 1e-4  # outputs: fp32 sums in other orders
LOSS_RTOL = 1e-4
GRAD_TOL = 2e-3  # of a gradient's largest entry (as test_torch_second.py)
# gradients that are zero in exact arithmetic: a shift of every key of a
# query (the key projection's and its norm's bias) moves no softmax, and a
# conv bias before a batch norm in training moves no output
EXACT_ZERO = ("norm_k.bias", "to_k.bias")


def _before_bn(model):
    """The conv biases of MPDA's leaky residual blocks, each before a batch
    norm."""
    return {f"{n}.{c}.bias".lstrip(".") for n, m in model.named_modules()
            if isinstance(m, mpda.ResidualBlockLeaky)
            for c in ("Conv_0", "Conv_1")}


@pytest.fixture(scope="module")
def jx():
    """The JAX side: jax, jnp and the modules the tests compare against."""
    import jax
    import jax.numpy as jnp

    from gencomm_tpu.config import yaml_utils as jax_yaml
    from gencomm_tpu.data.decorate import host_decorate_pillars
    from gencomm_tpu.data.synthetic import (
        SyntheticConfig as JaxSyntheticConfig, SyntheticScenes as JaxScenes,
    )
    from gencomm_tpu.loss import create_loss as jax_create_loss
    from gencomm_tpu.loss import point_pillar_loss as jax_losses
    from gencomm_tpu.models import aligners as jax_aligners
    from gencomm_tpu.models import codebook as jax_codebook
    from gencomm_tpu.models import create_model as jax_create_model
    from gencomm_tpu.models import mpda as jax_mpda
    from gencomm_tpu.models import stamp as jax_stamp
    from gencomm_tpu.models.fuse import where2comm as jax_where2comm
    from gencomm_tpu.utils.misc_utils import code_stream_bytes

    from tests.test_torch_train import _random_variables

    return SimpleNamespace(**locals())


def _np_tree(jx, tree):
    return jx.jax.tree_util.tree_map(np.asarray, tree)


def _positive_temperatures(jx, variables):
    """The codebook temperatures near their init of 1 (the random tree
    draws them around 0, where the floor at 1e-6 flattens the logits)."""
    rng = np.random.RandomState(99)

    def leaf(path, v):
        if path[-1].key.startswith("temperature_"):
            return (1.0 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        return v

    return jx.jax.tree_util.tree_map_with_path(leaf, variables)


def _replay(arrays):
    """A stand-in for a jax.random draw that returns the next array."""
    import jax.numpy as jnp

    it = iter(arrays)
    return lambda key, shape=(), dtype=None, *a, **k: jnp.asarray(
        next(it)).reshape(shape)


def _as64(jx, variables, batch):
    """Variables and batch as JAX's fp64 arrays (under ``enable_x64``):
    the reference the port's fp32 models are held to. JAX's own fp32 eval
    lies up to ~1.3e-4 of the heads' scale from its fp64 one at these
    random weights (BackAlign's noise of std 3 into the attentive fusion's
    softmax, CodeFilling's three stages), above the tolerance, where the
    port's fp32 lies within ~5e-6 of the port's fp64."""
    jnp = jx.jnp
    v = jx.jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                  variables)
    jb = {k: jnp.asarray(a, jnp.float64) if a.dtype == np.float32
          else jnp.asarray(a) for k, a in batch.items()}
    return v, jb


def _port_replay(arrays):
    it = iter(arrays)
    return lambda shape, generator, device: _t(next(it)).reshape(
        tuple(shape)).to(device)


# ------------------------------------------------------------ modules
def _module_case(jx, jmod, jargs, tmod_fn, seed=0, train=None):
    """The flax module ``jmod`` on ``jargs`` (numpy) with random variables,
    and the port's module (``tmod_fn()``) with them carried across: the
    forward, then the gradient of sum(out * proj) by the inputs and every
    parameter against ``jax.grad``. ``train`` (None: the module takes no
    such argument) selects batch statistics."""
    jax, jnp = jx.jax, jx.jnp
    kw = {} if train is None else {"train": train}
    shapes = jax.eval_shape(lambda *a: jmod.init(jax.random.PRNGKey(0), *a,
                                                 **kw), *jargs)
    variables = _np_tree(jx, jx._random_variables(shapes, seed))
    tmod = tmod_fn()
    tmod.load_state_dict(flax_to_state_dict(tmod, variables))
    tmod.train(bool(train))
    targs = [_t(a) for a in jargs]

    def japply(params, *a):
        v = dict(variables, params=params)
        if train:
            return jmod.apply(v, *a, **kw, mutable=["batch_stats"])[0]
        return jmod.apply(v, *a, **kw)

    tins = [a.clone().requires_grad_(a.is_floating_point()) for a in targs]
    tout = tmod(*tins)
    proj = np.random.RandomState(seed + 1).randn(*tout.shape).astype(
        np.float32)

    def loss(params, *a):
        out = japply(params, *a)
        return jnp.sum(out * proj), out

    jg, jout = jax.jit(jax.grad(loss, argnums=tuple(range(1 + len(jargs))),
                                has_aux=True))(
        variables["params"], *[jnp.asarray(a) for a in jargs])
    _close(tout.detach(), np.asarray(jout), TOL, type(tmod).__name__)
    (tout * _t(proj)).sum().backward()
    for i, (t, want) in enumerate(zip(tins, jg[1:])):
        if t.grad is not None:
            _grad_close(t.grad, np.asarray(want), f"input {i}")
    want = flax_grads_to_torch(tmod, _np_tree(jx, jg[0]))
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    before_bn = _before_bn(tmod) if train else set()
    for name, p in tmod.named_parameters():
        if name.endswith(EXACT_ZERO) or name in before_bn:
            # zero in exact arithmetic: both sides hold cancellation noise
            for g in (p.grad.numpy(), want[name].numpy()):
                assert float(np.abs(g).max()) <= 1e-5 * top, name
            continue
        _grad_close(p.grad, want[name].numpy(), name)


def _grad_close(got, want, what):
    scale = float(np.abs(want).max())
    assert scale > 0, what
    err = float(np.abs(np.asarray(got, np.float32) - want).max()) / scale
    assert err <= GRAD_TOL, (what, err)


def _x(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_codebook_matches_jax(jx, train, monkeypatch):
    """UMGMQuantizer at eval (nearest codes) and in training (Gumbel
    straight-through, the same noise on both sides): restored feature,
    codes equal as integers, the loss, and in training the gradients."""
    jax, jnp = jx.jax, jx.jnp
    x = _x(1, (96, 32))
    jmod = jx.jax_codebook.UMGMQuantizer(32, 2, (8, 8, 8))
    shapes = jax.eval_shape(lambda a: jmod.init(jax.random.PRNGKey(0), a), x)
    variables = _positive_temperatures(
        jx, _np_tree(jx, jx._random_variables(shapes, 2)))
    noise = [_x(10 + i, (96, 2, 8)) for i in range(3)]
    tmod = codebook.UMGMQuantizer(32, 2, (8, 8, 8))
    tmod.load_state_dict(flax_to_state_dict(tmod, variables))
    tmod.train(train)
    monkeypatch.setattr(codebook, "gumbel", _port_replay(noise))
    xt = _t(x).requires_grad_(True)
    restored, codes, loss = tmod(xt)

    def run(params, a):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "gumbel", _replay(noise))
            return jmod.apply({"params": params}, a, train,
                              rngs={"dropout": jax.random.PRNGKey(3)})

    jr, jcodes, jloss = jax.jit(run)(variables["params"], jnp.asarray(x))
    _close(restored.detach(), np.asarray(jr), TOL, "restored")
    for i, (a, b) in enumerate(zip(codes, jcodes)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), str(i))
    assert len({int(c) for c in codes[0].reshape(-1)}) > 1
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    if not train:
        return
    proj = _x(5, jr.shape)

    def objective(params, a):
        r, _, lo = run(params, a)
        return jnp.sum(r * proj) + lo

    jg = jax.jit(jax.grad(objective, argnums=(0, 1)))(variables["params"],
                                                       jnp.asarray(x))
    ((restored * _t(proj)).sum() + loss).backward()
    _grad_close(xt.grad, np.asarray(jg[1]), "x")
    want = flax_grads_to_torch(tmod, _np_tree(jx, jg[0]))
    for name, p in tmod.named_parameters():
        if float(np.abs(want[name].numpy()).max()) > 0:
            _grad_close(p.grad, want[name].numpy(), name)


MAP = (2, 16, 32, 32)  # N, H, W, C


def _mpda_cases(jx):
    jm = jx.jax_mpda
    x, y = _x(3, MAP), _x(4, MAP)
    small = _x(5, (2, 8, 16, 32))
    return {
        "window_mhsa": (jm.WindowMHSA(32, 16, 8), [x],
                        lambda: mpda.WindowMHSA(32, 16, 8), None),
        "grid_mhsa": (jm.WindowMHSA(32, 16, 8, grid=True), [x],
                      lambda: mpda.WindowMHSA(32, 16, 8, grid=True), None),
        "window_grid_encoder": (jm.WindowGridEncoder(32, 1, 16, 8), [x],
                                lambda: mpda.WindowGridEncoder(32, 1, 16, 8),
                                None),
        "cross_window": (jm.WindowCrossAttention(32, 2, 16, 8), [x, y],
                         lambda: mpda.WindowCrossAttention(32, 2, 16, 8),
                         None),
        "cross_grid": (jm.WindowCrossAttention(32, 2, 16, 4, grid=True),
                       [x, y], lambda: mpda.WindowCrossAttention(
                           32, 2, 16, 4, grid=True), None),
        "residual_eval": (jm.ResidualBlockLeaky(32), [x],
                          lambda: mpda.ResidualBlockLeaky(32), False),
        "residual_train": (jm.ResidualBlockLeaky(32), [x],
                           lambda: mpda.ResidualBlockLeaky(32), True),
        # the collaborator's 8 x 16 map grows to the ego's 16 x 32
        "resizer_growth": (jm.LearnableResizer(32, window_size=4), [x, small],
                           lambda: mpda.LearnableResizer(32, 32,
                                                         window_size=4),
                           True),
        "cross_domain": (jm.CrossDomainFusionEncoder(32, 1, 16, 2, 8),
                         [x, y], lambda: mpda.CrossDomainFusionEncoder(
                             32, 1, 16, 2, 8), None),
        "da_head": (jm.DAImgHead(), [x], lambda: mpda.DAImgHead(32), None),
    }


MPDA_CASES = ["window_mhsa", "grid_mhsa", "window_grid_encoder",
              "cross_window", "cross_grid", "residual_eval", "residual_train",
              "resizer_growth", "cross_domain", "da_head"]


@pytest.mark.parametrize("case", MPDA_CASES)
def test_mpda_block_matches_jax(jx, case):
    jmod, args, tfn, train = _mpda_cases(jx)[case]
    _module_case(jx, jmod, args, tfn, train=train)


def test_gradient_reversal_scales_by_minus_9_1(jx):
    x = _t(_x(6, (3, 4))).requires_grad_(True)
    g = _t(_x(7, (3, 4)))
    out = mpda.gradient_scale(x, mpda.GRL_WEIGHT)
    assert torch.equal(out, x)
    out.backward(g)
    assert torch.equal(x.grad, -9.1 * g)
    jg = jx.jax.grad(lambda a: jx.jnp.sum(
        jx.jax_mpda.gradient_scale(a, -9.1) * g.numpy()))(x.detach().numpy())
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-7)


def test_convnext_block_matches_jax(jx):
    _module_case(jx, jx.jax_aligners.ConvNeXtBlock(32, kernel_size=7),
                 [_x(8, MAP)], lambda: ConvNeXtBlock(32, kernel_size=7))


@pytest.mark.parametrize("in_range,hw,out_hw", [
    ((-51.2, -25.6, -3, 51.2, 25.6, 1), (32, 64), (16, 32)),  # shrink
    ((-12.8, -6.4, -3, 12.8, 6.4, 1), (8, 16), (16, 32)),  # growth
    ((-51.2, -25.6, -3, 51.2, 25.6, 1), (16, 32), (16, 32)),  # crop
], ids=["shrink", "growth", "crop"])
def test_resize_and_fit_matches_jax(jx, in_range, hw, out_hw):
    """On the protocol range 51.2 x 25.6 m; jax.image.resize antialiases a
    shrink, which F.interpolate would not."""
    x = _x(9, (2,) + hw + (5,))
    want = jx.jax_stamp._resize_and_fit(jx.jnp.asarray(x), in_range,
                                        tuple(RANGE16), out_hw)
    got = _resize_and_fit(_t(x), in_range, tuple(RANGE16), out_hw)
    assert got.shape == (2,) + out_hw + (5,)
    _close(got, np.asarray(want), 1e-6, "fit")


@pytest.mark.parametrize("method", ["identity", "adapterconvnext",
                                    "adapterconv", "adapterfc"])
def test_stamp_adapter_matches_jax(jx, method):
    cfg = {"core_method": method,
           "args": {"in_channels": 32, "out_channels": 24 if method ==
                    "identity" else 32, "dim": 16, "num_of_blocks": 2}}
    in_range = (-12.8, -6.4, -3, 12.8, 6.4, 1)
    jmod = jx.jax_stamp.StampAdapter.from_config(cfg, in_range,
                                                 tuple(RANGE16), (16, 32))
    x = _x(10, (2, 8, 16, 32))
    if method == "identity":
        got = StampAdapter.from_config(cfg, in_range, RANGE16)(_t(x),
                                                               (16, 32))
        want = jmod.apply({}, jx.jnp.asarray(x))
        _close(got, np.asarray(want), 1e-6, method)
        return

    _module_case(jx, jmod, [x], lambda: _FitTo(StampAdapter.from_config(
        cfg, in_range, RANGE16), (16, 32)))


class _FitTo(torch.nn.Module):
    """An adapter at a fixed protocol grid, parameters at the top level as
    the flax module's are."""

    def __init__(self, adapter, out_hw):
        super().__init__()
        self.out_hw = out_hw
        for name, mod in adapter.named_children():
            self.add_module(name, mod)
        self.__dict__["adapter"] = adapter

    def forward(self, x):
        return self.adapter(x, self.out_hw)


def test_baseline_losses_match_jax(jx):
    rng = np.random.RandomState(11)
    b, l, h, w = 2, 3, 4, 8
    det = {"cls_preds": rng.randn(b, h, w, 2), "reg_preds": rng.randn(
        b, h, w, 14), "dir_preds": rng.randn(b, h, w, 4)}
    tgt = {"pos_equal_one": (rng.rand(b, h, w, 2) > 0.9) * 1.0,
           "neg_equal_one": (rng.rand(b, h, w, 2) > 0.3) * 1.0,
           "targets": rng.randn(b, h, w, 14),
           "agent_mask": np.array([[1, 1, 0], [1, 1, 1]], bool)}
    args = yaml.safe_load(open(os.path.join(REPO, CONFIGS["mpda"])))[
        "loss"]["args"]
    out = dict(det, codebook_loss=np.float64(0.37),
               da_feature=rng.randn(b, l, h, w, 1))
    stamp = {"stamp_FP": rng.randn(b, l, h, w, 3)}
    for m in ("m0", "m3"):
        for k in ("FM", "M2P", "M2P2M", "P2M"):
            stamp[f"stamp_{k}_{m}"] = rng.randn(b, l, h, w, 3)
    cases = [(PointPillarCodebookLoss, jx.jax_losses.PointPillarCodebookLoss,
              out, args), (PointPillarMPDALoss,
                           jx.jax_losses.PointPillarMPDALoss, out, args),
             (AdapterLoss, jx.jax_losses.AdapterLoss, stamp,
              {"alpha_P2M": 0.5, "alpha_M2P": 2.0})]
    for port_cls, jax_cls, o, a in cases:
        f32 = {k: np.asarray(v, np.float32) for k, v in o.items()}
        tg = {k: np.asarray(v, np.float32 if v.dtype != bool else bool)
              for k, v in tgt.items()}
        want = jx.jax.jit(jax_cls(a).__call__)(
            {k: jx.jnp.asarray(v) for k, v in f32.items()},
            {k: jx.jnp.asarray(v) for k, v in tg.items()})
        got = port_cls(a)({k: _t(v) for k, v in f32.items()},
                          {k: _t(v) for k, v in tg.items()})
        assert set(got) == set(want), port_cls.__name__
        assert {"codebook_loss", "da_loss", "P2M_m3"} & set(got)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=LOSS_RTOL, err_msg=k)


# -------------------------------------------------------------- models
def narrowed_baseline(method, **model_args):
    """A baseline yaml at RANGE16 and narrow widths: every modality a
    PointPillars branch (the camera one at 16 pillar features), 32
    channels, the codebook at 3 levels of 8 codes, MPDA's windows of 8,
    STAMP's adapters at 16 hidden channels and 2 blocks; ``model_args``
    go into ``model.args``."""
    with open(os.path.join(REPO, CONFIGS[method])) as fh:
        h = yaml.safe_load(fh)
    h["cav_lidar_range"] = list(RANGE16)
    h["preprocess"]["cav_lidar_range"] = list(RANGE16)
    h["postprocess"]["gt_range"] = list(RANGE16)
    h["postprocess"]["anchor_args"]["cav_lidar_range"] = list(RANGE16)
    h["train_params"].update(batch_size=2, max_cav=3, save_freq=1,
                             eval_freq=1)
    args = h["model"]["args"]
    args["lidar_range"] = list(RANGE16)
    filters = 16
    for m, c in list(args.items()):
        if not (isinstance(c, dict) and "encoder_args" in c):
            continue
        c["core_method"], c["sensor_type"] = "point_pillar", "lidar"
        c["encoder_args"] = {
            "voxel_size": [0.4, 0.4, 4], "lidar_range": list(RANGE16),
            "pillar_vfe": {"use_norm": True, "with_distance": False,
                           "use_absolute_xyz": True,
                           "num_filters": [filters]},
            "point_pillar_scatter": {"num_features": filters}}
        filters -= 4
        c.pop("camera_mask_args", None)
        c["backbone_args"] = {"layer_nums": [1, 1], "layer_strides": [2, 2],
                              "num_filters": [16, 32],
                              "upsample_strides": [1, 2],
                              "num_upsample_filter": [16, 16]}
        c["shrink_header"] = {"kernal_size": [3], "stride": [2],
                              "padding": [1], "dim": [32], "input_dim": 32}
        for side in ("adapter", "reverter"):
            if side in c:
                c[side]["args"] = {"in_channels": 32, "out_channels": 32,
                                   "dim": 16, "num_of_blocks": 2}
    args["att"] = {"feat_dim": 32}
    args["in_head"] = 32
    if "codebook" in args:
        args["codebook"]["dict_size"] = 8
    args.update(model_args)
    return h


def _scenes_batch(jx, hypes, seed, batch_size):
    """A decorated, labelled batch of the JAX sampler on RANGE16: 2 agents
    in 3 slots, one modality each (the ego the first)."""
    mods = {m: {"sensor": "lidar"} for m, c in hypes["model"]["args"].items()
            if isinstance(c, dict) and "encoder_args" in c}
    cfg = jx.JaxSyntheticConfig(
        lidar_range=tuple(RANGE16), max_cav=3, num_agents=2,
        points_per_agent=2000, num_vehicles=6, points_per_vehicle=60,
        comm_range=12.0, modalities=mods)
    host = jx.JaxScenes(cfg).sample(seed, batch_size)
    return jx.host_decorate_pillars(trim_agent_slots(host, buckets=(3,)),
                                    hypes)


def _build(jx, method, **model_args):
    raw = narrowed_baseline(method, **model_args)
    jh = jx.jax_yaml.update_yaml(copy.deepcopy(raw))
    ph = yaml_utils.update_yaml(copy.deepcopy(raw))
    batch = _scenes_batch(jx, jh, seed=3, batch_size=2)
    jbatch = {k: jx.jnp.asarray(v) for k, v in batch.items()}
    jmodel = jx.jax_create_model(jh)
    jax = jx.jax
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "diffusion": jax.random.PRNGKey(2)}, b, train=False), jbatch)
    variables = _positive_temperatures(
        jx, _np_tree(jx, jx._random_variables(shapes, 0)))
    model = create_model(ph, device="cpu")
    model.load_state_dict(flax_to_state_dict(model, variables))
    return SimpleNamespace(raw=raw, jh=jh, ph=ph, batch=batch, jbatch=jbatch,
                           jmodel=jmodel, variables=variables, model=model)


METHODS = ["backalign", "codefilling", "mpda", "stamp"]
# BackAlign's eval test turns its corruption on (no shipped yaml does)
EVAL_ARGS = {"backalign": {"missing_message": True}}


def _jax_run(jx, run, fn, fp64):
    """``fn(variables, batch)`` of the JAX package, jitted, in fp64 (under
    ``enable_x64``) or fp32; numpy results. In fp64 Where2comm's Gaussian
    (CodeFilling's comm mask) is its fp32 kernel's values in fp64, since
    ``lax.conv`` refuses an fp32 kernel on fp64 features."""
    jax = jx.jax
    if not fp64:
        return _np_tree(jx, jax.jit(fn)(run.variables, run.jbatch))
    real = jx.jax_where2comm.gaussian_kernel
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jx.jax_where2comm, "gaussian_kernel",
                   lambda *a, **k: real(*a, **k).astype(np.float64))
        return _np_tree(jx, jax.jit(fn)(*_as64(jx, run.variables,
                                                run.batch)))


@pytest.fixture(scope="module", params=METHODS)
def eval_run(request, jx):
    """One eval batch of each narrowed core through both packages, with
    BackAlign's drop and noise injected on both sides."""
    method = request.param
    run = _build(jx, method, **EVAL_ARGS.get(method, {}))
    jax = jx.jax
    b, l = run.batch["agent_mask"].shape
    rng = np.random.RandomState(5)
    uni = [rng.rand(b, l, 16, 32, 1).astype(np.float32)]
    nor = [rng.randn(b, l, 16, 32, 32).astype(np.float32)]

    def forward(v, bt):
        return run.jmodel.apply(v, bt, train=False, rngs={
            "dropout": jax.random.PRNGKey(7),
            "diffusion": jax.random.PRNGKey(8)})

    with pytest.MonkeyPatch.context() as mp:
        if method == "backalign":
            mp.setattr(jax.random, "uniform", _replay(uni))
            mp.setattr(jax.random, "normal", _replay(nor))
            mp.setattr(heter_baseline, "uniform", _port_replay(uni))
            mp.setattr(heter_baseline, "normal", _port_replay(nor))
        jout = _jax_run(jx, run, forward, True)
        with torch.inference_mode():
            tout = run.model(batch_to_device(run.batch, "cpu"),
                             generator=torch.Generator().manual_seed(0))
    run.method, run.jout, run.tout = method, jout, tout
    return run


def test_baseline_model_eval_matches_jax(eval_run):
    run = eval_run
    keys = ["cls_preds", "reg_preds", "dir_preds", "feature"]
    if run.method == "mpda":
        keys.append("da_feature")
    if run.method == "codefilling":
        keys.append("codebook_loss")
        np.testing.assert_array_equal(run.tout["codebook_codes"].numpy(),
                                      np.asarray(run.jout["codebook_codes"]))
        assert run.tout["codebook_codes"].shape == (2, 3, 3, 16 * 32 * 2)
        np.testing.assert_allclose(float(run.tout["comm_rate"]),
                                   float(run.jout["comm_rate"]), rtol=1e-6)
    for key in keys:
        want = np.asarray(run.jout[key], np.float32)
        assert np.abs(want).max() > 0, key
        _close(run.tout[key].numpy(), want, TOL, key)
    assert "message" not in run.tout  # no generation in these cores
    if run.method == "backalign":
        assert run.model.feature_noise_std == 3.0


def _trainable_modules(model):
    return sorted({n.partition(".")[0] for n, p in model.named_parameters()
                   if p.requires_grad})


@pytest.fixture(scope="module", params=METHODS)
def train_run(request, jx):
    """One train step of each narrowed core, the method's loss and freeze,
    against jax.grad of the JAX model and loss, in fp32 and in fp64, on the
    same weights, batch and Gumbel noise."""
    method = request.param
    run = _build(jx, method)
    jax = jx.jax
    b, l = run.batch["agent_mask"].shape
    rng = np.random.RandomState(6)
    gumbels = [rng.gumbel(size=(b * l * 16 * 32, 2, 8)).astype(np.float32)
               for _ in range(3)]
    criterion = jx.jax_create_loss(run.jh)

    def grads_fn(v, jb):
        def loss_fn(params):
            out, _ = run.jmodel.apply(
                {"params": params, "batch_stats": v["batch_stats"]},
                jb, train=True, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(0),
                      "diffusion": jax.random.PRNGKey(1)})
            losses = criterion(out, jb)
            return losses["total_loss"], losses

        return jax.grad(loss_fn, has_aux=True)(v["params"])

    def to_port(tree):
        return flax_grads_to_torch(run.model, jax.tree_util.tree_map(
            lambda a: a.astype(np.float32), tree))

    grads = {}
    for fp64 in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "gumbel", _replay(gumbels))
            grads[fp64], losses = _jax_run(jx, run, grads_fn, fp64)
        if not fp64:
            jlosses = losses
    frozen = train_cli.frozen_predicate(
        argparse.Namespace(freeze_prefixes=""), run.ph)
    model = run.model
    opt, sched = make_optimizer(run.ph, model.named_parameters(), 1, frozen)
    step = make_train_step(model, create_loss(run.ph), opt, sched,
                           frozen_predicate=frozen)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(codebook, "gumbel", _port_replay(gumbels))
        run.losses = step(batch_to_device(run.batch, "cpu"),
                          generator=torch.Generator().manual_seed(0))
    run.method, run.jlosses = method, jlosses
    run.jgrads, run.jgrads64 = to_port(grads[False]), to_port(grads[True])
    return run


def test_baseline_train_step_losses_match_jax(train_run):
    run = train_run
    assert set(run.losses) == set(run.jlosses)
    expect = {"codefilling": "codebook_loss", "mpda": "da_loss",
              "stamp": "P2M_m0", "backalign": "cls_loss"}[run.method]
    assert expect in run.losses
    for k, want in run.jlosses.items():
        np.testing.assert_allclose(float(run.losses[k]), float(want),
                                   rtol=LOSS_RTOL, err_msg=k)


def test_baseline_train_step_gradients_match_jax(train_run):
    """Each trainable parameter's gradient against JAX's fp64 gradient,
    within GRAD_TOL of its largest entry plus 3x JAX's own fp32 error of
    the tensor (tests/test_torch_pyramid.py's rule): MPDA's train-mode
    step through the gradient reversal is ill-conditioned at random
    weights, and JAX's own fp32 gradients of the window attentions'
    rel_pos_bias lie ~4e-3 of their largest entry from its fp64 ones, the
    port's ~5e-3. Gradients that are zero in exact arithmetic
    (EXACT_ZERO, a conv bias before a train-mode norm) are held below 1e-5
    of the largest gradient on both sides."""
    run = train_run
    ref = run.jgrads64
    before_bn = _before_bn(run.model)
    top = max(float(np.abs(g.numpy()).max()) for g in ref.values())
    checked = 0
    for name, p in run.model.named_parameters():
        if not p.requires_grad:
            continue
        exact = ref[name].numpy()
        if name.endswith(EXACT_ZERO) or name in before_bn:
            for g in (p.grad.numpy(), exact):
                assert float(np.abs(g).max()) <= 1e-5 * top, name
            continue
        scale = float(np.abs(exact).max())
        err = float(np.abs(p.grad.numpy() - exact).max())
        bound = GRAD_TOL * scale + 3.0 * float(
            np.abs(run.jgrads[name].numpy() - exact).max())
        assert err <= bound, (name, err / scale, bound / scale)
        checked += 1
    assert checked > 0


EXPECTED_TRAINABLE = {
    "backalign": ["branch_m2"],
    "codefilling": ["codebook"],
    "mpda": ["cdt", "classifier", "heads", "resizer"],
    "stamp": ["adapter_m0", "reverter_m0"],
}


def test_freeze_schedules_train_the_methods_modules(train_run):
    """Each method's trainable set after make_optimizer, in the JAX CLI's
    order of schedules (the att fusion has no parameters)."""
    assert _trainable_modules(train_run.model) == \
        EXPECTED_TRAINABLE[train_run.method]
    assert not any(n.startswith("fusion_net")
                   for n, _ in train_run.model.named_parameters())


def test_codebook_payload_report_matches_jax_code_bytes(jx):
    run = _build(jx, "codefilling")
    batch = batch_to_device({k: v[:1] for k, v in run.batch.items()}, "cpu")
    report = comm_report(run.model, batch, run.ph)
    assert report["payload"] == "codebook_codes"
    codes = run.model(batch)["codebook_codes"][0].numpy()
    senders = np.nonzero(run.batch["agent_mask"][0][1:])[0] + 1
    per_stage = report["code_bytes_per_stage"]
    assert len(per_stage) == 3
    for s, got in enumerate(per_stage):
        assert got == jx.code_stream_bytes(codes[senders][:, s], 8), s
    assert report["cpm_code_bytes_packed"] == sum(
        s["raw_bytes"] for s in per_stage)
    assert 0 <= report["comm_rate"] <= 1


def _state(seed, keys):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(3, generator=g) for k in keys}


def test_merge_final_unions_the_runs_later_winning(tmp_path):
    a = _state(0, ["branch_m1.w", "adapter_m0.w", "heads.w"])
    b = _state(1, ["adapter_m0.w", "reverter_m0.w"])
    checkpoint.save_checkpoint(str(tmp_path / "a"), a, 4, epoch=1)
    checkpoint.save_checkpoint(str(tmp_path / "b"), b, 4, epoch=1)
    target = heal_tools.main(["--device", "cpu", "merge-final", "--ckpts",
                              str(tmp_path / "a"), str(tmp_path / "b"),
                              "--out", str(tmp_path / "m")])
    merged = checkpoint.load_checkpoint(target)["state_dict"]
    assert set(merged) == set(a) | set(b)
    assert torch.equal(merged["adapter_m0.w"], b["adapter_m0.w"])
    assert torch.equal(merged["heads.w"], a["heads.w"])


def test_unported_branches_name_item_16(tmp_path):
    with pytest.raises(NotImplementedError, match="item 16"):
        StampAdapter.from_config({"core_method": "adapterdsa"}, RANGE16,
                                 RANGE16)
    h = narrowed_baseline("stamp")
    with pytest.raises(NotImplementedError, match="item 16"):
        model_kwargs(dict(h, model=dict(h["model"], args=dict(
            h["model"]["args"], seg_head_args={"target": "dynamic"}))))
    with pytest.raises(NotImplementedError, match="item 16"):
        model_kwargs(dict(h, loss={"core_method": "point_pillar_gmatch_loss",
                                   "args": {}}))
    path = tmp_path / "stamp.yaml"
    path.write_text(yaml.safe_dump(h))
    with pytest.raises(NotImplementedError, match="item 16"):
        train_cli.main(["-y", str(path), "--dataset", "synthetic",
                        "--trainer", "gmatch", "--device", "cpu"])


def test_fault_p_dairv2x_mpda_map_is_not_divided_by_its_windows(jx):
    """Suspected reference fault p (ROADMAP section 3): DAIR-V2X's MPDA
    yamls give a 50 x 126 map (201.6 x 80 m at 0.4 m, stride 4), which
    MPDA's windows of 8 do not divide: the JAX resizer fails in its window
    partition at init, and the port refuses the map with the reason."""
    hypes = yaml_utils.load_yaml(
        f"{REPO}/configs/dairv2x/baselines/stage2/mpda/m1m3_att.yaml")
    args = hypes["model"]["args"]
    lr, vs = args["lidar_range"], args["m1"]["encoder_args"]["voxel_size"]
    h, w = (round((lr[4] - lr[1]) / vs[1]) // 4,
            round((lr[3] - lr[0]) / vs[0]) // 4)
    assert (h, w) == (50, 126) and args["cdt"]["window_size"] == 8
    x = jx.jnp.zeros((1, h, w, 128), jx.jnp.float32)
    jm = jx.jax_mpda.LearnableResizer(128, window_size=8)
    with pytest.raises(TypeError, match="reshape"):
        jx.jax.eval_shape(jm.init, jx.jax.random.PRNGKey(0), x, x)
    port = mpda.LearnableResizer(128, 128, window_size=8)
    with pytest.raises(ValueError, match="do not divide the 50 x 126 map"):
        port(torch.zeros(1, h, w, 128), torch.zeros(1, h, w, 128))
