"""The remaining lidar encoders and legacy detectors of the port against the
JAX package, on the CPU: ``ops/voxel.py``, PointPillars' raw-point path,
VoxelNet, PIXOR and the legacy SECOND detectors.

The same seeded numpy inputs and the same weights (``weights.py`` carries
flax's variables) go through both packages:

- every function of ``ops/voxel.py`` against ``gencomm_tpu/ops/voxel.py``:
  pillar ids and validity exactly, a point at exactly z == z_max kept, the
  decorations bit for bit (both sum a pillar's points in point order), the
  canvas maxima exactly (ties among equal rows too) and their gradients
  against ``jax.vjp`` (equal shares to tied rows), the per-pillar cap;
- the raw-point ``PointPillarEncoder`` (eval and train: running statistics
  within 1e-6) and the raw path of a narrowed ``stage1/m1_att`` model;
- ``VoxelNetEncoder`` and a narrowed ``voxel_net.yaml`` model, PIXOR (the
  raster exactly, the model, the loss, ``decode_pixor``) on a narrowed
  ``pixor.yaml``, ``SecondModel`` plain and intermediate on narrowed
  ``second.yaml`` / ``second_intermediate.yaml``: outputs within 1e-4 x
  max(1, |ref|); one train step each (the legacy ``second`` core's as
  ``second_intermediate``'s) against ``jax.grad`` (losses within
  1e-4 relative, gradients within 2e-3 of their largest entry of JAX's
  gradient (PIXOR's, the GenComm step's and SECOND's: of its fp64
  gradient plus 3x JAX's own fp32 error; SECOND's encoder with the ReLU
  gates of JAX's fp64 step, the few that differ held to near-ties);
- the pipeline's decode of models without a direction head (SECOND) and
  of PIXOR's maps, ``run_stream`` equal to ``run``; the train CLI with
  ``--no_host_decorate`` and on the new yamls;
- reference faults s (PIXOR's loss and decode cell against its heads'
  grid) and t (the JAX pipeline cannot decode the legacy SECOND or PIXOR
  models: they have no ``dir_preds``).

JAX is imported by the ``jx`` fixture.
"""

import contextlib
import copy
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

from gencomm_tpu_torch.config import yaml_utils
from gencomm_tpu_torch.data.postprocessor import generate_anchor_box
from gencomm_tpu_torch.loss import create_loss
from gencomm_tpu_torch.models import create_model
from gencomm_tpu_torch.models.encoders import pixor as px
from gencomm_tpu_torch.models.encoders.point_pillar import PointPillarEncoder
from gencomm_tpu_torch.models.encoders.voxelnet import VoxelNetEncoder
from gencomm_tpu_torch.ops import voxel as vox
from gencomm_tpu_torch.pipeline import InferencePipeline, batch_to_device
from gencomm_tpu_torch.train.trainer import make_optimizer, make_train_step
from gencomm_tpu_torch.weights import flax_grads_to_torch, flax_to_state_dict

from tests.test_torch_kernels import _close, _t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANGE = (-16.0, -8.0, -3.0, 16.0, 8.0, 1.0)
OP_TOL = 1e-6
SLICE_TOL = 1e-4  # fp32 sums in other orders through a few layers
STATS_TOL = 1e-6
GRAD_TOL = 2e-3  # of a parameter's largest gradient entry
# the steps held against JAX's fp64 gradient: PIXOR's train-mode step is
# ill-conditioned at random weights (JAX's fp32 gradients lie up to 1.2e-2
# of their largest entry from the port's, which sums in another order), and
# the GenComm step's denoiser has biases whose gradients are zero but for
# fp32 cancellation; the others are held against JAX's fp32 gradient
FP64_REFERENCE = ("pixor", "m1_att_raw", "second_intermediate")
# the legacy SECOND step's ReLU gates after its encoder's masked norms that
# may open on one side and not on JAX's fp64 side, each a near-tie (one
# does, at |y| = 2.1e-7, on this test's batch)
GATE_FLIPS = 8
POSTPROCESS = {"gt_range": list(RANGE),
               "target_args": {"score_threshold": 0.2}, "nms_thresh": 0.15,
               "nms_topk": 64,
               "dir_args": {"dir_offset": 0.7853, "num_bins": 2}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one thread: the suite runs several workers on the
    machine's cores, where the many small operators of these narrowed
    models, each split over every core, wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX side: jax, jnp and the modules the tests compare against."""
    import jax
    import jax.numpy as jnp

    from gencomm_tpu.config import yaml_utils as jax_yaml
    from gencomm_tpu.data.synthetic import (
        SyntheticConfig as JaxSyntheticConfig, SyntheticScenes as JaxScenes,
    )
    from gencomm_tpu.loss import create_loss as jax_create_loss
    from gencomm_tpu.models import create_model as jax_create_model
    from gencomm_tpu.models.encoders import pixor as jpx
    from gencomm_tpu.models.encoders import point_pillar as jax_point_pillar
    from gencomm_tpu.models.encoders.point_pillar import (
        PointPillarEncoder as JaxPointPillarEncoder,
    )
    from gencomm_tpu.models.encoders.voxelnet import (
        VoxelNetEncoder as JaxVoxelNetEncoder,
    )
    from gencomm_tpu.ops import voxel as jvox

    from tests.test_torch_train import _random_variables, _worst_grad_error

    return SimpleNamespace(**locals())


def _points(seed, a=2, p=600, boundary=True):
    """(A, P, 4) points over RANGE and a bit beyond, a mask; some points on
    pillar edges, at exactly z_max and z_min, and many in a few pillars
    (ties)."""
    rng = np.random.RandomState(seed)
    lo, hi = np.array(RANGE[:3]), np.array(RANGE[3:])
    pts = np.concatenate([rng.uniform(lo - 1, hi + 1, (a, p, 3)),
                          rng.uniform(0, 1, (a, p, 1))], -1).astype(np.float32)
    if boundary:
        pts[:, :20, 0] = np.round(pts[:, :20, 0] / 0.4) * 0.4
        pts[:, 20:30, 2] = RANGE[5]
        pts[:, 30:40, 2] = RANGE[2]
        # a crowded pillar: equal points give equal rows (ties)
        pts[:, 40:60] = pts[:, 40:41]
    mask = rng.uniform(size=(a, p)) > 0.1
    return pts, mask


GRID = dict(pc_range=RANGE, voxel_size=(0.4, 0.4, 4.0), nx=80, ny=40)


def test_pillar_ids_keep_z_max_and_match_jax(jx):
    pts, mask = _points(0)
    jids, jvalid = jx.jvox.pillar_ids(pts, mask, **GRID)
    ids, valid = vox.pillar_ids(_t(pts), _t(mask), **GRID)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    # z == z_max is in range on the raw path (the numpy decorator drops it,
    # ROADMAP fault d); z == z_min too
    inside = (np.abs(pts[..., 0]) < 15) & (np.abs(pts[..., 1]) < 7) & mask
    assert valid.numpy()[:, 20:30][inside[:, 20:30]].all()
    assert valid.numpy()[:, 30:40][inside[:, 30:40]].all()


def test_pillar_decorate_matches_jax_bit_for_bit(jx):
    pts, mask = _points(1, a=1)
    ids, valid = jx.jvox.pillar_ids(pts[0], mask[0], **GRID)
    want = jx.jvox.pillar_decorate(pts[0], ids, valid, **GRID)
    got = vox.pillar_decorate(_t(pts[0]), _t(np.asarray(ids)),
                              _t(np.asarray(valid)), **GRID)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pillar_decorate_flat_matches_jax_bit_for_bit(jx):
    pts, mask = _points(2)
    want = jx.jvox.pillar_decorate_flat(pts, mask, **GRID)
    got = vox.pillar_decorate_flat(_t(pts), _t(mask), **GRID)
    for g, w, name in zip(got, want, ("feats", "gids", "valid", "counts")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("flat", [False, True])
def test_scatter_pillar_max_and_its_gradient_match_jax(jx, flat):
    """Maxima exactly; the gradient of a weighted sum of the canvas against
    jax.vjp, equal shares to tied rows (the crowded pillar's equal rows)."""
    jnp = jx.jnp
    pts, mask = _points(3, a=2 if flat else 1)
    a = pts.shape[0]
    rng = np.random.RandomState(4)
    if flat:
        _, gids, valid, _ = jx.jvox.pillar_decorate_flat(pts, mask, **GRID)
        n = a * pts.shape[1]
    else:
        gids, valid = jx.jvox.pillar_ids(pts[0], mask[0], **GRID)
        n = pts.shape[1]
    feats = np.maximum(rng.randn(n, 6), 0).astype(np.float32)
    feats[40:60] = feats[40]  # the crowded pillar's rows tie
    nx, ny = GRID["nx"], GRID["ny"]
    gids, valid = np.asarray(gids), np.asarray(valid)
    if flat:
        jfn = lambda f: jx.jvox.scatter_pillar_max_flat(  # noqa: E731
            f, gids, valid, a, nx, ny)
        tfn = lambda f: vox.scatter_pillar_max_flat(  # noqa: E731
            f, _t(gids), _t(valid), a, nx, ny)
    else:
        jfn = lambda f: jx.jvox.scatter_pillar_max(  # noqa: E731
            f, gids, valid, nx, ny)
        tfn = lambda f: vox.scatter_pillar_max(  # noqa: E731
            f, _t(gids), _t(valid), nx, ny)
    want, vjp = jx.jax.vjp(jfn, jnp.asarray(feats))
    g = rng.randn(*want.shape).astype(np.float32)
    (jgrad,) = vjp(jnp.asarray(g))
    x = _t(feats).requires_grad_(True)
    got = tfn(x)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (got * _t(g)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=1e-6)
    # the ties share: 20 equal rows of one pillar get a twentieth each
    tied = np.asarray(valid)[40:60]
    if tied.sum() > 1:
        nz = x.grad.numpy()[40:60][tied]
        np.testing.assert_allclose(nz, nz[:1].repeat(len(nz), 0), rtol=1e-6)


def test_cap_points_per_pillar_matches_jax(jx):
    pts, mask = _points(5, a=1)
    ids, valid = jx.jvox.pillar_ids(pts[0], mask[0], **GRID)
    for cap in (1, 3, 32):
        want = jx.jvox.cap_points_per_pillar(pts[0], ids, valid, 80, 40, cap)
        got = vox.cap_points_per_pillar(_t(pts[0]), _t(np.asarray(ids)),
                                        _t(np.asarray(valid)), 80, 40, cap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_init(jx, module, *args, seed=0):
    """Seeded random variables of a flax module at eval, the arrays
    ``args``."""
    shapes = jx.jax.eval_shape(lambda *a: module.init(
        {"params": jx.jax.random.PRNGKey(0)}, *a, False), *args)
    return jx._random_variables(shapes, seed)


@pytest.mark.parametrize("train", [False, True])
def test_raw_point_pillar_encoder_matches_jax(jx, train):
    pts, mask = _points(6)
    pts, mask = pts[None], mask[None]
    kw = dict(voxel_size=(0.4, 0.4, 4.0), lidar_range=RANGE,
              num_filters=(8, 16))
    jenc = jx.JaxPointPillarEncoder(**kw)
    variables = _jax_init(jx, jenc, pts, mask)
    want, mutated = jenc.apply(variables, pts, mask, train,
                               mutable=["batch_stats"])
    enc = PointPillarEncoder(**kw)
    enc.load_state_dict(flax_to_state_dict(enc, variables))
    enc.train(train)
    got = enc.from_points(_t(pts), _t(mask))
    assert got.dtype == torch.float32
    _close(got.detach().numpy(), want, SLICE_TOL)
    if train:
        stats = flax_to_state_dict(enc, {"params": variables["params"],
                                         "batch_stats": mutated["batch_stats"]})
        for name, t in enc.named_buffers():
            _close(t, stats[name], STATS_TOL, name)


@pytest.mark.parametrize("train", [False, True])
def test_voxelnet_encoder_matches_jax(jx, train):
    pts, mask = _points(7, p=900)
    pts, mask = pts[None], mask[None]
    kw = dict(voxel_size=(0.8, 0.8, 1.0), lidar_range=RANGE,
              vfe_filters=(8, 16))
    jenc = jx.JaxVoxelNetEncoder(**kw, mid_ch=8)
    variables = _jax_init(jx, jenc, pts, mask)
    want, mutated = jenc.apply(variables, pts, mask, train,
                               mutable=["batch_stats"])
    enc = VoxelNetEncoder(**kw, mid_ch=8)
    enc.load_state_dict(flax_to_state_dict(enc, variables))
    enc.train(train)
    got = enc(_t(pts), _t(mask))
    assert got.shape[-1] == enc.out_channels == want.shape[-1]
    assert np.abs(np.asarray(want)).max() > 0
    _close(got.detach().numpy(), want, SLICE_TOL)
    stats = flax_to_state_dict(enc, {"params": variables["params"],
                                     "batch_stats": mutated["batch_stats"]})
    for name, t in enc.named_buffers():
        # the VFE layers' norms read their running statistics in training
        # too: only the middle layers' move
        _close(t, stats[name], STATS_TOL, name)


def test_rasterize_bev_matches_jax_exactly(jx):
    pts, mask = _points(8)
    pts, mask = pts[None], mask[None]
    want = jx.jpx.rasterize_bev(pts, mask, RANGE, (0.4, 0.4, 0.5))
    got = px.rasterize_bev(_t(pts), _t(mask), RANGE, (0.4, 0.4, 0.5))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_pixor_matches_jax(jx):
    rng = np.random.RandomState(9)
    cls = rng.randn(20, 40, 1).astype(np.float32)
    cls[3, 4] = cls[5, 6] = 3.0  # equal scores keep the lower index first
    reg = (0.3 * rng.randn(20, 40, 6)).astype(np.float32)
    want = jx.jpx.decode_pixor(cls, reg, RANGE, 0.8, 0.2, topk=32)
    got = px.decode_pixor(_t(cls), _t(reg), RANGE, 0.8, 0.2, topk=32)
    _close(got[0].numpy(), want[0], 1e-6, "boxes")
    _close(got[1].numpy(), want[1], 1e-6, "scores")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


LEGACY = {"voxel_net": "configs/opv2v/voxel_net.yaml",
          "pixor": "configs/opv2v/pixor.yaml",
          "second": "configs/opv2v/second.yaml",
          "second_intermediate": "configs/opv2v/second_intermediate.yaml",
          "m1_att_raw": "configs/opv2v/gencomm/stage1/m1_att.yaml"}
NARROW_BACKBONE = {"layer_nums": [1, 1], "layer_strides": [2, 2],
                   "num_filters": [16, 32], "upsample_strides": [1, 2],
                   "num_upsample_filter": [16, 16]}
NARROW_SHRINK = {"kernal_size": [3], "stride": [2], "padding": [1],
                 "dim": [32], "input_dim": 32}


def narrowed_legacy(name):
    """A copy of one of LEGACY's yamls on RANGE (32 x 16 m) at narrow
    widths; the same dict goes into both packages. Heads and anchors share
    a 20 x 10 grid: SECOND at 0.2 m voxels (its output stride 8), the
    pillar and VoxelNet necks at 0.4 m (stride 4), PIXOR at 0.4 m (its heads
    at stride 2, 40 x 20, fault s; 0.1 m z slices, as its yaml)."""
    with open(os.path.join(REPO, LEGACY[name])) as fh:
        h = yaml.safe_load(fh)
    rng_ = list(RANGE)
    h["cav_lidar_range"] = rng_
    h["preprocess"]["cav_lidar_range"] = rng_
    h["postprocess"]["gt_range"] = rng_
    h["postprocess"]["anchor_args"]["cav_lidar_range"] = rng_
    h["train_params"].update(batch_size=2, max_cav=3, save_freq=1,
                             eval_freq=1)
    args = h["model"]["args"]
    args["lidar_range"] = rng_
    if name == "pixor":
        # the yaml's voxels (41 raster channels): at 9-12 channels the CPU
        # backward of the backbone's 1x1 stride-2 conv on channels-last
        # memory aborts in PyTorch 2.13.0's CPU build
        assert args["voxel_size"] == [0.4, 0.4, 0.1]
    elif name.startswith("second"):
        # lists that do not overflow: under fault o an agent slot can lose
        # every site, its zero map in the train-mode norms makes the step
        # ill-conditioned (a 1.4e-5 change of the canvas moved its
        # gradient by 2.8% in JAX alone)
        args.update(voxel_size=[0.2, 0.2, 0.1], max_voxels=6000,
                    base_bev_backbone=dict(NARROW_BACKBONE,
                                           layer_strides=[1, 2]))
        h["preprocess"]["args"]["voxel_size"] = [0.2, 0.2, 0.1]
    else:
        enc = args["m1"]["encoder_args"]
        enc["lidar_range"] = rng_
        if name == "voxel_net":
            enc.update(voxel_size=[0.4, 0.4, 1.0], vfe_filters=[8, 16])
        else:
            enc["pillar_vfe"]["num_filters"] = [16]
            args["gencomm"]["model"]["ch"] = 4
        args["m1"]["backbone_args"] = dict(NARROW_BACKBONE)
        args["m1"]["shrink_header"] = dict(NARROW_SHRINK)
        args["att"] = {"feat_dim": 32}
        args["in_head"] = 32
    return h


def legacy_batch(jx, hypes, batch_size, seed):
    """A batch of the JAX sampler for the narrowed hypes (2 agents of 1,500
    points, labels at the anchors' grid, per-agent labels for the legacy
    SECOND cores as the JAX train CLI draws them), adapted as the JAX train
    CLI adapts it (``second``: every agent a sample; else the agent slots
    trimmed); the raw points kept."""
    from gencomm_tpu.data.bucketing import (
        per_agent_label_batch, trim_agent_slots as jax_trim,
    )

    core = hypes["model"]["core_method"]
    aa = hypes["postprocess"]["anchor_args"]
    cfg = jx.JaxSyntheticConfig(
        lidar_range=RANGE, max_cav=3, num_agents=2, points_per_agent=1500,
        num_vehicles=6, points_per_vehicle=60, comm_range=12.0,
        per_agent_labels=core.startswith("second"),
        voxel_size=tuple(hypes["preprocess"]["args"]["voxel_size"]),
        feature_stride=int(aa["feature_stride"]))
    host = jx.JaxScenes(cfg).sample(seed, batch_size)
    return per_agent_label_batch(host) if core == "second" else jax_trim(host)


def _jax_eval(jx, jmodel, variables, jbatch, noises=None):
    from tests.test_torch_config import _replayed_normal

    with pytest.MonkeyPatch.context() as mp:
        if noises is not None:
            mp.setattr(jx.jax.random, "normal", _replayed_normal(noises))
        return jx.jax.jit(lambda v, b: jmodel.apply(
            v, b, train=False,
            rngs={"diffusion": jx.jax.random.PRNGKey(7)}))(variables, jbatch)


def _noises(batch, hw, ch, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(batch["agent_mask"].size, *hw, ch).astype(np.float32)
            for _ in range(3)]


_SLICES = {}


@pytest.fixture(scope="module", params=list(LEGACY))
def legacy_slice(jx, request):
    """One eval frame of a narrowed yaml through both packages: the same
    hypes, frame, weights and (GenComm) diffusion noise."""
    return _slice(jx, request.param)


# the train steps: the legacy ``second`` core's trunk, backbone and heads
# are ``second_intermediate``'s without the level fusion (its per-slot
# batches run through the CLI test)
@pytest.fixture(scope="module", params=["voxel_net", "pixor",
                                        "second_intermediate", "m1_att_raw"])
def step_slice(jx, request):
    return _slice(jx, request.param)


def _slice(jx, name):
    if name not in _SLICES:
        _SLICES[name] = _build_slice(jx, name)
    return _SLICES[name]


def _build_slice(jx, name):
    raw = narrowed_legacy(name)
    hypes = jx.jax_yaml.update_yaml(copy.deepcopy(raw))
    port_hypes = yaml_utils.update_yaml(copy.deepcopy(raw))
    batch = legacy_batch(jx, hypes, 1, seed=3)
    assert "points_m1" in batch and "decorated_m1" not in batch
    jbatch = {k: jx.jnp.asarray(v) for k, v in batch.items()}
    jmodel = jx.jax_create_model(hypes)
    shapes = jx.jax.eval_shape(lambda b: jmodel.init(
        {"params": jx.jax.random.PRNGKey(0),
         "diffusion": jx.jax.random.PRNGKey(1)}, b, train=False), jbatch)
    variables = jx._random_variables(shapes, 0)
    noises = (_noises(batch, (10, 20), 32, 7) if name == "m1_att_raw"
              else None)
    jout = _jax_eval(jx, jmodel, variables, jbatch, noises)
    model = create_model(port_hypes, device="cpu")
    model.load_state_dict(flax_to_state_dict(model, variables))
    with torch.inference_mode():
        tout = model(batch_to_device(batch, "cpu"),
                     noises=None if noises is None else
                     [_t(z) for z in noises])
    return SimpleNamespace(name=name, raw=raw, jax_hypes=hypes,
                           hypes=port_hypes, jmodel=jmodel,
                           variables=variables, batch=batch, jout=jout,
                           tout=tout, model=model)


def test_legacy_slice_matches_jax(legacy_slice):
    s = legacy_slice
    keys = [k for k in ("message", "pred_feature", "cls_preds", "reg_preds",
                        "dir_preds") if k in s.jout]
    assert set(keys) <= set(s.tout)
    assert "cls_preds" in keys and "reg_preds" in keys
    for key in keys:
        want = np.asarray(s.jout[key], np.float32)
        assert np.abs(want).max() > 0, key
        _close(s.tout[key].float().numpy(), want, SLICE_TOL, key)
    # the heads' grid: every agent a sample for ``second``, the ego's fused
    # map otherwise; PIXOR's heads at stride 2 (fault s)
    lead = s.batch["agent_mask"].size if s.name == "second" else 1
    grid = (20, 40) if s.name == "pixor" else (10, 20)
    assert tuple(s.tout["cls_preds"].shape[:3]) == (lead,) + grid


class _Float32AsFloat64:
    """``jax.numpy`` with ``float32`` read as ``float64``: the JAX masked
    norm casts its input to fp32 for its statistics, which an fp64
    reference must not do."""

    def __init__(self, jnp):
        self._jnp = jnp

    @property
    def float32(self):
        return self._jnp.float64

    def __getattr__(self, name):
        return getattr(self._jnp, name)


def _masked_norms(module, method):
    """capture_intermediates' filter: the masked norms' outputs."""
    return type(module).__name__ == "MaskedBatchNorm" and method == "__call__"


class _GatesFrom:
    """Within it, each of ``model``'s masked norms that JAX's step
    captured (``intermediates``: its output y in fp64) hands the ReLU
    after it JAX's gate, y > 0, by a straight-through value: where the
    gate is open, max(|y|, tiny) with y's gradient; where it is shut, -|y|
    without one. ``flips`` counts by norm the valid rows' entries whose own
    gate differs from JAX's, and ``loose`` those of them that are not a
    near-tie: |y_jax| beyond twice the largest |y - y_jax| of the norm's
    valid rows."""

    def __init__(self, model, intermediates):
        import jax

        self.model, self.flips, self.loose = model, {}, 0
        self.ys = {
            ".".join(str(getattr(k, "key", k)) for k in path[:-2]): np.asarray(y)
            for path, y in jax.tree_util.tree_flatten_with_path(
                intermediates)[0]}

    def __enter__(self):
        from gencomm_tpu_torch.models.encoders.point_pillar import (
            MaskedBatchNorm,
        )

        names = {m: n for n, m in self.model.named_modules()}
        real = self.real = MaskedBatchNorm.forward

        def forward(norm, x, valid):
            y = real(norm, x, valid)
            want = self.ys.get(names.get(norm))
            if want is None:
                return y
            ref = torch.from_numpy(want)
            gate, own = ref > 0, y.detach().double() > 0
            v = valid.bool()[:, None].expand_as(gate)
            moved = float((y.detach().double() - ref)[v].abs().max())
            flipped = (gate != own) & v
            self.flips[names[norm]] = int(flipped.sum())
            self.loose += int((ref.abs()[flipped] > 2.0 * moved).sum())
            flat = y.detach().abs().clamp_min(1e-30)
            return torch.where(gate, flat + (y - y.detach()), -flat)

        MaskedBatchNorm.forward = forward
        return self

    def __exit__(self, *exc):
        from gencomm_tpu_torch.models.encoders.point_pillar import (
            MaskedBatchNorm,
        )

        MaskedBatchNorm.forward = self.real
        return False


def _np64(jx, tree):
    """fp32 leaves as fp64, the raw points but: their voxel indices must be
    the fp32 run's (a point near a voxel edge changes voxel in fp64)."""
    return jx.jax.tree_util.tree_map_with_path(
        lambda path, a: jx.jnp.asarray(a, jx.jnp.float64)
        if np.asarray(a).dtype == np.float32
        and not str(path[-1]).startswith("['points_")
        else jx.jnp.asarray(a), tree)


def test_legacy_train_step_matches_jax(jx, step_slice):
    """One train step of the narrowed yaml (2 samples, 2 agents) against
    jax.grad of the JAX model and loss on the slice's weights: the losses
    within 1e-4 relative of JAX's fp32 step, the running statistics within
    1e-6, and each gradient against JAX's gradient within GRAD_TOL of its
    largest entry: against JAX's fp64 gradient (under ``enable_x64``, the
    raw points kept in fp32) plus 3x JAX's own fp32 error of the tensor for
    the configs of FP64_REFERENCE (tests/test_torch_baselines.py's rule),
    against JAX's fp32 gradient for the others. The legacy SECOND model's
    step takes the ReLU gates of its encoder's masked norms from JAX's fp64
    step (``_GatesFrom``): a gate whose input lies within rounding of zero
    opens on one side and not the other, and moves its norm's bias
    gradient by percents. A gradient that is zero in exact arithmetic
    (JAX's below 1e-7 of the largest, e.g. a bias before a train-mode
    norm) is held below 1e-5 of the largest on both sides."""
    from tests.test_torch_config import _replayed_normal

    s = step_slice
    batch = legacy_batch(jx, s.jax_hypes, 2, seed=21)
    assert batch["pos_equal_one"].sum() > 0
    noises = (_noises(batch, (10, 20), 32, 13) if s.name == "m1_att_raw"
              else None)
    criterion = jx.jax_create_loss(s.jax_hypes)
    second = s.name.startswith("second")
    to_np = lambda tree: jx.jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a, np.float32), tree)

    def grads_fn(v, jb, gates=False):
        def loss_fn(params):
            out, mutated = s.jmodel.apply(
                {"params": params, "batch_stats": v["batch_stats"]},
                jb, train=True,
                mutable=["batch_stats"] + (["intermediates"] if gates else []),
                capture_intermediates=_masked_norms if gates else False,
                rngs={"diffusion": jx.jax.random.PRNGKey(0)})
            losses = criterion(out, jb)
            return losses["total_loss"], (
                losses, mutated["batch_stats"],
                mutated["intermediates"] if gates else {})

        return jx.jax.grad(loss_fn, has_aux=True)(v["params"])

    runs = {}
    for fp64 in (False, True) if s.name in FP64_REFERENCE else (False,):
        with contextlib.ExitStack() as stack:
            mp = stack.enter_context(pytest.MonkeyPatch.context())
            if noises is not None:
                mp.setattr(jx.jax.random, "normal", _replayed_normal(noises))
            v, jb = s.variables, batch
            if fp64:
                stack.enter_context(jx.jax.enable_x64(True))
                v, jb = _np64(jx, v), _np64(jx, jb)
                if second:
                    # the masked norm's statistics in fp64 as well
                    mp.setattr(jx.jax_point_pillar, "jnp",
                               _Float32AsFloat64(jx.jnp))
            grads, (jlosses, jstats, inter) = jx.jax.jit(
                grads_fn, static_argnums=2)(v, jb, fp64 and second)
            runs[fp64] = (to_np(grads), jlosses, to_np(jstats), inter)
    (grads32, jlosses, jstats, _) = runs[False]
    grads64, _, _, inter64 = runs[True] if True in runs else runs[False]
    model = create_model(s.hypes, device="cpu")
    model.load_state_dict(flax_to_state_dict(model, s.variables))
    opt, sched = make_optimizer(s.hypes, model.named_parameters())
    step = make_train_step(model, create_loss(s.hypes), opt, sched)
    with contextlib.ExitStack() as stack:
        if second:
            gates = stack.enter_context(_GatesFrom(model, inter64))
        losses = step(batch_to_device(batch, "cpu"),
                      noises=None if noises is None else
                      [_t(z) for z in noises])
    if second:
        assert len(gates.flips) == 12, gates.flips
        assert sum(gates.flips.values()) <= GATE_FLIPS, gates.flips
        assert gates.loose == 0, (gates.flips, gates.loose)
    assert set(losses) == set(jlosses)
    for k, want in jlosses.items():
        np.testing.assert_allclose(float(losses[k]), float(want), rtol=1e-4,
                                   err_msg=k)
    ref, ref32 = (flax_grads_to_torch(model, g) for g in (grads64, grads32))
    top = max(float(np.abs(g.numpy()).max()) for g in ref.values())
    for name, p in model.named_parameters():
        exact = ref[name].numpy()
        scale = float(np.abs(exact).max())
        if scale <= 1e-7 * top:
            for g in (p.grad.numpy(), ref32[name].numpy()):
                assert float(np.abs(g).max()) <= 1e-5 * top, name
            continue
        bound = GRAD_TOL * scale + 3.0 * float(
            np.abs(ref32[name].numpy() - exact).max())
        err = float(np.abs(p.grad.numpy() - exact).max())
        assert err <= bound, (name, err / scale, bound / scale)
    stats = flax_to_state_dict(model, {"params": s.variables["params"],
                                       "batch_stats": jstats})
    for name, t in model.named_buffers():
        if "running" in name:
            _close(t, stats[name], STATS_TOL, name)


def _pipeline(s):
    anchors = generate_anchor_box(s.hypes["postprocess"]["anchor_args"])
    return InferencePipeline(s.model, anchors, s.hypes["postprocess"],
                             device="cpu")


def test_pipeline_decodes_the_legacy_heads(jx, legacy_slice):
    """The pipeline decodes every model of the slice: SECOND's heads
    without a direction head (the decoded yaw kept), PIXOR's maps by
    ``decode_pixor`` (its boxes among JAX's ``decode_pixor`` on the JAX
    model's maps), the rest as before; ``run_stream`` equals ``run``."""
    s = legacy_slice
    pipe = _pipeline(s)
    host = dict(s.batch)
    dets = pipe.run(host, seed=0)
    frames = {k: np.stack([v, v]) for k, v in host.items()}
    stream = pipe.run_stream(frames, seeds=[0, 0])
    for a, b in zip(dets, stream):
        np.testing.assert_array_equal(a.numpy(), b[0].numpy())
    assert torch.isfinite(dets.corners3d).all()
    lead = host["agent_mask"].size if s.name == "second" else 1
    assert dets.valid.shape[0] == lead
    if s.name == "pixor":
        jbox, jscore, _ = jx.jpx.decode_pixor(
            s.jout["cls_preds"][0], s.jout["reg_preds"][0], RANGE,
            s.model.decode_cell, 0.2,
            topk=min(pipe.topk, s.jout["cls_preds"][0].size))
        got = dets.boxes7[0].numpy()  # x y z h w l yaw
        got = np.stack([got[:, 0], got[:, 1], got[:, 6], got[:, 4],
                        got[:, 5]], -1)
        dist = np.abs(got[:, None] - np.asarray(jbox)[None]).max(-1)
        assert dist.min(1).max() <= 1e-4


# ------------------------------------------------------- faults s and t
def test_fault_s_pixor_targets_sit_on_cells_twice_its_heads(jx):
    """Reference fault s: pixor.yaml's heads sit at stride 2 of its 0.4 m
    raster (0.8 m cells: the ResNet levels at strides 2 / 4 / 8, decoded to
    stride 2), but PixorLoss places each box's target on cells of its
    ``cell``, 1.6 m by default, which the yaml does not set: a box at x =
    50 m gets its target on the head cell centred at -26.8 m, and no target
    reaches the right half of the map. The port copies the loss and decodes
    on the loss's cell (``build_pixor_model``); nothing is repaired."""
    hypes = jx.jax_yaml.load_yaml(os.path.join(REPO, LEGACY["pixor"]))
    port_hypes = yaml_utils.load_yaml(os.path.join(REPO, LEGACY["pixor"]))
    margs = hypes["model"]["args"]
    lr = margs["lidar_range"]
    nx = int(round((lr[3] - lr[0]) / margs["voxel_size"][0]))
    head_w = nx // 2
    assert (lr[3] - lr[0]) / head_w == pytest.approx(0.8)
    crit = jx.jax_create_loss(hypes)
    assert crit.cell == 1.6 and "cell" not in hypes["loss"]["args"]
    ny = int(round((lr[4] - lr[1]) / margs["voxel_size"][1]))
    out = {"cls_preds": np.zeros((1, ny // 2, head_w, 1), np.float32),
           "reg_preds": np.zeros((1, ny // 2, head_w, 6), np.float32)}
    gt = np.zeros((1, 4, 7), np.float32)
    gt[0, :, 0] = [50.0, 90.0, -50.0, 0.0]
    gt[0, :, 4:6] = [1.8, 4.2]
    tgt = {"gt_boxes": gt, "gt_mask": np.ones((1, 4), np.float32)}
    cx = ((gt[0, :, 0] - lr[0]) / 1.6 - 0.5).astype(np.int32)
    assert cx.max() < head_w // 2
    assert lr[0] + (cx[0] + 0.5) * 0.8 == pytest.approx(-26.8)
    want = crit(out, tgt)
    got = create_loss(port_hypes)({k: _t(v) for k, v in out.items()},
                                  {k: _t(v) for k, v in tgt.items()})
    for k in ("cls_loss", "reg_loss"):
        # sums over 32,768 cells in another order
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
    model = create_model(port_hypes, device="meta")
    assert model.decode_cell == 1.6


@pytest.mark.parametrize("name", ["second", "pixor"])
def test_fault_t_jax_pipeline_cannot_decode_heads_without_a_direction(
        jx, name):
    """Reference fault t: ``gencomm_tpu/pipeline.py:61-63`` decodes
    ``out["dir_preds"]``, which the legacy SECOND models and PIXOR do not
    emit, so the JAX pipeline (and the inference CLI through it) raises
    KeyError on them; the port decodes them (``decode_and_nms`` without a
    direction, ``decode_pixor_and_nms``)."""
    from gencomm_tpu.data.postprocessor import (
        generate_anchor_box as jax_anchors,
    )
    from gencomm_tpu.pipeline import InferencePipeline as JaxPipeline

    hypes = jx.jax_yaml.update_yaml(narrowed_legacy(name))
    batch = legacy_batch(jx, hypes, 1, seed=3)
    jmodel = jx.jax_create_model(hypes)
    shapes = jx.jax.eval_shape(lambda b: jmodel.init(
        {"params": jx.jax.random.PRNGKey(0)}, b, train=False), batch)
    pipe = JaxPipeline(jmodel, jx._random_variables(shapes, 0),
                       jax_anchors(hypes["postprocess"]["anchor_args"]),
                       hypes["postprocess"])
    with pytest.raises(KeyError, match="dir_preds"):
        pipe._run(pipe.variables, batch, jx.jax.random.PRNGKey(0))


@pytest.mark.parametrize("name", ["voxel_net", "pixor", "second",
                                  "m1_att_raw"])
def test_legacy_yamls_through_the_command_lines(tmp_path, name):
    """The narrowed yamls through the train CLI (one step; the raw pillar
    path with ``--no_host_decorate``: raw points reach the model, nothing
    is decorated) and the inference CLI on the CPU; every logged loss
    finite, the APs reported."""
    import json

    from gencomm_tpu_torch.tools import inference, train as train_cli

    y = tmp_path / f"{name}.yaml"
    y.write_text(yaml.safe_dump(narrowed_legacy(name)))
    run = str(tmp_path / "run")
    seen = []
    real_step = train_cli.trainer.make_train_step

    def recorded(model, *a, **kw):
        step = real_step(model, *a, **kw)

        def wrapped(batch, **skw):
            seen.append(sorted(batch))
            return step(batch, **skw)
        return wrapped

    extra = ["--no_host_decorate"] if name == "m1_att_raw" else []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_cli.trainer, "make_train_step", recorded)
        train_cli.main(["-y", str(y), "--model_dir", run, "--dataset",
                        "synthetic", "--device", "cpu", "--epochs", "1",
                        "--steps_per_epoch", "1", "--val_steps", "1"]
                       + extra)
    assert seen and all("points_m1" in k and "decorated_m1" not in k
                        for k in seen)
    with open(os.path.join(run, "metrics.jsonl")) as f:
        assert all(np.isfinite(list(json.loads(line).values())).all()
                   for line in f)
    aps = inference.main(["--model_dir", run, "--dataset", "synthetic",
                          "--frames", "1", "--device", "cpu"])
    assert set(aps) == {"ap30", "ap50", "ap70"}
