"""SECOND (modality m3) in the port against the JAX package, on the CPU,
and its sparse ops on the card against the CPU.

The same seeded numpy inputs and the same weights (``weights.py`` carries
flax's variables) go through both packages:

- every op of ``ops/sparse.py`` against ``gencomm_tpu.ops.sparse``: keys,
  the sorted index, lookups, compaction with a capacity overflow, the
  voxel means (points on voxel boundaries, points in [z_max, z_max + vz),
  masked points, an overflow that drops the last agent's voxels first),
  the submanifold conv, the strided conv at paddings (1, 1, 1), (0, 1, 1)
  and (0, 0, 0) and the (3, 1, 1) kernel with coordinates at the border
  (negative candidate sites) and an overflowing list, and the dense
  scatter. Integer outputs exactly, the voxel means bit for bit (both sum a
  voxel's points in point order), features within 1e-5 x max(1, |ref|);
- ``SECONDEncoder`` on tests/test_sparse_conv.py's 12.8 x 6.4 m smoke range
  in eval and train mode (running statistics within 1e-6), with and
  without a capacity overflow;
- a narrowed ``stage1/m3_att`` model's message, generated feature and heads
  with injected diffusion noise, tests/test_heter_model.py's PointPillars +
  SECOND model and HEAL's ``m3_pyramid`` and ``m3_single_pyramid``, within
  1e-4 x max(1, |ref|); one narrowed train step (labels at the heads' grid)
  against ``jax.grad``;
- the pipeline keeping SECOND's raw points (``batch_to_device``,
  ``decorate``, ``HostDecoration``) and ``run_stream`` equal to ``run``;
  the train and inference CLIs on the narrowed yaml, and a JAX checkpoint
  of it through ``scripts/jax_checkpoint_to_torch.py``;
- reference fault n: SECOND's heads are half the anchor grid of its yamls;
  fault o: its strided convs' lists keep the first agent's sites only.

JAX is imported by the ``jx`` fixture, so that the ``cuda``-marked tests
run on a machine without it: ``python -m pytest --noconftest
tests/test_torch_second.py -m cuda``.
"""

import copy
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

from gencomm_tpu_torch.config import yaml_utils
from gencomm_tpu_torch.data.bucketing import trim_agent_slots
from gencomm_tpu_torch.data.decorate import HostDecoration
from gencomm_tpu_torch.data.postprocessor import generate_anchor_box
from gencomm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from gencomm_tpu_torch.loss import create_loss
from gencomm_tpu_torch.models import create_model
from gencomm_tpu_torch.models.encoders.second import SECONDEncoder
from gencomm_tpu_torch.models.heter_baseline import HeterModel
from gencomm_tpu_torch.ops import sparse as sp
from gencomm_tpu_torch.pipeline import InferencePipeline, batch_to_device
from gencomm_tpu_torch.train.trainer import make_optimizer, make_train_step
from gencomm_tpu_torch.weights import (
    flax_grads_to_torch, flax_to_state_dict, random_state_dict,
)

from tests.test_torch_kernels import _close, _t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M3_ATT = "configs/opv2v/gencomm/stage1/m3_att.yaml"
M1M3_ATT = "configs/opv2v/gencomm/stage2/m1m3_att.yaml"
# tests/test_sparse_conv.py's smoke range: a (33, 64, 128) voxel grid
SMOKE_RANGE = (0.0, 0.0, -2.0, 12.8, 6.4, 1.2)
VOXEL = (0.1, 0.1, 0.1)
OP_TOL = 1e-5
SLICE_TOL = 1e-4  # fp32 sums in other orders through ~40 layers
STATS_TOL = 1e-6
# of a parameter's largest gradient entry: fp32 sums in other orders
# through the sparse convs, the neck, three UNet passes and their batch
# statistics (observed 1.05e-3, message_extractor_m1.fuse1.bias; the
# pillar step of tests/test_torch_train.py, without a sparse encoder, is
# held at 1e-3 with 5e-4 observed)
GRAD_TOL = 2e-3
POSTPROCESS = {"gt_range": [-32.0, -16.0, -3.0, 32.0, 16.0, 1.0],
               "target_args": {"score_threshold": 0.2}, "nms_thresh": 0.15,
               "nms_topk": 64,
               "dir_args": {"dir_offset": 0.7853, "num_bins": 2}}


@pytest.fixture(scope="module")
def jx():
    """The JAX side: jax, jnp and the modules the tests compare against."""
    import jax
    import jax.numpy as jnp

    from gencomm_tpu.config import yaml_utils as jax_yaml
    from gencomm_tpu.data.decorate import host_decorate_pillars
    from gencomm_tpu.data.postprocessor import generate_anchor_box
    from gencomm_tpu.data.synthetic import (
        SyntheticConfig as JaxSyntheticConfig, SyntheticScenes as JaxScenes,
    )
    from gencomm_tpu.loss import create_loss as jax_create_loss
    from gencomm_tpu.models import create_model as jax_create_model
    from gencomm_tpu.models.encoders.second import (
        SECONDEncoder as JaxSECONDEncoder,
    )
    from gencomm_tpu.models.heter_baseline import HeterModel as JaxHeterModel
    from gencomm_tpu.ops import sparse as jsp

    from tests.test_torch_config import _replayed_normal, _shape_batch
    from tests.test_torch_train import _random_variables, _worst_grad_error

    return SimpleNamespace(**locals())


def _jit(jx, fn, *args):
    """``fn(*args)`` of the JAX package, jitted with every argument that is
    not an array static (one compile instead of an op-by-op dispatch)."""
    static = tuple(i for i, a in enumerate(args)
                   if not isinstance(a, (np.ndarray, jx.jax.Array)))
    return jx.jax.jit(fn, static_argnums=static)(*args)


def _equal(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


# ------------------------------------------------------------------- inputs
def smoke_points(seed, a=2, p=500):
    """(a, p, 4) points over SMOKE_RANGE and a mask: 50 points on voxel
    boundaries, 30 in [z_max, z_max + vz) (kept), 20 beyond it and 20
    below x_min (dropped), the last 10% of each agent masked."""
    rng = np.random.RandomState(seed)
    lo, hi = np.array(SMOKE_RANGE[:3]), np.array(SMOKE_RANGE[3:])
    pts = np.concatenate([rng.uniform(lo, hi, (a, p, 3)),
                          rng.uniform(0, 1, (a, p, 1))], -1).astype(np.float32)
    pts[:, :50, 0] = (np.arange(50) * np.float32(0.1)).astype(np.float32)
    pts[:, 50:80, 2] = rng.uniform(1.2, 1.3, (a, 30))
    pts[:, 80:100, 2] = rng.uniform(1.31, 2.0, (a, 20))
    pts[:, 100:120, 0] = rng.uniform(-1.0, -0.01, (a, 20))
    mask = np.ones((a, p), bool)
    mask[:, int(0.9 * p):] = False
    return pts, mask


def smoke_grid():
    return SECONDEncoder(VOXEL, SMOKE_RANGE).grid


def active_set(seed, grid, k=400, n_agents=2, pad=40, ch=3):
    """A voxel list of ``k`` distinct sites (a third of them on a border
    plane, so that strided candidates fall below 0) and ``pad`` invalid
    rows: (feats, coords, valid) as numpy."""
    rng = np.random.RandomState(seed)
    coords = np.stack([rng.randint(0, n_agents, k)]
                      + [rng.randint(0, g, k) for g in grid], 1)
    coords[: k // 3, 1 + rng.randint(0, 3)] = 0
    keys = ((coords[:, 0] * grid[0] + coords[:, 1]) * grid[1]
            + coords[:, 2]) * grid[2] + coords[:, 3]
    _, first = np.unique(keys, return_index=True)
    coords = coords[np.sort(first)]
    n = len(coords)
    coords = np.concatenate([coords, np.zeros((pad, 4), coords.dtype)])
    feats = rng.randn(n + pad, ch).astype(np.float32)
    valid = np.arange(n + pad) < n
    return feats, coords.astype(np.int32), valid


# ------------------------------------------------------------------- ops
def test_keys_index_lookup_and_compaction_match_jax(jx):
    grid = (5, 6, 7)
    rng = np.random.RandomState(0)
    coords = np.stack([rng.randint(0, 3, 300)] + [rng.randint(-2, g + 2, 300)
                                                  for g in grid], 1)
    coords = coords.astype(np.int32)
    valid = rng.rand(300) > 0.2
    want = jx.jsp.linear_key(jx.jnp.asarray(coords), grid,
                             jx.jnp.asarray(valid))
    got = sp.linear_key(_t(coords), grid, _t(valid))
    _equal(got, want, "linear_key")
    assert (got == sp.INVALID_KEY).any() and got.dtype == torch.int32
    ok = np.asarray(want) != sp.INVALID_KEY
    _equal(sp.key_to_coords(got[_t(ok)], grid),
           jx.jsp.key_to_coords(want[ok], grid), "key_to_coords")
    for name, a, b in zip(("sorted_keys", "sorted_idx"),
                          sp.build_index(got), jx.jsp.build_index(want)):
        _equal(a, b, name)
    sk, si = sp.build_index(got)
    query = _t(rng.randint(0, 3 * 5 * 6 * 7, 500).astype(np.int32))
    query[:20] = sp.INVALID_KEY
    _equal(sp.lookup(sk, si, query),
           jx.jsp.lookup(*jx.jsp.build_index(want), jx.jnp.asarray(query)),
           "lookup")
    n_unique = len(np.unique(np.asarray(want)[ok]))
    for cap in (n_unique + 10, n_unique - 30):  # room, overflow
        (keys, count), (jkeys, jcount) = (
            sp.unique_compact(got, cap), jx.jsp.unique_compact(want, cap))
        _equal(keys, jkeys, f"unique_compact {cap}")
        assert int(count) == int(jcount) == min(cap, n_unique)


@pytest.mark.parametrize("capacity", [2000, 600], ids=["room", "overflow"])
def test_voxelize_mean_matches_jax_bit_for_bit(jx, capacity):
    pts, mask = smoke_points(1)
    grid = smoke_grid()
    got = sp.voxelize_mean(_t(pts), _t(mask), SMOKE_RANGE, VOXEL, grid,
                           capacity)
    want = _jit(jx, jx.jsp.voxelize_mean, pts, mask, SMOKE_RANGE, VOXEL,
                grid, capacity)
    for name, g, w in zip(("feats", "coords", "valid"), got, want):
        _equal(g, w, name)
    feats, coords, valid = got
    agents = coords[valid][:, 0]
    # z in [z_max, z_max + vz) lands in plane nz and is kept
    assert (coords[valid][:, 1] == grid[0] - 1).any()
    if capacity == 600:
        assert bool(valid.all())
        # the last agent's voxels go first
        assert int((agents == 1).sum()) < int((agents == 0).sum())
    else:
        assert not bool(valid.all()) and set(agents.tolist()) == {0, 1}


@pytest.mark.parametrize("prebuilt", [False, True])
def test_subm_conv3d_matches_jax(jx, prebuilt):
    pts, mask = smoke_points(2)
    grid = smoke_grid()
    f, c, v = (np.asarray(t) for t in _jit(
        jx, jx.jsp.voxelize_mean, pts, mask, SMOKE_RANGE, VOXEL, grid, 1200))
    w = np.random.RandomState(3).randn(3, 3, 3, 4, 8).astype(np.float32)
    idx = sp.build_index(sp.linear_key(_t(c), grid, _t(v))) if prebuilt \
        else (None, None)
    got = sp.subm_conv3d(_t(f), _t(c), _t(v), _t(w), grid, *idx)
    want = _jit(jx, jx.jsp.subm_conv3d, f, c, v, w, grid)
    assert np.abs(np.asarray(want)).max() > 0
    _close(got, want, OP_TOL, "subm_conv3d")


@pytest.mark.parametrize("kernel,stride,padding,cap", [
    ((3, 3, 3), (2, 2, 2), (1, 1, 1), 800),
    ((3, 3, 3), (2, 2, 2), (0, 1, 1), 800),
    ((3, 3, 3), (2, 2, 2), (0, 0, 0), 800),
    ((3, 1, 1), (2, 1, 1), (0, 0, 0), 800),
    ((3, 3, 3), (2, 2, 2), (1, 1, 1), 150),
], ids=["p111", "p011", "p000", "k311", "overflow"])
def test_spconv3d_downsample_matches_jax(jx, kernel, stride, padding, cap):
    grid = (7, 9, 11)
    f, c, v = active_set(4, grid)
    w = np.random.RandomState(5).randn(*kernel, 3, 6).astype(np.float32)
    got = sp.spconv3d_downsample(_t(f), _t(c), _t(v), _t(w), grid, stride,
                                 padding, cap)
    want = _jit(jx, jx.jsp.spconv3d_downsample, f, c, v, w, grid, stride,
                padding, cap)
    assert got[3] == want[3]
    _equal(got[1], want[1], "out_coords")
    _equal(got[2], want[2], "out_valid")
    assert got[1].dtype == torch.int32
    _close(got[0], want[0], OP_TOL, "out_feats")
    n_valid = int(got[2].sum())
    assert (n_valid == cap) == (cap == 150)


def test_scatter_to_dense_matches_jax(jx):
    grid = (4, 5, 6)
    f, c, v = active_set(6, grid, k=60)
    got = sp.scatter_to_dense(_t(f), _t(c), _t(v), grid, 2)
    want = jx.jsp.scatter_to_dense(jx.jnp.asarray(f), jx.jnp.asarray(c),
                                   jx.jnp.asarray(v), grid, 2)
    _equal(got, want, "scatter_to_dense")


def test_segment_sum_sums_each_segment_in_row_order():
    rng = np.random.RandomState(7)
    vals = rng.randn(500, 3).astype(np.float32) * 10 ** rng.uniform(
        -3, 3, (500, 1)).astype(np.float32)
    seg = rng.randint(0, 40, 500).astype(np.int32)
    got = sp.segment_sum_sorted(_t(vals), _t(seg), 41).numpy()
    want = np.zeros((41, 3), np.float32)
    for i in range(500):  # sequential, in row order
        want[seg[i]] += vals[i]
    _equal(got, want)


# ------------------------------------------------------------------- encoder
@pytest.fixture(scope="module")
def jax_encoder(jx):
    """(points, capacity) -> the JAX encoder on smoke points: its variables
    and, from one jitted call, its eval output and its train output with
    the updated statistics; each computed once."""
    runs = {}

    def run(points, capacity):
        if (points, capacity) in runs:
            return runs[points, capacity]
        pts, mask = smoke_points(8, a=2, p=points)
        jpts, jmask = jx.jnp.asarray(pts[None]), jx.jnp.asarray(mask[None])
        jenc = jx.JaxSECONDEncoder(voxel_size=VOXEL, lidar_range=SMOKE_RANGE,
                                   voxel_capacity_per_agent=capacity,
                                   out_ch=32)
        variables = jx._random_variables(jx.jax.eval_shape(
            jenc.init, jx.jax.random.PRNGKey(0), jpts, jmask), seed=9)
        outs = jx.jax.jit(lambda v, p, m: {
            False: (jenc.apply(v, p, m, False), None),
            True: jenc.apply(v, p, m, True, mutable=["batch_stats"])})(
                variables, jpts, jmask)
        runs[points, capacity] = pts[None], mask[None], variables, outs
        return runs[points, capacity]

    return run


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("points,capacity", [(500, 2048), (3000, 512)],
                         ids=["room", "overflow"])
def test_encoder_matches_jax(jx, jax_encoder, train, points, capacity):
    pts, mask, variables, runs = jax_encoder(points, capacity)
    want, mutated = runs[train]
    enc = SECONDEncoder(VOXEL, SMOKE_RANGE, capacity, out_ch=32)
    enc.load_state_dict(flax_to_state_dict(enc, variables))
    if train:
        enc.train()
    got = enc(_t(pts), _t(mask))
    # z: 33 -> 17 -> 9 -> 4 -> 1 plane of 32 channels; H / 8, W / 8
    assert tuple(got.shape) == (1, 2, 8, 16, 32) == tuple(want.shape)
    assert np.abs(np.asarray(want)).max() > 0
    _close(got.detach(), want, OP_TOL, "bev")
    if train:
        stats = flax_to_state_dict(enc, {
            "params": variables["params"],
            "batch_stats": jx.jax.tree_util.tree_map(np.asarray,
                                                     mutated["batch_stats"])})
        buffers = dict(enc.named_buffers())
        assert len(buffers) == 2 * 12
        for name, t in buffers.items():
            _close(t, stats[name], STATS_TOL, name)


def test_weights_carry_sparse_kernels_and_masked_norms(jax_encoder):
    variables = jax_encoder(500, 2048)[2]
    enc = SECONDEncoder(VOXEL, SMOKE_RANGE, 2048, out_ch=32)
    sd = flax_to_state_dict(enc, variables)
    assert sd["subm1_0.kernel"].shape == (3, 3, 3, 4, 16)
    assert sd["down_out.kernel"].shape == (3, 1, 1, 64, 32)
    _equal(sd["down3.kernel"], variables["params"]["down3"]["kernel"])
    _equal(sd["subm4_1.MaskedBatchNorm_0.running_var"],
           variables["batch_stats"]["subm4_1"]["MaskedBatchNorm_0"]["var"])
    grads = flax_grads_to_torch(enc, variables["params"])
    assert set(grads) == {n for n, _ in enc.named_parameters()}
    # He-scaled over the four contracted axes
    w = random_state_dict(enc, seed=0)["subm2_0.kernel"]
    assert abs(float(w.std()) - (2.0 / (27 * 32)) ** 0.5) < 0.01


# ------------------------------------------------------------------- models
# heads of 10 x 20 cells (the diffusion UNet halves and doubles the map,
# so its sides must be even)
SMALL_RANGE = [-32.0, -16.0, -3.0, 32.0, 16.0, 1.0]


def narrowed_m3(config=M3_ATT):
    """A SECOND yaml at a 64 x 32 m range and narrow widths, its anchors
    and labels at the heads' grid (feature_stride 8, fault n); the same
    dict goes into both packages."""
    with open(os.path.join(REPO, config)) as fh:
        h = yaml.safe_load(fh)
    h["cav_lidar_range"] = list(SMALL_RANGE)
    h["preprocess"]["cav_lidar_range"] = list(SMALL_RANGE)
    h["postprocess"]["gt_range"] = list(SMALL_RANGE)
    h["postprocess"]["anchor_args"]["cav_lidar_range"] = list(SMALL_RANGE)
    h["postprocess"]["anchor_args"]["feature_stride"] = 8
    h["train_params"].update(batch_size=2, max_cav=3)
    args = h["model"]["args"]
    args["lidar_range"] = list(SMALL_RANGE)
    for c in args.values():
        if not (isinstance(c, dict) and "encoder_args" in c):
            continue
        enc = c["encoder_args"]
        enc["lidar_range"] = list(SMALL_RANGE)
        if c.get("core_method") == "second":
            enc["max_voxels"] = 1500
            enc["spconv"]["num_features_out"] = 16
        if "pillar_vfe" in enc:
            enc["pillar_vfe"]["num_filters"] = [16]
        c["backbone_args"] = {"layer_nums": [1, 1], "layer_strides": [2, 2],
                              "num_filters": [16, 32],
                              "upsample_strides": [1, 2],
                              "num_upsample_filter": [16, 16]}
        c["shrink_header"] = {"kernal_size": [3], "stride": [2],
                              "padding": [1], "dim": [32], "input_dim": 32}
    args["att"] = {"feat_dim": 32}
    args["in_head"] = 32
    return h


def small_scenes(hypes, jx=None, batch=1, seed=3):
    """A batch of the narrowed config's sampler (2 agents of 1,600 points,
    labels at feature_stride 8), from the JAX sampler with ``jx``."""
    kw = dict(lidar_range=tuple(SMALL_RANGE), max_cav=3, num_agents=2,
              points_per_agent=1600, num_vehicles=6, points_per_vehicle=60,
              comm_range=12.0, feature_stride=8,
              modalities={m: {"sensor": "lidar"}
                          for m, c in hypes["model"]["args"].items()
                          if isinstance(c, dict) and "encoder_args" in c})
    scenes = (jx.JaxScenes(jx.JaxSyntheticConfig(**kw)) if jx is not None
              else SyntheticScenes(SyntheticConfig(**kw)))
    return scenes, trim_agent_slots(scenes.sample(seed, batch))


def _jax_variables(jx, jmodel, jbatch, seed=0):
    return jx._random_variables(jx.jax.eval_shape(lambda b: jmodel.init(
        {"params": jx.jax.random.PRNGKey(0),
         "diffusion": jx.jax.random.PRNGKey(1)}, b, train=False), jbatch),
        seed)


def _jax_eval(jx, jmodel, variables, jbatch, noises):
    """The JAX model's jitted eval forward with ``noises`` as its
    diffusion draws."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jx.jax.random, "normal", jx._replayed_normal(noises))
        return jx.jax.jit(lambda v, b: jmodel.apply(
            v, b, train=False,
            rngs={"diffusion": jx.jax.random.PRNGKey(7)}))(variables, jbatch)


@pytest.fixture(scope="module")
def m3_slice(jx):
    """One eval frame of the narrowed m3_att yaml through both packages:
    the same hypes, frame, weights and diffusion noise."""
    raw = narrowed_m3()
    hypes = jx.jax_yaml.update_yaml(copy.deepcopy(raw))
    port_hypes = yaml_utils.update_yaml(copy.deepcopy(raw))
    _, host = small_scenes(hypes, jx)
    batch = jx.host_decorate_pillars(host, hypes)
    assert "points_m1" in batch and "decorated_m1" not in batch
    jbatch = {k: jx.jnp.asarray(v) for k, v in batch.items()}
    jmodel = jx.jax_create_model(hypes)
    variables = _jax_variables(jx, jmodel, jbatch)
    rng = np.random.RandomState(7)
    noises = [rng.randn(batch["agent_mask"].size, 10, 20, 32).astype(
        np.float32) for _ in range(3)]
    jout = _jax_eval(jx, jmodel, variables, jbatch, noises)
    model = create_model(port_hypes, device="cpu")
    model.load_state_dict(flax_to_state_dict(model, variables))
    with torch.inference_mode():
        tout = model(batch_to_device(batch, "cpu"),
                     noises=[_t(z) for z in noises])
    return SimpleNamespace(raw=raw, jax_hypes=hypes, hypes=port_hypes,
                           jmodel=jmodel, variables=variables, batch=batch,
                           jout=jout, tout=tout, model=model, noises=noises,
                           anchors=jx.JaxScenes(jx.JaxSyntheticConfig(
                               lidar_range=tuple(SMALL_RANGE),
                               feature_stride=8)).anchors)


@pytest.mark.parametrize("key", ["message", "pred_feature", "cls_preds",
                                 "reg_preds", "dir_preds"])
def test_m3_att_slice_matches_jax(m3_slice, key):
    want = np.asarray(m3_slice.jout[key], np.float32)
    assert np.abs(want).max() > 0
    _close(m3_slice.tout[key].numpy(), want, SLICE_TOL, key)


def test_m3_att_slice_heads_sit_on_its_anchor_grid(m3_slice):
    assert m3_slice.tout["cls_preds"].shape[1:3] == (10, 20)
    assert m3_slice.anchors.shape[:2] == (10, 20)
    assert m3_slice.batch["pos_equal_one"].shape[1:3] == (10, 20)


def test_pillar_plus_second_hetero_model_matches_jax(jx):
    """tests/test_heter_model.py's model: agent 0 PointPillars, agent 1
    SECOND on the same points, GenComm and attentive fusion."""
    from tests.test_heter_model import M2_SECOND_ARGS
    from tests.test_model_forward import MODALITY_ARGS, TINY

    b = jx.JaxScenes(TINY).sample(seed=5, batch_size=1)
    m1_mask, m2_mask = b["agent_mask"].copy(), b["agent_mask"].copy()
    m1_mask[:, 1:] = False
    m2_mask[:, 0] = False
    b.update(modality_mask_m1=m1_mask, modality_mask_m2=m2_mask,
             points_m2=b["points_m1"].copy(),
             point_mask_m2=b["point_mask_m1"].copy())
    margs = {"m1": dict(MODALITY_ARGS["m1"], core_method="point_pillar"),
             "m2": M2_SECOND_ARGS}
    batch = jx.host_decorate_pillars(b, {"model": {"args": margs}})
    assert "decorated_m1" in batch and "points_m2" in batch
    jbatch = {k: jx.jnp.asarray(v) for k, v in batch.items()}
    kw = dict(modality_args=margs, fusion_method="att",
              fusion_args={"att": {"feat_dim": 64}},
              lidar_range=TINY.lidar_range, anchor_number=2,
              use_gencomm=True)
    jmodel = jx.JaxHeterModel(**kw, in_head=64)
    variables = _jax_variables(jx, jmodel, jbatch)
    hw = jx.JaxScenes(TINY).anchors.shape[:2]
    rng = np.random.RandomState(11)
    noises = [rng.randn(batch["agent_mask"].size, *hw, 64).astype(np.float32)
              for _ in range(3)]
    jout = _jax_eval(jx, jmodel, variables, jbatch, noises)
    model = HeterModel(**kw, device="cpu")
    model.load_state_dict(flax_to_state_dict(model, variables))
    assert isinstance(model.lidar_encoder("m2"), SECONDEncoder)
    with torch.inference_mode():
        tout = model(batch_to_device(batch, "cpu"),
                     noises=[_t(z) for z in noises])
    for key in ("message", "cls_preds", "reg_preds", "dir_preds"):
        _close(tout[key].numpy(), jout[key], SLICE_TOL, key)


def test_m3_att_train_step_matches_jax(jx, m3_slice):
    """One narrowed m3_att train step (2 samples x 2 agents, labels at the
    heads' grid) against jax.grad of the JAX model and loss, on the eval
    slice's weights: the losses within 1e-4 relative, every gradient within
    GRAD_TOL of its largest entry, the running statistics within 1e-6."""
    hypes, port_hypes = m3_slice.jax_hypes, m3_slice.hypes
    jmodel, variables = m3_slice.jmodel, m3_slice.variables
    _, batch = small_scenes(hypes, jx, batch=2, seed=21)
    assert batch["pos_equal_one"].shape[1:3] == (10, 20)
    assert batch["pos_equal_one"].sum() > 0
    jbatch = {k: jx.jnp.asarray(v) for k, v in batch.items()}
    rng = np.random.RandomState(13)
    noises = [rng.randn(batch["agent_mask"].size, 10, 20, 32).astype(
        np.float32) for _ in range(3)]
    criterion = jx.jax_create_loss(hypes)

    def loss_fn(params):
        out, mutated = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jbatch, train=True, mutable=["batch_stats"],
            rngs={"diffusion": jx.jax.random.PRNGKey(0)})
        losses = criterion(out, jbatch)
        return losses["total_loss"], (losses, mutated["batch_stats"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jx.jax.random, "normal", jx._replayed_normal(noises))
        grads, (jlosses, jstats) = jx.jax.jit(jx.jax.grad(
            loss_fn, has_aux=True))(variables["params"])
    model = create_model(port_hypes, device="cpu")
    model.load_state_dict(flax_to_state_dict(model, variables))
    opt, sched = make_optimizer(port_hypes, model.named_parameters())
    step = make_train_step(model, create_loss(port_hypes), opt, sched)
    losses = step(batch_to_device(batch, "cpu"),
                  noises=[_t(z) for z in noises])
    assert set(losses) == set(jlosses)
    for k, want in jlosses.items():
        np.testing.assert_allclose(float(losses[k]), float(want), rtol=1e-4,
                                   err_msg=k)
    to_np = lambda tree: jx.jax.tree_util.tree_map(np.asarray, tree)
    err, name = jx._worst_grad_error(model, flax_grads_to_torch(
        model, to_np(grads)))
    assert err <= GRAD_TOL, (err, name)
    stats = flax_to_state_dict(model, {"params": variables["params"],
                                       "batch_stats": to_np(jstats)})
    for name, t in model.named_buffers():
        if "running" in name:
            _close(t, stats[name], STATS_TOL, name)


@pytest.mark.parametrize("config", ["stage1/m3_pyramid",
                                    "stage2/m3_single_pyramid"])
def test_m3_pyramid_forward_matches_jax(jx, config):
    """HEAL's SECOND models (the encoder alone in ``enc_branch_m3``, the
    ResNet backbone, the pyramid collab or single), narrowed as
    tests/test_torch_pyramid.py narrows the HEAL yamls: heads within 1e-4
    x max(1, |ref|)."""
    from tests.test_torch_pyramid import frame, hypes_pair, narrowed_pyramid

    raw = narrowed_pyramid(os.path.join(REPO, "configs", "opv2v", "heal",
                                        config + ".yaml"))
    enc = raw["model"]["args"]["m3"]["encoder_args"]
    enc["max_voxels"] = 1500
    enc["spconv"]["num_features_out"] = 16
    jh, ph = hypes_pair(raw)
    batch = frame(jh)
    assert "points_m3" in batch and "decorated_m3" not in batch
    jmodel = jx.jax_create_model(jh)
    jbatch = {k: jx.jnp.asarray(v) for k, v in batch.items()}
    variables = jx._random_variables(jx.jax.eval_shape(
        lambda b: jmodel.init({"params": jx.jax.random.PRNGKey(0)}, b,
                              train=False), jbatch), 5)
    jout = jx.jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, jbatch)
    model = create_model(ph, device="cpu")
    model.load_state_dict(flax_to_state_dict(model, variables))
    assert isinstance(model.lidar_encoder("m3"), SECONDEncoder)
    with torch.inference_mode():
        out = model(batch_to_device(batch, "cpu"))
    for key in ("cls_preds", "reg_preds", "dir_preds"):
        want = np.asarray(jout[key], np.float32)
        assert np.abs(want).max() > 0
        _close(out[key].numpy(), want, SLICE_TOL, key)


# ------------------------------------------------------------------- pipeline
def test_raw_points_reach_second_and_run_stream_equals_run(m3_slice):
    host = dict(m3_slice.batch)
    port = batch_to_device(host, "cpu")
    assert set(port) == set(host)
    assert "points_m1" in port and "point_mask_m1" in port
    assert m3_slice.model.lidar_encoder("m1").takes_raw_points
    # the host decoration passes SECOND through
    assert HostDecoration(m3_slice.hypes).grids == {}
    assert HostDecoration(m3_slice.hypes)(host) is host
    pipe = InferencePipeline(m3_slice.model, m3_slice.anchors, POSTPROCESS,
                             device="cpu")
    assert set(pipe.decorate(host)) == set(host)
    scenes, _ = small_scenes(m3_slice.hypes)
    frames = [scenes.sample(40 + f, 1) for f in range(3)]
    frames = [trim_agent_slots(f) for f in frames]
    stacked = {k: np.stack([f[k] for f in frames]) for k in frames[0]}
    seeds = [5, 6, 7]
    streamed = pipe.run_stream(stacked, seeds)
    for f, s in enumerate(seeds):
        looped = pipe.run(frames[f], seed=s)
        assert looped.valid.any()
        for name, v in streamed._asdict().items():
            assert torch.equal(v[f], getattr(looped, name)), (f, name)


def test_m3_att_through_the_command_lines_and_a_jax_checkpoint(
        jx, m3_slice, tmp_path):
    """The narrowed m3_att yaml through the train CLI (raw points to the
    model, every logged loss finite) and the inference CLI on the CPU; a
    JAX checkpoint of it through ``scripts/jax_checkpoint_to_torch.py``
    (the sparse kernels and masked norms), loaded strictly."""
    from gencomm_tpu_torch.tools import inference, train as train_cli
    from gencomm_tpu_torch.train import checkpoint
    from tests.test_torch_workflow import (
        _jax_run_dir, jax_checkpoint_to_torch,
    )

    raw = m3_slice.raw
    y = tmp_path / "m3_att.yaml"
    y.write_text(yaml.safe_dump(raw))
    run = str(tmp_path / "run")
    seen = []
    real_step = train_cli.trainer.make_train_step

    def recorded(model, *a, **kw):
        step = real_step(model, *a, **kw)

        def wrapped(batch, **skw):
            seen.append(sorted(batch))
            return step(batch, **skw)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_cli.trainer, "make_train_step", recorded)
        train_cli.main(["-y", str(y), "--model_dir", run, "--dataset",
                        "synthetic", "--device", "cpu", "--epochs", "1",
                        "--steps_per_epoch", "1", "--val_steps", "1"])
    assert seen and all("points_m1" in k and "point_mask_m1" in k
                        for k in seen)
    with open(os.path.join(run, "metrics.jsonl")) as f:
        assert all(np.isfinite(list(json.loads(line).values())).all()
                   for line in f)
    aps = inference.main(["--model_dir", run, "--dataset", "synthetic",
                          "--frames", "1", "--device", "cpu"])
    assert set(aps) == {"ap30", "ap50", "ap70"}

    jh, variables = m3_slice.jax_hypes, m3_slice.variables
    jdir = _jax_run_dir(str(tmp_path), "jax_m3", jh, variables, 1, step=2)
    pdir = str(tmp_path / "port_m3")
    jax_checkpoint_to_torch.convert(jdir, pdir)
    model = create_model(yaml_utils.update_yaml(copy.deepcopy(raw)),
                         device="cpu")
    state = checkpoint.load_checkpoint(
        checkpoint.latest_checkpoint(pdir))["state_dict"]
    model.load_state_dict(state, strict=True)
    kernel = variables["params"]["branch_m1"]["encoder"]["down2"]["kernel"]
    _equal(state["branch_m1.encoder.down2.kernel"], kernel)
    var = variables["batch_stats"]["branch_m1"]["encoder"]["subm3_1"][
        "MaskedBatchNorm_0"]["var"]
    _equal(state["branch_m1.encoder.subm3_1.MaskedBatchNorm_0.running_var"],
           var)


# ------------------------------------------------------------------- fault n
def _meta_batch(b):
    return {k: torch.zeros(v.shape, dtype=torch.bool if v.dtype == bool
                           else torch.int32 if v.dtype == np.int32
                           else torch.float32) for k, v in b.items()}


def test_fault_n_second_heads_are_half_the_anchor_grid(jx):
    """Reference fault n: the yamls give SECOND the pillar neck (strides
    2, 2, 2 and a stride-2 shrinker) on a BEV of 0.8 m cells, so its heads
    sit on half the anchor grid of feature_stride 4 in each axis, and a
    pillar + SECOND model cannot sum its modalities. The port copies this;
    nothing is repaired."""
    path = os.path.join(REPO, M3_ATT)
    hypes, port_hypes = jx.jax_yaml.load_yaml(path), yaml_utils.load_yaml(path)
    anchor_args = hypes["postprocess"]["anchor_args"]
    assert anchor_args["feature_stride"] == 4
    for generate in (jx.generate_anchor_box, generate_anchor_box):
        assert generate(anchor_args).shape == (64, 128, 2, 7)
    jmodel = jx.jax_create_model(hypes)
    shapes = jx._shape_batch(hypes)
    rngs = {"params": jx.jax.random.PRNGKey(0),
            "diffusion": jx.jax.random.PRNGKey(1)}
    jout = jx.jax.eval_shape(lambda b: jmodel.init_with_output(
        rngs, b, train=False)[0], shapes)
    assert jout["cls_preds"].shape == (1, 32, 64, 2)
    with torch.device("meta"):
        model = create_model(port_hypes, device="meta")
        tout = model(_meta_batch(shapes), noises=[
            torch.zeros(2, 32, 64, 128) for _ in range(3)])
    assert tuple(tout["cls_preds"].shape) == (1, 32, 64, 2)

    path = os.path.join(REPO, M1M3_ATT)
    hypes, port_hypes = jx.jax_yaml.load_yaml(path), yaml_utils.load_yaml(path)
    jmodel = jx.jax_create_model(hypes)
    shapes = jx._shape_batch(hypes)
    with pytest.raises(TypeError, match=r"incompatible shapes for "
                       r"broadcasting: \(1, 2, 64, 128, 128\), "
                       r"\(1, 2, 32, 64, 128\)"):
        jx.jax.eval_shape(lambda b: jmodel.init(rngs, b, train=False), shapes)
    with torch.device("meta"):
        model = create_model(port_hypes, device="meta")
        with pytest.raises(RuntimeError, match="broadcast") as exc:
            model(_meta_batch(shapes))
    assert "[1, 2, 32, 64, 128]" in str(exc.value)
    assert "[1, 2, 64, 128, 128]" in str(exc.value)


def test_fault_o_strided_lists_keep_the_first_agents_sites(jx):
    """Reference fault o: SECOND's strided convs write into lists of cap,
    cap // 2, cap // 4 and cap // 4 sites (cap = max_voxels x agent
    slots), and keep the first sites in key order, agent then z. At 0.1 m
    a strided conv proposes several sites a voxel, so the first list fills
    with agent 0's sites, from the lowest z plane up, and agent 1 keeps
    none: at the narrowed m3_att's density (1,600 points an agent over 64 x
    32 m, 1,500 voxels an agent slot) in both packages. The port copies
    the rule; nothing is repaired."""
    _, host = small_scenes(narrowed_m3())
    pts, mask = host["points_m1"][0], host["point_mask_m1"][0]
    grid = SECONDEncoder(VOXEL, SMALL_RANGE).grid
    cap = 1500 * 2
    w = np.zeros((3, 3, 3, 4, 1), np.float32)

    def strided(ops, p, m, w, capacity):
        feats, coords, valid = ops.voxelize_mean(p, m, SMALL_RANGE, VOXEL,
                                                 grid, cap)
        _, oc, ov, _ = ops.spconv3d_downsample(
            feats, coords, valid, w, grid, (2, 2, 2), (1, 1, 1), capacity)
        return valid, oc, ov

    def agents(valid, oc, ov):
        assert int(valid.sum()) < cap  # every voxel is held
        oc, ov = np.asarray(oc), np.asarray(ov)
        return np.bincount(oc[ov][:, 0], minlength=2).tolist()

    # the yaml's list in both packages; every site proposed (a list of 8
    # a voxel) in the port's
    held = {"jax": [agents(*jx.jax.jit(
        lambda p, m, w: strided(jx.jsp, p, m, w, cap))(pts, mask, w))],
        "port": [agents(*strided(sp, _t(pts), _t(mask), _t(w), capacity))
                 for capacity in (cap, 8 * cap)]}
    kept, proposed = held["port"]
    assert held["jax"] == [kept]
    assert kept == [cap, 0] and proposed[0] > cap and proposed[1] > 0


# ------------------------------------------------------------------- card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sparse_ops_on_card_match_cpu(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    pts, mask = smoke_points(12, p=3000)
    grid = smoke_grid()
    outs = {}
    for dev in ("cpu", cuda):
        f, c, v = sp.voxelize_mean(_t(pts).to(dev), _t(mask).to(dev),
                                   SMOKE_RANGE, VOXEL, grid, 2500)
        w = _t(np.random.RandomState(13).randn(3, 3, 3, 4, 8).astype(
            np.float32)).to(dev)
        sub = sp.subm_conv3d(f, c, v, w, grid)
        down = sp.spconv3d_downsample(sub, c, v, _t(np.random.RandomState(
            14).randn(3, 3, 3, 8, 8).astype(np.float32)).to(dev), grid,
            (2, 2, 2), (1, 1, 1), 2500)
        outs[str(dev)] = [t.cpu() for t in (f, c, v, sub) + down[:3]]
    for name, a, b in zip(("feats", "coords", "valid", "subm", "down",
                           "down_coords", "down_valid"),
                          outs[str(cuda)], outs["cpu"]):
        if a.dtype == torch.float32 and name != "feats":
            _close(a, b, OP_TOL, name)
        else:  # integers, and the voxel means, bit for bit
            assert torch.equal(a, b), name


@pytest.mark.cuda
def test_segment_sum_on_card_gives_the_same_bits_twice(cuda):
    rng = np.random.RandomState(15)
    vals = _t(rng.randn(200000, 5).astype(np.float32)).to(cuda)
    seg = _t(rng.randint(0, 5000, 200000).astype(np.int32)).to(cuda)
    first = sp.segment_sum_sorted(vals, seg, 5001)
    second = sp.segment_sum_sorted(vals, seg, 5001)
    assert torch.equal(first, second)
    assert torch.equal(first.cpu(), sp.segment_sum_sorted(
        vals.cpu(), seg.cpu(), 5001))


@pytest.mark.cuda
def test_encoder_on_card_matches_cpu(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    pts, mask = smoke_points(16, p=3000)
    enc = SECONDEncoder(VOXEL, SMOKE_RANGE, 2048, out_ch=32)
    enc.load_state_dict(random_state_dict(enc, seed=0))
    with torch.inference_mode():
        want = enc(_t(pts[None]), _t(mask[None]))
        got = enc.to(cuda)(_t(pts[None]).to(cuda), _t(mask[None]).to(cuda))
    _close(got.cpu(), want, OP_TOL, "bev")
