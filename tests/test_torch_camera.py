"""The port's camera slice (Lift-Splat-Shoot GenComm stage 1) against the JAX
package, on the CPU.

Inputs are made with numpy from a seed and go through both packages with
the same weights (carried by ``weights.py``). The plain versions of K4 (top-K
depth splat) and K4b (its backward), which the wrapper takes for CPU tensors,
are held against the JAX package's Pallas kernel (interpret mode, as
``tests/test_splat_pallas.py`` runs it) and its VJP; then the image trunk,
the frustum geometry, the top-K selection, the encoder, the dense splat, the
depth binning and loss, the sampler's camera arrays, the whole eval slice
and one train step. The kernels' CUDA halves are in
``test_torch_kernels.py``.

Cell ids: ``floor((x - origin) / dx)`` of a geometry that went through a
matrix inverse and two einsums in fp32 may put a frustum point that lies on
a cell boundary into the neighbouring cell when the two frameworks round
differently. So the geometry is held within 1e-4 m, the differing ids are
counted (none on these inputs, and the tests say so), and the canvas is
compared with the JAX ids and weights injected.
"""

import os
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gencomm_tpu.data.synthetic import (
    SyntheticConfig as JaxSyntheticConfig, SyntheticScenes as JaxScenes,
)
from gencomm_tpu.loss.pyramid_loss import (
    PointPillarDepthLoss as JaxDepthLoss,
    categorical_depth_focal as jax_depth_focal,
)
from gencomm_tpu.models.encoders import lss as jax_lss
from gencomm_tpu.models.heter_baseline import HeterModel as JaxHeterModel
from gencomm_tpu.ops import splat_pallas
from gencomm_tpu.utils import camera_utils as jax_camera_utils

from gencomm_tpu_torch.data.bucketing import trim_agent_slots
from gencomm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from gencomm_tpu_torch.loss import build_loss
from gencomm_tpu_torch.loss.pyramid_loss import categorical_depth_focal
from gencomm_tpu_torch.models.encoders import lss as port_lss
from gencomm_tpu_torch.models.encoders.lss import (
    CamEncoder, LSSEncoder, bin_depth_indices, center_crop_or_pad,
)
from gencomm_tpu_torch.models.heter_baseline import HeterModel
from gencomm_tpu_torch.ops._cuda import LAUNCHES
from gencomm_tpu_torch.ops.splat import (
    splat_topk, splat_topk_bwd_plain, splat_topk_plain,
)
from gencomm_tpu_torch.pipeline import InferencePipeline, batch_to_device
from gencomm_tpu_torch.train.trainer import make_optimizer, make_train_step
from gencomm_tpu_torch.utils import camera_utils
from gencomm_tpu_torch.weights import flax_grads_to_torch, flax_to_state_dict

from tests.test_torch_kernels import _close, _t, splat_case as _splat_case
from tests.test_torch_train import _random_variables, _worst_grad_error

# the small camera model: 2 cameras of 64 x 96 per agent, 8 x 12 feature
# pixels, 8 LID depth bins over 2-20 m, top-4, 16 image features, a 32 x 32
# grid of 0.8 m cells, one layer per backbone level, 2 of 3 agent slots
LR = (-12.8, -12.8, -3.0, 12.8, 12.8, 1.0)
VOXEL = (0.8, 0.8, 4.0)
GRID = {"xbound": [-12.8, 12.8, 0.8], "ybound": [-12.8, 12.8, 0.8],
        "zbound": [-10.0, 10.0, 20.0], "ddiscr": [2, 20, 8], "mode": "LID"}
FINAL_DIM = (64, 96)
NCAM = 2
ENCODER_ARGS = {"grid_conf": GRID, "data_aug_conf": {"final_dim": list(FINAL_DIM)},
                "img_downsample": 8, "img_features": 16, "trunk_blocks": 1,
                "depth_topk": 4}
MODEL_KW = dict(
    modality_args={"m1": {
        "sensor_type": "camera", "core_method": "lift_splat_shoot",
        "encoder_args": ENCODER_ARGS,
        "backbone_args": {"layer_nums": [1, 1], "layer_strides": [2, 2],
                          "num_filters": [16, 32], "upsample_strides": [1, 2],
                          "num_upsample_filter": [16, 16]},
        "shrink_header": {"kernal_size": [3], "stride": [2], "padding": [1],
                          "dim": [32], "input_dim": 32},
    }},
    fusion_method="att", lidar_range=LR, anchor_number=2, use_gencomm=True,
    use_enhancer=True)
# configs/opv2v/gencomm/stage1/m2_att.yaml:131-166
HYPES = {
    "optimizer": {"core_method": "Adam", "lr": 0.002,
                  "args": {"eps": 1e-10, "weight_decay": 1e-4}},
    "lr_scheduler": {"core_method": "multistep", "gamma": 0.1,
                     "step_size": [10, 15]},
    "loss": {"core_method": "point_pillar_depth_loss", "args": {
        "pos_cls_weight": 2.0,
        "cls": {"type": "SigmoidFocalLoss", "alpha": 0.25, "gamma": 2.0,
                "weight": 2.0},
        "reg": {"type": "WeightedSmoothL1Loss", "sigma": 3.0,
                "codewise": True, "weight": 2.0},
        "dir": {"type": "WeightedSoftmaxClassificationLoss", "weight": 0.2,
                "args": {"dir_offset": 0.7853, "num_bins": 2,
                         "anchor_yaw": [0, 90]}},
        "generate_weight": 1, "depth": {"weight": 1.0}}},
}
POSTPROCESS = {"gt_range": list(LR), "target_args": {"score_threshold": 0.2},
               "nms_thresh": 0.15,
               "dir_args": {"dir_offset": 0.7853, "num_bins": 2},
               "nms_topk": 64}


def _camera_config(cls, **kw):
    """The sampler's config as ``tools/train.py`` derives it for a
    camera-labelled model: the spawn radius is d_max - 2."""
    return cls(lidar_range=LR, voxel_size=VOXEL, max_cav=3, num_agents=2,
               num_vehicles=4, points_per_vehicle=60, comm_range=8.0,
               modalities={"m1": {"sensor": "camera", "final_dim": FINAL_DIM,
                                  "ncam": NCAM}},
               max_spawn_radius=GRID["ddiscr"][1] - 2.0, **kw)


# ---------------------------------------------------------------- K4, K4b
@pytest.mark.parametrize("bf16_rows", [False, True])
@pytest.mark.parametrize("kind", ["dropped", "empty_range", "long_run",
                                  "all_dropped"])
def test_splat_plain_matches_pallas(kind, bf16_rows):
    dvals, feats, ids, g, s = _splat_case(kind)
    want, vjp = jax.vjp(
        lambda d, f: splat_pallas.splat_topk(d, f, jnp.asarray(ids), s,
                                             bf16_rows),
        jnp.asarray(dvals), jnp.asarray(feats))
    want_d, want_f = vjp(jnp.asarray(g))
    td, tf = _t(dvals).requires_grad_(), _t(feats).requires_grad_()
    got = splat_topk_plain(td, tf, _t(ids), s, bf16_rows)
    # fp32 sums of up to 400 rows (long_run) in another order (with bf16_rows the
    # rounded products are the same numbers on both sides): 1e-5
    _close(got.detach().numpy(), want, 1e-5, "canvas")
    if kind == "empty_range":
        assert float(got[200:].detach().abs().max()) == 0.0
    if kind == "all_dropped":
        assert float(got.detach().abs().max()) == 0.0
    # the plain version's autograd and the explicit gather backward; the
    # JAX VJP ignores the bf16 rounding, and so do they
    got.backward(_t(g))
    bd, bf = splat_topk_bwd_plain(_t(dvals), _t(feats), _t(ids), _t(g), s)
    for name, a, b, w in (("d_dvals", td.grad, bd, want_d),
                          ("d_feats", tf.grad, bf, want_f)):
        _close(a.numpy(), w, 1e-5, name)
        _close(b.numpy(), w, 1e-5, name + " (gather)")


def test_splat_plain_drops_negative_ids():
    dvals, feats, ids, g, s = _splat_case("dropped", seed=1)
    neg = ids.copy()
    neg[ids >= s] = -7
    a = splat_topk_plain(_t(dvals), _t(feats), _t(ids), s)
    b = splat_topk_plain(_t(dvals), _t(feats), _t(neg), s)
    assert torch.equal(a, b)
    for x, y in zip(splat_topk_bwd_plain(_t(dvals), _t(feats), _t(ids), _t(g), s),
                    splat_topk_bwd_plain(_t(dvals), _t(feats), _t(neg), _t(g), s)):
        assert torch.equal(x, y)


def test_splat_wrapper_takes_plain_versions_on_cpu():
    dvals, feats, ids, g, s = _splat_case("dropped", seed=2, c=16)
    before = dict(LAUNCHES)
    td, tf = _t(dvals).requires_grad_(), _t(feats).requires_grad_()
    out = splat_topk(td, tf, _t(ids), s)
    assert torch.equal(out, splat_topk_plain(_t(dvals), _t(feats), _t(ids), s))
    out.backward(_t(g))
    bd, bf = splat_topk_bwd_plain(_t(dvals), _t(feats), _t(ids), _t(g), s)
    assert torch.equal(td.grad, bd) and torch.equal(tf.grad, bf)
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="do not match"):
        splat_topk(_t(dvals), _t(feats[:-1]), _t(ids), s)


# ---------------------------------------------------------------- helpers
def test_camera_utils_copy_equals_jax():
    for port, ref in ((camera_utils.gen_dx_bx(*(GRID[k] for k in (
            "xbound", "ybound", "zbound"))), jax_camera_utils.gen_dx_bx(*(
                GRID[k] for k in ("xbound", "ybound", "zbound")))),):
        for a, b in zip(port, ref):
            np.testing.assert_array_equal(a, b)
    for mode in ("UD", "LID"):
        np.testing.assert_array_equal(
            camera_utils.depth_discretization(2, 50, 48, mode),
            jax_camera_utils.depth_discretization(2, 50, 48, mode))
    with pytest.raises(NotImplementedError):
        camera_utils.depth_discretization(2, 50, 48, "SID")


@pytest.mark.parametrize("mode", ["LID", "UD"])
def test_bin_depth_indices_equal(mode):
    rng = np.random.RandomState(0)
    depth = rng.uniform(-5.0, 70.0, (3, 7, 11)).astype(np.float32)
    depth[0, 0, :6] = [np.nan, np.inf, -np.inf, 1000.0, 2.0, 50.0]
    want = np.asarray(jax_lss.bin_depth_indices(jnp.asarray(depth), mode,
                                                2.0, 50.0, 48))
    got = bin_depth_indices(_t(depth), mode, 2.0, 50.0, 48)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() == 0 and got.max() == 47
    with pytest.raises(NotImplementedError):
        bin_depth_indices(_t(depth), "SID", 2.0, 50.0, 48)


@pytest.mark.parametrize("target", [(6, 10), (12, 18), (6, 18), (9, 13)])
def test_center_crop_or_pad_equal(target):
    x = np.random.RandomState(1).randn(2, 3, 9, 13, 4).astype(np.float32)
    want = np.asarray(jax_lss.center_crop_or_pad(jnp.asarray(x), target))
    got = center_crop_or_pad(_t(x), target)
    np.testing.assert_array_equal(got.numpy(), want)


def test_depth_focal_and_depth_loss_match_jax():
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 3, 2, 4, 6, 8).astype(np.float32) * 2.0
    gt = rng.randint(0, 8, (2, 3, 2, 4, 6)).astype(np.int32)
    want = np.asarray(jax_depth_focal(jnp.asarray(logits), jnp.asarray(gt)))
    got = categorical_depth_focal(_t(logits), _t(gt))
    _close(got.numpy(), want, 1e-6, "focal")

    b, h, w = 2, 4, 5
    out = {"cls_preds": rng.randn(b, h, w, 2).astype(np.float32),
           "reg_preds": rng.randn(b, h, w, 14).astype(np.float32),
           "dir_preds": rng.randn(b, h, w, 4).astype(np.float32)}
    pos = (rng.rand(b, h, w, 2) < 0.2).astype(np.float32)
    target = {"pos_equal_one": pos,
              "neg_equal_one": ((rng.rand(b, h, w, 2) < 0.6) * (1 - pos)
                                ).astype(np.float32),
              "targets": rng.randn(b, h, w, 14).astype(np.float32)}
    weight = np.asarray([[1, 1, 0], [1, 0, 0]], np.float32)[:, :, None, None,
                                                             None]
    jcrit = JaxDepthLoss(HYPES["loss"]["args"])
    crit = build_loss(HYPES["loss"])
    tt = {k: _t(v) for k, v in target.items()}
    for items in ((logits, gt, weight), (logits, gt)):
        jl = jcrit({**{k: jnp.asarray(v) for k, v in out.items()},
                    "depth_items_m1": tuple(jnp.asarray(v) for v in items)},
                   {k: jnp.asarray(v) for k, v in target.items()})
        tl = crit({**{k: _t(v) for k, v in out.items()},
                   "depth_items_m1": tuple(_t(v) for v in items)}, tt)
        assert set(tl) == set(jl) and "depth_loss" in tl
        for k in jl:
            np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5,
                                       err_msg=k)
    # bare logits (inference, no GT depth): no depth term
    tl = crit({**{k: _t(v) for k, v in out.items()},
               "depth_items_m1": _t(logits)}, tt)
    assert "depth_loss" not in tl
    # generate_weight is read by nothing: the depth loss extends the plain
    # detection loss, in both packages
    assert "gen_loss" not in crit(
        {**{k: _t(v) for k, v in out.items()},
         "pred_feature": torch.zeros(2, 3), "gt_feature": torch.ones(2, 3)},
        tt)


# ---------------------------------------------------------------- sampler
@pytest.mark.parametrize("seed,batch", [(0, 1), (5 * 10000 + 3, 2)])
def test_sampler_camera_arrays_bit_equal(seed, batch):
    want = JaxScenes(_camera_config(JaxSyntheticConfig)).sample(seed, batch)
    got = SyntheticScenes(_camera_config(SyntheticConfig)).sample(seed, batch)
    assert set(got) == set(want)
    assert "imgs_m1" in got and "points_m1" not in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["imgs_m1"].shape == (batch, 3, NCAM) + FINAL_DIM + (3,)
    assert (got["depths_m1"][:, :2] < 1000.0).any()


def test_sampler_mixed_modalities_bit_equal():
    kw = dict(lidar_range=LR, voxel_size=VOXEL, max_cav=3, num_agents=3,
              points_per_agent=500, num_vehicles=4, points_per_vehicle=60,
              comm_range=8.0, modalities={
                  "m1": {"sensor": "lidar"},
                  "m2": {"sensor": "camera", "final_dim": FINAL_DIM,
                         "ncam": NCAM}})
    want = JaxScenes(JaxSyntheticConfig(**kw)).sample(11, 1)
    got = SyntheticScenes(SyntheticConfig(**kw)).sample(11, 1)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["modality_mask_m2"].tolist() == [[False, True, False]]


def test_trim_and_device_move_keep_camera_fields():
    host = SyntheticScenes(_camera_config(SyntheticConfig)).sample(1, 2)
    trimmed = trim_agent_slots(host, buckets=(2, 3))
    for k in ("imgs", "rots", "trans", "intrins", "post_rots", "post_trans",
              "depths"):
        assert trimmed[f"{k}_m1"].shape[:2] == (2, 2), k
        np.testing.assert_array_equal(trimmed[f"{k}_m1"],
                                      host[f"{k}_m1"][:, :2])
    assert trimmed["pos_equal_one"].shape == host["pos_equal_one"].shape
    moved = batch_to_device(trimmed, "cpu")
    assert moved["imgs_m1"].dtype == torch.float32
    assert set(moved) == set(trimmed)


# ---------------------------------------------------------------- trunk
@pytest.fixture(scope="module")
def cam_encoder_run():
    rng = np.random.RandomState(3)
    imgs = rng.rand(3, 64, 96, 3).astype(np.float32)
    jenc = jax_lss.CamEncoder(depth_bins=8, feat_ch=16, trunk_blocks=2)
    shapes = jax.eval_shape(lambda x: jenc.init(jax.random.PRNGKey(0), x),
                            jnp.asarray(imgs))
    variables = _random_variables(shapes, seed=4)
    enc = CamEncoder(depth_bins=8, feat_ch=16, trunk_blocks=2)
    enc.load_state_dict(flax_to_state_dict(enc, variables))
    return SimpleNamespace(imgs=imgs, jenc=jenc, variables=variables, enc=enc)


def test_cam_encoder_eval_matches_jax(cam_encoder_run):
    run = cam_encoder_run
    want = run.jenc.apply(run.variables, jnp.asarray(run.imgs), False)
    with torch.no_grad():
        got = run.enc(_t(run.imgs))
    assert got[0].shape == (3, 8, 12, 8) and got[1].shape == (3, 8, 12, 16)
    # fp32 through 12 convolutions, sums in another order: 1e-5 of the scale
    for name, g, w in zip(("depth", "feats", "logits"), got, want):
        _close(g.numpy(), w, 1e-5, name)


def test_cam_encoder_train_matches_jax(cam_encoder_run):
    run = cam_encoder_run
    want, mutated = run.jenc.apply(run.variables, jnp.asarray(run.imgs), True,
                                   mutable=["batch_stats"])
    enc = CamEncoder(depth_bins=8, feat_ch=16, trunk_blocks=2)
    enc.load_state_dict(run.enc.state_dict())
    enc.train()
    with torch.no_grad():
        got = enc(_t(run.imgs))
    # batch statistics over 3 x 8 x 12 .. 3 x 16 x 24 positions: 1e-4
    for name, g, w in zip(("depth", "feats", "logits"), got, want):
        _close(g.numpy(), w, 1e-4, name)
    stats = flax_to_state_dict(enc, {
        "params": run.variables["params"],
        "batch_stats": jax.tree_util.tree_map(np.asarray,
                                              mutated["batch_stats"])})
    buffers = dict(enc.named_buffers())
    assert len(buffers) == 2 * 10  # 10 batch norms
    for name, t in buffers.items():
        _close(t.numpy(), stats[name].numpy(), 1e-5, name)
        assert not torch.equal(t, run.enc.state_dict()[name]), name


def test_unported_camera_options_raise():
    for trunk in ("efficientnet-b0", "resnet101"):
        with pytest.raises(NotImplementedError, match=trunk):
            CamEncoder(8, 16, trunk=trunk)
    with pytest.raises(ValueError, match="unknown img_trunk"):
        CamEncoder(8, 16, trunk="vgg")
    # trunk_bf16 and half=True are ported: they build, and a half model
    # refuses to train (bf16 training is not ported)
    assert CamEncoder(8, 16, bf16=True).depth_head.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="stride-8"):
        CamEncoder(8, 16, downsample=16)
    half = HeterModel(**MODEL_KW, half=True, device="cpu")
    enc = half.branch_m1.encoder
    assert enc.cam_encode.dtype == torch.bfloat16 and enc.splat_bf16
    with pytest.raises(NotImplementedError, match="bf16 training"):
        half.train()
    for key, val in (("img_trunk", "resnet101"), ("trunk_bf16", True)):
        kw = dict(MODEL_KW, modality_args={"m1": dict(
            MODEL_KW["modality_args"]["m1"],
            encoder_args=dict(ENCODER_ARGS, **{key: val}))})
        if key == "trunk_bf16":
            enc = HeterModel(**kw, device="cpu").branch_m1.encoder
            assert enc.cam_encode.dtype == torch.bfloat16
            assert not enc.splat_bf16
            continue
        with pytest.raises(NotImplementedError):
            HeterModel(**kw, device="cpu")


# ---------------------------------------------------------------- encoder
def _camera_inputs(seed, b=1, l=2, augment=True):
    """Rendered images and calibration from the sampler, with a random
    image augmentation (post_rots / post_trans) so that the matrix inverses
    of the geometry are not trivial."""
    host = trim_agent_slots(
        SyntheticScenes(_camera_config(SyntheticConfig)).sample(seed, b),
        buckets=(l,))
    cams = {k: host[f"{k}_m1"] for k in (
        "imgs", "rots", "trans", "intrins", "post_rots", "post_trans",
        "depths")}
    if augment:
        rng = np.random.RandomState(seed)
        shape = cams["post_trans"].shape[:-1]
        ang = rng.uniform(-0.06, 0.06, shape)
        scale = rng.uniform(0.9, 1.1, shape)
        post = np.zeros(shape + (3, 3), np.float32)
        post[..., 0, 0] = scale * np.cos(ang)
        post[..., 0, 1] = -scale * np.sin(ang)
        post[..., 1, 0] = scale * np.sin(ang)
        post[..., 1, 1] = scale * np.cos(ang)
        post[..., 2, 2] = 1.0
        cams["post_rots"] = post
        cams["post_trans"] = np.concatenate(
            [rng.uniform(-4, 4, shape + (2,)), np.zeros(shape + (1,))],
            axis=-1).astype(np.float32)
    return cams


def _encoders(depth_topk, splat_bf16=False, splat_impl="auto", seed=5):
    kw = dict(grid_conf=GRID, final_dim=FINAL_DIM, feat_ch=16, trunk_blocks=1,
              depth_topk=depth_topk, splat_bf16=splat_bf16)
    jenc = jax_lss.LSSEncoder(**kw, splat_impl=splat_impl)
    cams = _camera_inputs(seed)
    jcams = {k: jnp.asarray(v) for k, v in cams.items()}
    shapes = jax.eval_shape(lambda c: jenc.init(jax.random.PRNGKey(0), c),
                            jcams)
    variables = _random_variables(shapes, seed=6)
    enc = LSSEncoder(**kw)
    enc.load_state_dict(flax_to_state_dict(enc, variables))
    tcams = {k: _t(v) for k, v in cams.items()}
    return jenc, variables, jcams, enc, tcams


def _jax_splat_arguments(jenc, variables, jcams):
    """The (dvals, feats, ids) that the JAX encoder hands its splat, taken
    by running it with ``splat_impl: pallas`` and recording the call."""
    seen = {}
    real = splat_pallas.splat_topk

    def recording(dvals, feats, ids, num_cells, bf16_rows=True):
        seen.update(dvals=np.asarray(dvals), feats=np.asarray(feats),
                    ids=np.asarray(ids), num_cells=num_cells)
        return real(dvals, feats, ids, num_cells, bf16_rows)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(splat_pallas, "splat_topk", recording)
        jenc.clone(splat_impl="pallas").apply(variables, jcams, False)
    return seen


def test_geometry_matches_jax_and_ids_do_not_flip():
    jenc, variables, jcams, enc, tcams = _encoders(depth_topk=4)
    names = ("rots", "trans", "intrins", "post_rots", "post_trans")
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    want = np.asarray(jenc.apply(
        variables, *(flat(jcams[k]) for k in names), method="_geometry"))
    got = enc._geometry(*(flat(tcams[k]) for k in names))
    assert got.shape == want.shape == (2, NCAM, 8, 8, 12, 3)
    # metres, |x| <= 40: two fp32 inverses and einsums, 1e-4 m
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # part of the frustum must fall outside the grid (dropped rows)
    cell, inb = enc.cell_ids(got)
    assert 0.2 < float(inb.float().mean()) < 0.95
    jcell, jinb = enc.cell_ids(_t(want))
    flips = int(((cell != jcell) | (inb != jinb)).sum())
    assert flips == 0, f"{flips} of {cell.numel()} frustum points change cell"


def test_topk_selection_matches_jax():
    jenc, variables, jcams, enc, tcams = _encoders(depth_topk=4)
    seen = _jax_splat_arguments(jenc, variables, jcams)
    depth, _, _ = jenc.apply(
        variables, jcams["imgs"].reshape((-1,) + FINAL_DIM + (3,)), False,
        method=lambda m, x, t: m.cam_encode(x, t))
    depth = _t(np.asarray(depth)).reshape(2, NCAM, 8, 12, 8)
    names = ("rots", "trans", "intrins", "post_rots", "post_trans")
    geom = enc._geometry(*(tcams[k].reshape((-1,) + tcams[k].shape[2:])
                           for k in names))
    dvals, cell_k, inb_k = enc.select_topk(depth, *enc.cell_ids(geom))
    # the same K bins in the same order, renormalised: 1e-6
    _close(dvals.reshape(-1, 4).numpy(), seen["dvals"], 1e-6, "dvals")
    np.testing.assert_allclose(dvals.sum(-1).numpy(), 1.0, atol=1e-6)
    agent = torch.arange(2).reshape(2, 1, 1, 1, 1) * 1024
    ids = torch.where(inb_k, agent + cell_k, torch.full_like(cell_k, 2048))
    differ = int((ids.reshape(-1, 4).numpy() != seen["ids"]).sum())
    assert differ == 0, f"{differ} of {ids.numel()} (pixel, k) ids differ"
    assert seen["num_cells"] == 2048 and (seen["ids"] == 2048).any()

    # ties resolve to the first index, as jnp.argmax does
    tied = torch.tensor([0.1, 0.3, 0.3, 0.1, 0.1, 0.05, 0.03, 0.02]).expand(
        2, NCAM, 8, 12, 8)
    cell = torch.arange(8).reshape(1, 1, 8, 1, 1).expand(2, NCAM, 8, 8, 12)
    _, picks, _ = enc.select_topk(tied, cell, torch.ones_like(cell).bool())
    assert picks[0, 0, 0, 0].tolist() == [1, 2, 0, 3]


@pytest.mark.parametrize("splat_bf16", [False, True])
def test_encoder_canvas_matches_jax(splat_bf16):
    # with bf16 rows the reference is the JAX package's kernel path: its
    # segment_sum path sums in bf16, the kernel contract sums in fp32
    jenc, variables, jcams, enc, tcams = _encoders(
        depth_topk=4, splat_bf16=splat_bf16,
        splat_impl="pallas" if splat_bf16 else "auto")
    want, (want_logits, want_gt) = jenc.apply(variables, jcams, False)
    seen = _jax_splat_arguments(jenc, variables, jcams)
    real = port_lss.splat_topk
    port_args = {}

    def injected(dvals, feats, ids, num_cells, bf16_rows):
        port_args.update(ids=ids.numpy(), bf16_rows=bf16_rows)
        return real(_t(seen["dvals"]), feats, _t(seen["ids"]), num_cells,
                    bf16_rows)

    with torch.no_grad():
        got, (logits, gt_idx) = enc(tcams)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(port_lss, "splat_topk", injected)
            got_injected, _ = enc(tcams)
    assert got.shape == (1, 2, 32, 32, 16)
    assert port_args["bf16_rows"] is splat_bf16
    assert int((port_args["ids"] != seen["ids"]).sum()) == 0
    # the canvas with the JAX ids and weights injected: the port's own
    # feature rows, fp32 sums in another order; 1e-5 (5e-3 with bf16 rows,
    # where a feature that differs in its last fp32 bits may round to the
    # neighbouring bf16 value, 2^-8 relative)
    tol = 5e-3 if splat_bf16 else 1e-5
    _close(got_injected.numpy(), want, tol, "canvas, injected")
    _close(got.numpy(), want, tol, "canvas")
    assert float(np.abs(np.asarray(want)).max()) > 0.1
    _close(logits.numpy(), want_logits, 1e-5, "depth logits")
    np.testing.assert_array_equal(gt_idx.numpy(), np.asarray(want_gt))
    assert len(np.unique(gt_idx.numpy())) > 2


def test_encoder_dense_splat_matches_segment_sum():
    jenc, variables, jcams, enc, tcams = _encoders(depth_topk=0)
    jcams.pop("depths"), tcams.pop("depths")
    want, want_logits = jenc.apply(variables, jcams, False)
    with torch.no_grad():
        got, logits = enc(tcams)
    # all 8 depth bins of every pixel, fp32 sums in another order: 1e-5
    _close(got.numpy(), want, 1e-5, "dense canvas")
    _close(logits.numpy(), want_logits, 1e-5, "depth logits")
    assert torch.is_tensor(logits)


# ---------------------------------------------------------------- the slice
def _scene(batch_size):
    scenes = SyntheticScenes(_camera_config(SyntheticConfig))
    host = trim_agent_slots(scenes.sample(seed=3, batch_size=batch_size),
                            buckets=(2, 3))
    assert host["agent_mask"].shape[1] == 2
    # the labels' first two axes (B, H' = 8) must not look like (B, L)
    assert host["pos_equal_one"].shape[1] != 3
    return scenes, host


def _jax_model():
    return JaxHeterModel(**MODEL_KW, fusion_args={"att": {"feat_dim": 32}},
                         in_head=32)


def _replayed_normal(noises):
    replay = iter(noises)
    return lambda key, shape, dtype=jnp.float32: jnp.asarray(
        next(replay)).reshape(shape).astype(dtype)


@pytest.fixture(scope="module")
def eval_run():
    """One eval frame of the small camera model in both packages: the same
    frame, weights and diffusion noise."""
    scenes, batch = _scene(1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = _jax_model()
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        b, train=False), jbatch)
    variables = _random_variables(shapes, seed=0)
    rng = np.random.RandomState(7)
    noises = [rng.randn(2, 8, 8, 32).astype(np.float32) for _ in range(3)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", _replayed_normal(noises))
        jout = jmodel.apply(variables, jbatch, train=False,
                            rngs={"diffusion": jax.random.PRNGKey(7)})
    model = HeterModel(**MODEL_KW, device="cpu")
    model.load_state_dict(flax_to_state_dict(model, variables))
    tnoises = [_t(n) for n in noises]
    with torch.inference_mode():
        tout = model(batch_to_device(batch, "cpu"), noises=tnoises)
    return SimpleNamespace(scenes=scenes, batch=batch, jout=jout, tout=tout,
                           model=model, noises=tnoises)


@pytest.mark.parametrize("key", ["message", "gt_feature", "pred_feature",
                                 "cls_preds", "reg_preds", "dir_preds"])
def test_camera_slice_outputs_match_jax(eval_run, key):
    # fp32 on both sides, sums in other orders through the trunk, the
    # splat, the neck and three UNet passes; no cell id flips on this frame
    # (test_encoder_canvas_matches_jax counts them): 1e-4 of the scale
    want = np.asarray(eval_run.jout[key], np.float32)
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    _close(eval_run.tout[key].numpy(), want, 1e-4, key)


def test_camera_slice_depth_items_and_detections(eval_run):
    logits, gt_idx, weight = eval_run.tout["depth_items_m1"]
    jlogits, jgt, jweight = eval_run.jout["depth_items_m1"]
    _close(logits.numpy(), jlogits, 1e-5, "depth logits")
    np.testing.assert_array_equal(gt_idx.numpy(), np.asarray(jgt))
    np.testing.assert_array_equal(weight.numpy(), np.asarray(jweight))
    pipe = InferencePipeline(eval_run.model, eval_run.scenes.anchors,
                             POSTPROCESS, device="cpu")
    dets = pipe.run(eval_run.batch, noises=eval_run.noises)
    assert dets.corners3d.shape == (1, 64, 8, 3)
    assert torch.isfinite(dets.scores).all()


def test_m2_att_model_constructs_at_full_width():
    import yaml

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(
            repo, "configs/opv2v/gencomm/stage1/m2_att.yaml")) as fh:
        hypes = yaml.safe_load(fh)
    args = hypes["model"]["args"]
    model = HeterModel(
        modality_args={"m1": args["m1"]}, fusion_method=args["fusion_method"],
        lidar_range=tuple(args["lidar_range"]),
        anchor_number=args["anchor_number"], use_gencomm=True,
        use_enhancer=True, device="cpu")
    enc = model.branch_m1.encoder
    assert enc.frustum.shape == (48, 48, 64, 3) and enc.depth_topk == 8
    assert [int(v) for v in enc.nx_grid] == [256, 256, 1]
    assert "branch_m1.encoder.frustum" not in model.state_dict()
    assert build_loss(hypes["loss"]).depth_weight == 1.0


@pytest.fixture(scope="module")
def train_run():
    """One train step of the small camera model in both packages: the same
    batch (2 samples x 2 agents, labels, GT depth), weights and noise."""
    _, batch = _scene(2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = _jax_model()
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        b, train=False), jbatch)
    variables = _random_variables(shapes, seed=1)
    rng = np.random.RandomState(8)
    noises = [rng.randn(4, 8, 8, 32).astype(np.float32) for _ in range(3)]
    criterion = JaxDepthLoss(HYPES["loss"]["args"])

    def loss_fn(params):
        out, mutated = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jbatch, train=True, mutable=["batch_stats"],
            rngs={"diffusion": jax.random.PRNGKey(0)})
        losses = criterion(out, jbatch)
        return losses["total_loss"], (losses, mutated["batch_stats"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", _replayed_normal(noises))
        grads, (jlosses, jstats) = jax.jit(jax.grad(loss_fn, has_aux=True))(
            variables["params"])

    model = HeterModel(**MODEL_KW, device="cpu")
    model.load_state_dict(flax_to_state_dict(model, variables))
    opt, sched = make_optimizer(HYPES, model.named_parameters())
    step = make_train_step(model, build_loss(HYPES["loss"]), opt, sched)
    losses = step(batch_to_device(batch, "cpu"),
                  noises=[_t(n) for n in noises])
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return SimpleNamespace(
        model=model, losses=losses,
        jlosses={k: float(v) for k, v in jlosses.items()},
        jgrads=flax_grads_to_torch(model, to_np(grads)),
        jstate=flax_to_state_dict(model, {
            "params": to_np(variables["params"]),
            "batch_stats": to_np(jstats)}))


def test_camera_train_step_losses_match_jax(train_run):
    assert set(train_run.losses) == set(train_run.jlosses) == {
        "cls_loss", "reg_loss", "dir_loss", "depth_loss", "total_loss"}
    for k, want in train_run.jlosses.items():
        # fp32 through the trunk, the neck and three UNet passes with batch
        # statistics, sums in another order: 1e-4 relative
        np.testing.assert_allclose(float(train_run.losses[k]), want,
                                   rtol=1e-4, err_msg=k)


def test_camera_train_step_gradients_match_jax(train_run):
    # every parameter, the image trunk's included, gets a gradient through
    # the splat's backward (features and depth weights); max|port - jax|
    # per tensor over its largest entry: 1e-3 (fp32 sums in another order
    # through train-mode batch norms)
    names = [n for n, _ in train_run.model.named_parameters()]
    assert any("cam_encode.depth_head" in n for n in names)
    err, name = _worst_grad_error(train_run.model, train_run.jgrads)
    assert err <= 1e-3, (err, name)


def test_camera_train_step_running_stats_match_jax(train_run):
    # the persistent buffers: the frustum is not one of them
    buffers = {n: t for n, t in train_run.model.state_dict().items()
               if "running_" in n}
    assert any("cam_encode" in n for n in buffers)
    for name, t in buffers.items():
        _close(t.numpy(), train_run.jstate[name].numpy(), 1e-4, name)
