"""The HEAL pyramid slice of the port against the JAX package, on the CPU.

The same seeded numpy inputs and the same weights (``weights.py`` carries
flax's variables) go through both packages:

- the residual blocks (``BasicBlock``, ``Bottleneck``) at strides 1 and 2,
  eval and train (running statistics after the step), within 1e-5 x
  max(1, |ref|);
- ``weighted_fuse`` with a masked agent and pixels no agent reaches, and
  its gradient into the feature and the score; the nearest resize of the
  score masks against ``jax.image.resize`` (half-pixel centres, which
  ``F.interpolate(mode="nearest")`` misses); ``camera_fov_mask``;
  ``PyramidFusion`` in its collab and single modes;
- narrowed copies of the HEAL yamls through ``create_model``:
  ``final_infer/m1m2`` (a lidar ego and a camera agent, so that the camera
  crop and the field-of-view score mask run) at eval, the single model,
  and ``heter_model_baseline_ms`` with attentive and max fusion, within
  1e-4 x max(1, |ref|);
- ``PointPillarPyramidLoss`` in its three cases, ``create_loss``'s
  ``supervise_single`` wrapper, the sampler's per-agent labels (bit for
  bit), one collab train step with the occupancy pass against
  ``jax.grad`` (gradients as ``test_torch_train.py`` holds them) and the
  ``heter_pyramid_single`` freeze.
"""

import copy
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
import yaml

from gencomm_tpu.config import yaml_utils as jax_yaml
from gencomm_tpu.data.decorate import host_decorate_pillars
from gencomm_tpu.data.synthetic import (
    SyntheticConfig as JaxSyntheticConfig, SyntheticScenes as JaxScenes,
)
from gencomm_tpu.loss import create_loss as jax_create_loss
from gencomm_tpu.models import create_model as jax_create_model
from gencomm_tpu.models.backbones import resnet_bev as jax_resnet
from gencomm_tpu.models.fuse import pyramid as jax_pyramid
from gencomm_tpu.models import heter_pyramid as jax_heter_pyramid

from gencomm_tpu_torch.config import yaml_utils
from gencomm_tpu_torch.data.bucketing import trim_agent_slots
from gencomm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from gencomm_tpu_torch.loss import create_loss
from gencomm_tpu_torch.models import create_model
from gencomm_tpu_torch.models import heter_pyramid
from gencomm_tpu_torch.models.backbones import resnet_bev
from gencomm_tpu_torch.models.encoders import point_pillar
from gencomm_tpu_torch.models.encoders.second import SECONDEncoder
from gencomm_tpu_torch.models.fuse import pyramid
from gencomm_tpu_torch.pipeline import batch_to_device
from gencomm_tpu_torch.train import trainer
from gencomm_tpu_torch.weights import flax_grads_to_torch, flax_to_state_dict

from tests.test_torch_kernels import _close
from tests.test_torch_train import _random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEAL = os.path.join(REPO, "configs", "opv2v", "heal")
M1_PYRAMID = os.path.join(HEAL, "stage1", "m1_pyramid.yaml")
M1_SINGLE = os.path.join(HEAL, "stage2", "m1_single_pyramid.yaml")
M2_SINGLE = os.path.join(HEAL, "stage2", "m2_single_pyramid.yaml")
M1M2 = os.path.join(HEAL, "final_infer", "m1m2.yaml")
SMALL_RANGE = [-16.0, -8.0, -3.0, 16.0, 8.0, 1.0]
CAMERA_GRID = dict(xbound=[-8.0, 8.0, 0.4], ybound=[-8.0, 8.0, 0.4],
                   ddiscr=[2, 10, 8])
MODULE_TOL = 1e-5
SLICE_TOL = 1e-4
GRAD_TOL = 5e-3  # test_torch_train.py's: bf16 canvas values may flip


# ------------------------------------------------------------ the configs
def narrowed_pyramid(config, core=None, **extra):
    """A HEAL yaml at a 32 x 16 m range (a camera grid of 16 x 16 m) and
    narrow widths; the same dict goes into both packages."""
    with open(config) as fh:
        h = yaml.safe_load(fh)
    for block in (h, h["preprocess"], h["postprocess"]["anchor_args"]):
        block["cav_lidar_range"] = list(SMALL_RANGE)
    h["postprocess"]["gt_range"] = list(SMALL_RANGE)
    h["train_params"].update(batch_size=1, max_cav=3, save_freq=1,
                             eval_freq=1)
    args = h["model"]["args"]
    args["lidar_range"] = list(SMALL_RANGE)
    for c in args.values():
        if not (isinstance(c, dict) and "encoder_args" in c):
            continue
        enc = c["encoder_args"]
        enc["lidar_range"] = list(SMALL_RANGE)
        if "pillar_vfe" in enc:
            enc["pillar_vfe"]["num_filters"] = [16]
        if "grid_conf" in enc:
            for grid in (enc["grid_conf"], c["camera_mask_args"]["grid_conf"]):
                grid.update(CAMERA_GRID)
            enc["data_aug_conf"]["final_dim"] = [32, 64]
            enc.update(img_features=16, depth_topk=4, trunk_blocks=1)
        c["backbone_args"] = {"layer_nums": [1, 1], "layer_strides": [2, 2],
                              "num_filters": [16, 32],
                              "upsample_strides": [1, 2],
                              "num_upsample_filter": [16, 16]}
    # ResNeXt levels of 32 and 64 features: 64- and 128-wide groups of 32
    args["fusion_backbone"] = {
        "resnext": True, "layer_nums": [1, 2], "layer_strides": [1, 2],
        "num_filters": [32, 64], "upsample_strides": [1, 2],
        "num_upsample_filter": [16, 16]}
    h["loss"]["args"]["pyramid"].update(relative_downsample=[1, 2],
                                        weight=[0.4, 0.2])
    if core is not None:
        h["model"]["core_method"] = core
    args.update(extra)
    return h


def hypes_pair(raw):
    """(JAX-derived hypes, port-derived hypes) of one raw dict."""
    return (jax_yaml.update_yaml(copy.deepcopy(raw)),
            yaml_utils.update_yaml(copy.deepcopy(raw)))


def scenes_config(hypes, jax_side=False, **kw):
    """The sampler of a narrowed config, few points, per-agent labels."""
    mods = {}
    for m, c in hypes["model"]["args"].items():
        if isinstance(c, dict) and "encoder_args" in c:
            mods[m] = ({"sensor": "camera", "final_dim": (32, 64), "ncam": 4}
                       if c.get("sensor_type") == "camera"
                       else {"sensor": "lidar"})
    stride = hypes["postprocess"]["anchor_args"]["feature_stride"]
    kw = dict(dict(lidar_range=tuple(SMALL_RANGE), max_cav=3, num_agents=2,
                   feature_stride=stride,
                   points_per_agent=2000, num_vehicles=6,
                   points_per_vehicle=60, comm_range=12.0, modalities=mods,
                   per_agent_labels=True), **kw)
    return (JaxSyntheticConfig if jax_side else SyntheticConfig)(**kw)


def frame(hypes, seed=3, batch_size=1):
    """A trimmed, decorated batch of the JAX sampler (labels included)."""
    host = JaxScenes(scenes_config(hypes, jax_side=True)).sample(seed,
                                                                 batch_size)
    return host_decorate_pillars(trim_agent_slots(host), hypes)


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return batch_to_device(batch, "cpu")


@functools.lru_cache(maxsize=None)
def model_run(name):
    """One eval forward of a narrowed yaml in both packages, the same
    frame and seeded weights: (JAX hypes, port hypes, batch, variables,
    JAX output, port model, port output)."""
    raw = {
        "collab_m1m2": lambda: narrowed_pyramid(M1M2),
        "single_m1": lambda: narrowed_pyramid(M1_SINGLE),
        "ms_att": lambda: narrowed_pyramid(
            M1_PYRAMID, core="heter_model_baseline_ms", fusion_method="att",
            fusion_backbone=MS_BACKBONE),
        "ms_max": lambda: narrowed_pyramid(
            M1_PYRAMID, core="heter_model_baseline_ms", fusion_method="max",
            fusion_backbone=MS_BACKBONE),
    }[name]()
    jh, ph = hypes_pair(raw)
    batch = frame(jh)
    jmodel = jax_create_model(jh)
    jb = _jnp(batch)
    variables = _random_variables(jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, b, train=False), jb), 5)
    jout = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(variables,
                                                                 jb)
    model = create_model(ph, device="cpu")
    model.load_state_dict(flax_to_state_dict(model, variables))
    with torch.inference_mode():
        out = model(_torch(batch))
    return dict(jh=jh, ph=ph, batch=batch, variables=variables,
                jout=jax.tree_util.tree_map(np.asarray, jout), model=model,
                out=out)


MS_BACKBONE = {"layer_nums": [1, 1], "layer_strides": [1, 2],
               "num_filters": [32, 48], "upsample_strides": [1, 2],
               "num_upsample_filter": [16, 16]}


# ---------------------------------------------------------------- modules
def _block_pair(kind, stride):
    in_ch, features = 24, 32  # a downsample branch at both strides
    if kind == "basic":
        return (jax_resnet.BasicBlock(features, stride=stride),
                resnet_bev.BasicBlock(in_ch, features, stride)), in_ch
    return (jax_resnet.Bottleneck(features, stride=stride),
            resnet_bev.Bottleneck(in_ch, features, stride)), in_ch


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kind", ["basic", "bottleneck"])
def test_residual_block_matches_flax(kind, stride, train):
    (jblock, block), in_ch = _block_pair(kind, stride)
    x = np.random.RandomState(1).randn(2, 10, 12, in_ch).astype(np.float32)
    variables = _random_variables(jax.eval_shape(
        jblock.init, jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    block.load_state_dict(flax_to_state_dict(block, variables))
    block.train(train)
    if train:
        want, mutated = jblock.apply(variables, jnp.asarray(x), train=True,
                                     mutable=["batch_stats"])
    else:
        want = jblock.apply(variables, jnp.asarray(x))
    got = block(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 10 // stride, 12 // stride, 32)
    _close(got.detach().numpy(), np.asarray(want), MODULE_TOL, kind)
    if train:
        stats = flax_to_state_dict(block, {
            "params": variables["params"],
            "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                  mutated["batch_stats"])})
        for k, t in block.state_dict().items():
            if "running" in k:
                _close(t.numpy(), stats[k].numpy(), MODULE_TOL, k)


def test_bottleneck_conv_is_grouped_and_padded_as_flax():
    """ResNeXt-32x4d: the 3x3 conv holds (width, width / 32, 3, 3)
    weights, and at stride 2 on an even map pads (1, 1)."""
    block = resnet_bev.Bottleneck(64, 64, stride=2)
    assert tuple(block.Conv_1.weight.shape) == (128, 4, 3, 3)
    assert block.Conv_1.groups == 32 and block.Conv_1.padding == 1
    assert block.BatchNorm_0.eps == 1e-5
    assert resnet_bev.ResNetBEVBackbone(8, [1], [2], [16], [2], [8]).deblock0\
        .BatchNorm_0.eps == 1e-3


def _fuse_inputs(seed=3):
    """Features, positive scores and rigid warps of 3 agent slots, one
    absent; the warps leave some ego pixels outside every map."""
    rng = np.random.RandomState(seed)
    b, l, h, w, c = 2, 3, 12, 16, 8
    feat = rng.randn(b, l, h, w, c).astype(np.float32)
    score = rng.uniform(0.05, 1.0, (b, l, h, w, 1)).astype(np.float32)
    ang = rng.uniform(-0.5, 0.5, (b, l, l))
    affine = np.zeros((b, l, l, 2, 3), np.float32)
    affine[..., 0, 0] = affine[..., 1, 1] = np.cos(ang)
    affine[..., 0, 1], affine[..., 1, 0] = -np.sin(ang), np.sin(ang)
    affine[..., :, 2] = rng.uniform(-0.8, 0.8, (b, l, l, 2))
    mask = np.array([[True, True, False], [True, False, True]])
    return feat, score, affine, mask


def test_weighted_fuse_matches_jax_with_its_gradients():
    feat, score, affine, mask = _fuse_inputs()
    r = np.random.RandomState(4).randn(2, 12, 16, 8).astype(np.float32)

    def jloss(f, s):
        out = jax_pyramid.weighted_fuse(f, s, jnp.asarray(affine),
                                        jnp.asarray(mask))
        return (out * r).sum(), out

    (_, want), (gf, gs) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(feat),
                                              jnp.asarray(score))
    tf = torch.from_numpy(feat).requires_grad_(True)
    ts = torch.from_numpy(score).requires_grad_(True)
    got = pyramid.weighted_fuse(tf, ts, torch.from_numpy(affine),
                                torch.from_numpy(mask))
    (got * torch.from_numpy(r)).sum().backward()
    # some ego pixels see no valid agent: their weight is 0, not 1 / L
    no_agent = (np.abs(np.asarray(want)) == 0).all(-1)
    assert no_agent.any() and (got.detach().numpy()[no_agent] == 0).all()
    _close(got.detach().numpy(), np.asarray(want), MODULE_TOL, "fused")
    _close(tf.grad.numpy(), np.asarray(gf), MODULE_TOL, "d feat")
    _close(ts.grad.numpy(), np.asarray(gs), MODULE_TOL, "d score")
    # the masked slot gets no gradient
    assert (tf.grad.numpy()[0, 2] == 0).all() and (
        tf.grad.numpy()[1, 1] == 0).all()


@pytest.mark.parametrize("down", [2, 4])
def test_nearest_resize_matches_jax_image_resize(down):
    mask = np.random.RandomState(down).randint(0, 2, (1, 2, 16, 24, 1)) \
        .astype(np.float32)
    hw = (16 // down, 24 // down)
    want = np.asarray(jax.image.resize(jnp.asarray(mask), (1, 2) + hw + (1,),
                                       method="nearest"))
    got = pyramid.resize_nearest(torch.from_numpy(mask), hw).numpy()
    np.testing.assert_array_equal(got, want)
    # torch's "nearest" takes the top-left pixel of each block instead
    legacy = F.interpolate(torch.from_numpy(mask[0]).permute(0, 3, 1, 2),
                           size=hw, mode="nearest").permute(0, 2, 3, 1)
    assert not np.array_equal(legacy.numpy(), want[0])


@pytest.mark.parametrize("shape,ratios", [((20, 40), (1.0, 2.0)),
                                          ((64, 128), (1.0, 2.0)),
                                          ((50, 126), (0.78125, 1.96875))])
def test_camera_fov_mask_matches_jax(shape, ratios):
    want = np.asarray(jax_heter_pyramid.camera_fov_mask(shape, *ratios))
    got = heter_pyramid.camera_fov_mask(shape, *ratios).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size


@pytest.mark.parametrize("single", [False, True], ids=["collab", "single"])
def test_pyramid_fusion_matches_jax(single):
    cfg = narrowed_pyramid(M1M2)["model"]["args"]["fusion_backbone"]
    feat, _, affine, mask = _fuse_inputs(5)
    x = np.random.RandomState(6).randn(2, 3, 12, 16, 24).astype(np.float32)
    sm = np.ones((2, 3, 12, 16, 1), np.float32)
    sm[:, 1, :3] = 0.0  # a field-of-view mask on one agent
    jm = jax_pyramid.PyramidFusion.from_config(cfg)
    if single:
        xx = jnp.asarray(x.reshape(6, 12, 16, 24))
        args = ()
        kw = dict(single=True)
    else:
        xx = jnp.asarray(x)
        args = (jnp.asarray(affine), jnp.asarray(mask))
        kw = dict(score_mask=jnp.asarray(sm))
    variables = _random_variables(jax.eval_shape(
        lambda a: jm.init(jax.random.PRNGKey(0), a, *args, **kw), xx), 7)
    want, wocc = jax.jit(lambda v, a: jm.apply(v, a, *args, **kw))(
        variables, xx)
    pm = pyramid.PyramidFusion.from_config(cfg, 24)
    pm.load_state_dict(flax_to_state_dict(pm, variables))
    with torch.inference_mode():
        if single:
            got, occ = pm(torch.from_numpy(x.reshape(6, 12, 16, 24)),
                          single=True)
        else:
            got, occ = pm(torch.from_numpy(x), torch.from_numpy(affine),
                          torch.from_numpy(mask),
                          score_mask=torch.from_numpy(sm))
    _close(got.numpy(), np.asarray(want), MODULE_TOL, "decoded")
    assert len(occ) == len(wocc) == 2
    for i, (a, b) in enumerate(zip(occ, wocc)):
        assert a.shape[0] == 6
        _close(a.numpy(), np.asarray(b), MODULE_TOL, f"occupancy {i}")


# ---------------------------------------------------------------- models
@pytest.mark.parametrize("key", ["cls_preds", "reg_preds", "dir_preds",
                                 "occ_single_list"])
@pytest.mark.parametrize("name", ["collab_m1m2", "single_m1"])
def test_pyramid_model_matches_jax(name, key):
    run = model_run(name)
    want, got = run["jout"][key], run["out"][key]
    if key == "occ_single_list":
        assert len(got) == len(want) == 2
        pairs = list(zip(got, want))
    else:
        pairs = [(got, want)]
    b, l = run["batch"]["agent_mask"].shape
    lead = b if name.startswith("collab") and key != "occ_single_list" \
        else b * l
    for a, w in pairs:
        assert a.shape[0] == lead and np.abs(w).max() > 0
        _close(a.numpy(), w, SLICE_TOL, key)


def test_collab_m1m2_runs_the_camera_crop_and_fov_mask():
    """The narrowed m1m2: a lidar ego and a camera agent; the camera's 20 x
    20 map is padded to the lidar's 20 x 40 and masked to its field of
    view (16 x 16 cells) at eval."""
    run = model_run("collab_m1m2")
    batch = run["batch"]
    assert batch["modality_mask_m1"][0].tolist()[:2] == [True, False]
    assert batch["modality_mask_m2"][0].tolist()[:2] == [False, True]
    seen = {}
    real = pyramid.resize_nearest

    def recording(mask, hw):
        seen.setdefault("mask", mask)
        return real(mask, hw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pyramid, "resize_nearest", recording)
        with torch.inference_mode():
            run["model"](_torch(batch))
    mask = seen["mask"].numpy()
    assert mask.shape == (1, 2, 20, 40, 1)
    assert mask[0, 0].sum() == 20 * 40 and mask[0, 1].sum() == 16 * 16
    # train mode applies no score mask
    seen.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pyramid, "resize_nearest", recording)
        run["model"].train()
        try:
            with torch.no_grad():
                run["model"](_torch(batch))
        finally:
            run["model"].eval()
    assert not seen


@pytest.mark.parametrize("key", ["cls_preds", "reg_preds", "dir_preds",
                                 "cls_preds_single"])
@pytest.mark.parametrize("name", ["ms_att", "ms_max"])
def test_heter_ms_model_matches_jax(name, key):
    run = model_run(name)
    _close(run["out"][key].numpy(), run["jout"][key], SLICE_TOL, key)


def test_models_have_the_interface_the_tools_use():
    run = model_run("collab_m1m2")
    model = run["model"]
    assert model.device == torch.device("cpu")
    assert model.modalities == ["m1", "m2"]
    assert model.heads_single is None and model.use_gencomm is False
    assert model.agent_buckets == (2, 3, 5)
    assert model.lidar_encoder("m1").voxel_size == (0.4, 0.4, 4.0)
    assert model_run("ms_att")["model"].heads_single is not None


def test_second_modality_still_raises_item_18():
    """The final four-modality model builds, its m3 branch SECOND (ported
    with tests/test_torch_second.py). The raw-point input of a pillar
    encoder, which raised naming item 18, is ported too: the narrowed
    m1_pyramid on the JAX sampler's raw points (no host decoration) gives
    the JAX model's raw-path heads."""
    hypes = yaml_utils.load_yaml(os.path.join(HEAL, "final_infer",
                                              "m1m2m3m4.yaml"))
    with torch.device("meta"):
        model = create_model(hypes, device="meta")
    assert isinstance(model.lidar_encoder("m3"), SECONDEncoder)
    jh, ph = hypes_pair(narrowed_pyramid(M1_PYRAMID))
    batch = trim_agent_slots(JaxScenes(scenes_config(
        jh, jax_side=True)).sample(3, 1))
    assert "points_m1" in batch and "decorated_m1" not in batch
    jmodel = jax_create_model(jh)
    jb = _jnp(batch)
    variables = _random_variables(jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, b, train=False), jb), 5)
    jout = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(variables,
                                                                 jb)
    model = create_model(ph, device="cpu")
    model.load_state_dict(flax_to_state_dict(model, variables))
    with torch.inference_mode():
        out = model(_torch(batch))
    for key in ("cls_preds", "reg_preds", "dir_preds"):
        want = np.asarray(jout[key])
        assert np.abs(want).max() > 0
        _close(out[key].numpy(), want, SLICE_TOL, key)


# ---------------------------------------------------------------- labels
def test_per_agent_labels_match_jax_bit_for_bit():
    jh, _ = hypes_pair(narrowed_pyramid(M1M2))
    want = JaxScenes(scenes_config(jh, jax_side=True)).sample(11, 2)
    got = SyntheticScenes(scenes_config(jh)).sample(11, 2)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["pos_equal_one_single"].shape[:2] == (2, 3)
    assert got["pos_equal_one_single"][:, :2].sum() > 0
    # the labels draw nothing from the scene's stream: every other array is
    # the one a sampler without them gives
    plain = SyntheticScenes(scenes_config(jh, per_agent_labels=False)
                            ).sample(11, 2)
    assert set(got) - set(plain) == {"pos_equal_one_single",
                                     "neg_equal_one_single", "targets_single"}
    for k in plain:
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)
    # the ego's own labels are the ego-frame labels
    np.testing.assert_array_equal(got["pos_equal_one_single"][:, 0],
                                  got["pos_equal_one"])


# ---------------------------------------------------------------- losses
def _loss_pair(run, suffix=""):
    """The pyramid loss of both packages on the JAX run's outputs and the
    frame's labels."""
    out = {k: v for k, v in run["jout"].items() if not k.startswith("depth")}
    labels = {k: v for k, v in run["batch"].items() if k.startswith(
        ("pos_equal_one", "neg_equal_one", "targets"))}
    crit = jax_create_loss(run["jh"])
    want = jax.jit(lambda o, t: crit(o, t, suffix))(
        jax.tree_util.tree_map(jnp.asarray, out), _jnp(labels))
    got = create_loss(run["ph"])(
        jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), out),
        _torch(labels), suffix)
    return got, want


@pytest.mark.parametrize("case", [("collab_m1m2", ""),
                                  ("collab_m1m2", "_single"),
                                  ("single_m1", "")],
                         ids=["collab_fused", "collab_occupancy", "single"])
def test_pyramid_loss_matches_jax(case):
    got, want = _loss_pair(model_run(case[0]), case[1])
    assert set(got) == set(want)
    if case[1] == "_single":
        assert set(got) == {"pyramid_loss", "total_loss"}
    elif case[0] == "single_m1":
        assert "pyramid_loss" in got and "cls_loss" in got
    for k in want:  # fp32 sums over the anchors in another order
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
        assert float(want[k]) > 0


# ---------------------------------------------------------------- training
@pytest.fixture(scope="module")
def collab_step():
    """One train step of the narrowed m1_pyramid (supervise_single: the
    occupancy pass) in both packages: the same batch of 2 samples and the
    same weights. JAX: jax.grad of the criterion plus its "_single" pass,
    as ``make_train_step(supervise_single=True)`` takes it, in fp32 and in
    fp64. The port: its own step, and the step again with the pillar canvas
    of JAX's encoder injected."""
    jh, ph = hypes_pair(narrowed_pyramid(M1_PYRAMID))
    batch = frame(jh, seed=5, batch_size=2)
    jmodel = jax_create_model(jh)
    variables = _random_variables(jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, b, train=False), _jnp(batch)), 0)
    jcrit = jax_create_loss(jh)

    def loss_fn(params, stats, jb):
        out, mutated = jmodel.apply({"params": params, "batch_stats": stats},
                                    jb, train=True, mutable=["batch_stats"])
        losses = jcrit(out, jb)
        single = jcrit(out, jb, suffix="_single")
        losses = dict(losses, **{(k if k not in losses else f"{k}_single"): v
                                 for k, v in single.items()
                                 if k != "total_loss"})
        losses["total_loss"] = losses["total_loss"] + single["total_loss"]
        return losses["total_loss"], (losses, mutated["batch_stats"])

    def jax_step(dtype):
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), variables)
        jb = {k: jnp.asarray(a, dtype) if a.dtype == np.float32
              else jnp.asarray(a) for k, a in batch.items()}
        grads, (losses, stats) = jax.jit(jax.grad(loss_fn, has_aux=True))(
            v["params"], v["batch_stats"], jb)
        enc = {c: v[c]["enc_branch_m1"]["encoder"]
               for c in ("params", "batch_stats")}
        canvas, _ = _jax_canvas(jh, enc, jb)
        return jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), (grads, losses, stats,
                                                  canvas))

    grads, jlosses, jstats, jcanvas = jax_step(jnp.float32)
    with jax.enable_x64(True):
        grads64, _, _, jcanvas64 = jax_step(jnp.float64)

    def port_step(canvas=None):
        model = create_model(ph, device="cpu")
        model.load_state_dict(flax_to_state_dict(model, variables))
        opt, sched = trainer.make_optimizer(ph, model.named_parameters())
        step = trainer.make_train_step(model, create_loss(ph), opt, sched,
                                       supervise_single=True)
        real, seen = point_pillar.pillar_canvas, []

        def canvas_fn(*args):
            seen.append(real(*args))
            if canvas is None:
                return seen[-1]
            return seen[-1] + (torch.tensor(canvas).to(torch.bfloat16)
                               .reshape(seen[-1].shape) - seen[-1]).detach()

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(point_pillar, "pillar_canvas", canvas_fn)
            losses = step(_torch(batch))
        return model, losses, seen[0].detach()

    model, losses, canvas = port_step()
    same_canvas, _, _ = port_step(jcanvas)
    to_port = functools.partial(flax_grads_to_torch, model)
    return dict(
        model=model, losses=losses, same_canvas=same_canvas,
        canvas_flips=int((canvas.float().numpy().reshape(jcanvas.shape)
                          != jcanvas).sum()),
        canvas_size=jcanvas.size, canvas64_equal=np.array_equal(jcanvas,
                                                                 jcanvas64),
        jlosses={k: float(v) for k, v in jlosses.items()},
        jgrads=to_port(grads), jgrads64=to_port(grads64),
        jstats=flax_to_state_dict(model, {"params": variables["params"],
                                          "batch_stats": jstats}))


def _jax_canvas(hypes, enc, jb):
    """The train-mode pillar canvas of JAX's m1 encoder (bf16 values, as
    float32)."""
    from gencomm_tpu.models.encoders.point_pillar import PointPillarEncoder

    e = hypes["model"]["args"]["m1"]["encoder_args"]
    encoder = PointPillarEncoder(
        voxel_size=tuple(e["voxel_size"]), lidar_range=tuple(e["lidar_range"]),
        num_filters=tuple(e["pillar_vfe"]["num_filters"]))
    canvas, _ = jax.jit(lambda v, d, g, m: encoder.apply(
        v, None, None, True, decorated=d, gids=g, dvalid=m,
        mutable=["batch_stats"]))(enc, jb["decorated_m1"], jb["gids_m1"],
                                  jb["dvalid_m1"])
    return canvas.astype(jnp.float32), None


def test_collab_step_losses_match_jax(collab_step):
    run = collab_step
    assert set(run["losses"]) == set(run["jlosses"]) == {
        "cls_loss", "reg_loss", "dir_loss", "pyramid_loss", "total_loss"}
    for k, want in run["jlosses"].items():
        np.testing.assert_allclose(float(run["losses"][k]), want, rtol=1e-4,
                                   err_msg=k)


def test_collab_step_gradients_match_jax(collab_step):
    """The train-mode step is ill-conditioned at this random-weight point:
    JAX's own fp32 gradients lie up to ~2% of a tensor's largest entry from
    its fp64 ones (the bias and 1x1 weights before a train-mode norm that
    removes what they add, zero in exact arithmetic: the noise of
    cancelling terms), and one bf16 canvas value that rounds the other way
    (1 of 204,800 here) moves them by up to ~20%. So with JAX's canvas
    values injected, the port's gradients are held to JAX's fp64 ones
    within 3x JAX's own fp32 error of each tensor plus GRAD_TOL of its
    largest entry (the PFN's weights read 5.8e-3 of theirs: a pillar's
    maximum row may differ where two rows tie within the fp32 noise of
    the train-mode point norm); the port's own canvas may differ from
    JAX's in at most 1e-4 of its values (test_torch_train.py's bound)."""
    run = collab_step
    assert run["canvas64_equal"]
    assert run["canvas_flips"] <= 1e-4 * run["canvas_size"]
    worst = []
    for name, p in run["same_canvas"].named_parameters():
        exact = run["jgrads64"][name].numpy()
        scale = float(np.abs(exact).max())
        assert scale > 0, f"{name} has no gradient in JAX"
        jax_err = float(np.abs(run["jgrads"][name].numpy() - exact).max())
        err = float(np.abs(p.grad.numpy() - exact).max())
        worst.append((err / (3.0 * jax_err + GRAD_TOL * scale), name))
    ratio, name = max(worst)
    assert ratio <= 1.0, (ratio, name)


def test_collab_step_running_stats_match_jax(collab_step):
    for name, t in collab_step["model"].named_buffers():
        _close(t.numpy(), collab_step["jstats"][name].numpy(), SLICE_TOL, name)


def test_single_freeze_keeps_the_pyramid_and_heads_bit_for_bit():
    """heter_pyramid_single in training: the train CLI's freeze of
    ``pyramid_backbone`` and ``heads``; one step leaves their parameters
    and running statistics bit for bit and moves the branch."""
    from gencomm_tpu_torch.tools import train as train_cli
    from types import SimpleNamespace

    jh, ph = hypes_pair(narrowed_pyramid(M2_SINGLE))
    frozen = train_cli.frozen_predicate(
        SimpleNamespace(freeze_prefixes=""), ph)
    batch = frame(jh, seed=2)
    model = create_model(ph, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt, sched = trainer.make_optimizer(ph, model.named_parameters(),
                                        frozen_predicate=frozen)
    step = trainer.make_train_step(model, create_loss(ph), opt, sched,
                                   frozen_predicate=frozen)
    losses = step(_torch(batch))
    assert {"pyramid_loss", "depth_loss"} <= set(losses)
    after = model.state_dict()
    kept = [k for k in after if k.startswith(("pyramid_backbone.", "heads."))]
    assert kept and all(torch.equal(after[k], before[k]) for k in kept)
    moved = [k for k in after if not torch.equal(after[k], before[k])]
    assert moved and all(k.startswith(("encoder_m2.", "backbone_m2."))
                         for k in moved)


def test_fault_m_dairv2x_m1m2_camera_crop_is_one_column_short():
    """Suspected reference fault m: the pyramid crops a camera's map to
    int(W * ratio) (``models/heter_pyramid.py:204-208``), where the GenComm
    model rounds. On DAIR-V2X's 201.6 m range 100.8 / 51.2 lies just below
    1.96875, so the camera's 128 columns become 251 where the lidar branch
    gives 252, and the JAX model cannot combine the two (a shape error at
    init). The port copies the int()
    (``gencomm_tpu_torch/models/heter_pyramid.py:_branch``)."""
    from tests.test_torch_config import _shape_batch

    path = os.path.join(REPO, "configs", "dairv2x", "heal", "final_infer",
                        "m1m2.yaml")
    hypes = jax_yaml.load_yaml(path)
    jmodel = jax_create_model(hypes)
    with pytest.raises(TypeError, match="252"):
        jax.eval_shape(lambda b: jmodel.init(
            {"params": jax.random.PRNGKey(0)}, b, train=False),
            _shape_batch(hypes))
    lr = hypes["model"]["args"]["lidar_range"]
    grid = hypes["model"]["args"]["m2"]["encoder_args"]["grid_conf"]
    assert int(128 * (lr[3] / grid["xbound"][1])) == 251
    with torch.device("meta"):
        model = create_model(yaml_utils.load_yaml(path), device="meta")
    assert model._ratios(grid)[1] == lr[3] / grid["xbound"][1]
