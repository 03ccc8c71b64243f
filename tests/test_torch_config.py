"""The port's configs against the JAX package, on the CPU: hypes-YAML
loading, building a model and its loss from a yaml, and the yaml-built
slice.

- Every file under ``configs/``: the port's ``load_yaml`` gives the JAX
  package's dict (the same keys and values, numpy arrays by value), and the
  port's ``create_model`` / ``create_loss`` either build or raise
  ``NotImplementedError``, nothing else.
- Fourteen GenComm configs the port builds (``stage1/m1_att``,
  ``m2_att``, ``m3_att``, ``m4_att``, ``stage2/m1m2_att``, ``m1m4_att``
  and the V2X-ViT rows ``stage1/m1_v2xvit``, ``m2_v2xvit``,
  ``m3_v2xvit``, ``m4_v2xvit``, ``stage2/m1m2_v2xvit``, ``m1m4_v2xvit``
  and DAIR-V2X's ``stage1/m1_v2xvit`` and ``m3_v2xvit``) and the HEAL
  configs of ``HEAL``: the port's model has the parameter names and shapes
  of ``jax.eval_shape`` of the JAX model's init, mapped through
  ``weights.py``.
- Narrowed copies of ``stage1/m1_att`` and ``stage2/m1m2_att`` (a 32 x 16 m
  range, narrow widths; the same hypes dict into both packages): heads with
  the same weights and injected diffusion noise, and the losses of
  ``create_loss``.
"""

import copy
import functools
import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from gencomm_tpu.config import yaml_utils as jax_yaml
from gencomm_tpu.data.decorate import host_decorate_pillars
from gencomm_tpu.data.synthetic import (
    SyntheticConfig as JaxSyntheticConfig, SyntheticScenes as JaxScenes,
)
from gencomm_tpu.loss import create_loss as jax_create_loss
from gencomm_tpu.models import create_model as jax_create_model

from gencomm_tpu_torch.config import yaml_utils
from gencomm_tpu_torch.data.bucketing import trim_agent_slots
from gencomm_tpu_torch.loss import create_loss
from gencomm_tpu_torch.models import create_model
from gencomm_tpu_torch.models.heter_baseline import model_kwargs
from gencomm_tpu_torch.pipeline import batch_to_device
from gencomm_tpu_torch.tools.inference import override_range
from gencomm_tpu_torch.weights import flax_to_state_dict

from tests.test_torch_kernels import _close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))
GENCOMM = ["configs/opv2v/gencomm/stage1/m1_att.yaml",
           "configs/opv2v/gencomm/stage1/m2_att.yaml",
           "configs/opv2v/gencomm/stage1/m4_att.yaml",
           "configs/opv2v/gencomm/stage2/m1m2_att.yaml",
           "configs/opv2v/gencomm/stage2/m1m4_att.yaml",
           "configs/opv2v/gencomm/stage1/m1_v2xvit.yaml",
           "configs/opv2v/gencomm/stage1/m2_v2xvit.yaml",
           "configs/opv2v/gencomm/stage1/m4_v2xvit.yaml",
           "configs/opv2v/gencomm/stage2/m1m2_v2xvit.yaml",
           "configs/opv2v/gencomm/stage2/m1m4_v2xvit.yaml",
           "configs/dairv2x/gencomm/stage1/m1_v2xvit.yaml",
           "configs/opv2v/gencomm/stage1/m3_att.yaml",
           "configs/opv2v/gencomm/stage1/m3_v2xvit.yaml",
           "configs/dairv2x/gencomm/stage1/m3_v2xvit.yaml"]
# the opv2v HEAL configs: stage 1, the stage-2 single models and the final
# m1 + m2 inference
HEAL = [f"configs/opv2v/heal/{p}.yaml" for p in (
    "stage1/m1_pyramid", "stage1/m2_pyramid", "stage1/m3_pyramid",
    "stage1/m4_pyramid", "stage2/m1_single_pyramid",
    "stage2/m2_single_pyramid", "stage2/m4_single_pyramid",
    "final_infer/m1m2")]
# one config of each of the paper's heterogeneous baselines
BASELINES = [f"configs/opv2v/baselines/stage2/{p}.yaml" for p in (
    "backalign/m1m2_att", "codefilling/m1m2_att", "mpda/m1m2_att",
    "stamp/m0m2_att")]
# V2X-Real's multi-class GenComm configs and one of each baseline
V2XREAL = [f"configs/v2xreal/{p}.yaml" for p in (
    "gencomm/stage1/m1_att", "gencomm/stage1/m2_att", "gencomm/stage1/m3_att",
    "gencomm/stage2/m1m2_att", "baselines/stage2/backalign/m1m2_att",
    "baselines/stage2/codefilling/m1m2_att", "baselines/stage2/mpda/m1m2_att",
    "baselines/stage2/stamp/m0m2_att")]
SMALL_RANGE = [-16.0, -8.0, -3.0, 16.0, 8.0, 1.0]


def _same(a, b, path="hypes"):
    """Recursive equality: dict keys, sequence lengths, numpy arrays by
    value and dtype, everything else with ==."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


# ---------------------------------------------------------------- yaml
def test_configs_are_found():
    assert len(CONFIGS) >= 250 and all(c in CONFIGS for c in GENCOMM)


@pytest.mark.parametrize("config", CONFIGS)
def test_load_yaml_matches_jax(config):
    path = os.path.join(REPO, config)
    _same(yaml_utils.load_yaml(path), jax_yaml.load_yaml(path))


def test_load_yaml_prefers_the_runs_config_and_leaves_pyyaml_alone(tmp_path):
    path = os.path.join(REPO, GENCOMM[0])
    hypes = yaml_utils.load_yaml(path)
    hypes["name"] = "the run's own"
    yaml_utils.save_yaml(hypes, str(tmp_path / "config.yaml"))
    assert yaml_utils.load_yaml(path, str(tmp_path))["name"] == "the run's own"
    # the scientific-notation resolver lives on the port's own loader
    assert yaml_utils.load_yaml(str(tmp_path / "config.yaml"))[
        "optimizer"]["args"]["eps"] == 1e-10
    assert yaml.load("a: 1e-4", Loader=yaml_utils._Loader)["a"] == 1e-4
    assert "_Loader" not in repr(yaml.SafeLoader.yaml_implicit_resolvers)


def test_update_yaml_after_a_range_override_matches_jax():
    path = os.path.join(REPO, GENCOMM[0])
    big = [-32.0, -16.0, -3.0, 32.0, 16.0, 1.0]
    got = override_range(yaml_utils.load_yaml(path), big)
    # the JAX package's --range override (tools/inference.py:70-95)
    want = jax_yaml.load_yaml(path)
    want["cav_lidar_range"] = list(big)
    want["preprocess"]["cav_lidar_range"] = list(big)
    want["postprocess"]["anchor_args"]["cav_lidar_range"] = list(big)
    want["postprocess"]["gt_range"] = list(big)
    for setting in want.get("heter", {}).get("modality_setting", {}).values():
        setting.setdefault("preprocess", {})["cav_lidar_range"] = list(big)
    margs = want["model"]["args"]
    margs["lidar_range"] = list(big)
    for mcfg in margs.values():
        if isinstance(mcfg, dict) and "lidar_range" in mcfg.get(
                "encoder_args", {}):
            mcfg["encoder_args"]["lidar_range"] = list(big)
    want = jax_yaml.update_yaml(want)
    _same(got, want)
    assert got["postprocess"]["anchor_args"]["W"] == 160


def test_update_dict_merges_nested_blocks():
    base = {"a": {"b": 1, "c": 2}, "d": 3}
    want = jax_yaml.update_dict(copy.deepcopy(base), {"a": {"b": 5}, "d": 4})
    assert yaml_utils.update_dict(base, {"a": {"b": 5}, "d": 4}) == want


# ---------------------------------------------------------------- build
@functools.lru_cache(maxsize=None)
def _build_outcome(config):
    """'built' or the NotImplementedError's message; the model's
    parameters on the meta device (no values drawn)."""
    hypes = yaml_utils.load_yaml(os.path.join(REPO, config))
    try:
        with torch.device("meta"):
            create_model(hypes, device="meta")
        create_loss(hypes)
    except NotImplementedError as exc:
        return str(exc)
    return "built"


@pytest.mark.parametrize("config", CONFIGS)
def test_every_config_builds_or_raises_not_implemented(config):
    outcome = _build_outcome(config)
    assert outcome == "built" or "not ported" in outcome, outcome


def test_build_count_and_the_roadmap_items_named(capsys):
    outcomes = {c: _build_outcome(c) for c in CONFIGS}
    built = sorted(c for c, o in outcomes.items() if o == "built")
    with capsys.disabled():
        print(f"\n{len(built)} of {len(outcomes)} configs build in the port")
    assert all(c in built for c in GENCOMM + HEAL + BASELINES + V2XREAL)
    # 98 before the HEAL pyramid slice, + 22 pyramid cores + 14
    # supervise_single configs = 134, + 43 with a SECOND modality = 177,
    # + 40 of the heterogeneous baselines (OPV2V's and DAIR-V2X's) = 217,
    # + VoxelNet, PIXOR and the legacy second / second_intermediate cores =
    # 221, + V2X-Real's 32 multi-class configs = 253
    assert len(built) >= 253
    # each refusal names the ROADMAP item that ports what is missing: only
    # item 19's legacy cores are left, no multi-class heads
    for c, o in outcomes.items():
        assert o == "built" or "ROADMAP item 19" in o, (c, o)
        assert "multi-class" not in o, (c, o)
        assert o == "built" or not c.startswith("configs/v2xreal/"), (c, o)


def _shape_batch(hypes, points=1000):
    """ShapeDtypeStructs of a 1-sample, 2-agent batch of the hypes'
    modalities (decorated pillar fields, SECOND's raw points, camera
    arrays)."""
    s = jax.ShapeDtypeStruct
    b = {"agent_mask": s((1, 2), jnp.bool_),
         "pairwise_t_matrix": s((1, 2, 2, 4, 4), jnp.float32)}
    for m, mc in hypes["model"]["args"].items():
        if not (m.startswith("m") and m[1:].isdigit()):
            continue
        b[f"modality_mask_{m}"] = s((1, 2), jnp.bool_)
        if mc.get("sensor_type", "lidar") == "camera":
            dac = mc["encoder_args"]["data_aug_conf"]
            n, (h, w) = dac.get("Ncams", 4), dac["final_dim"]
            b[f"imgs_{m}"] = s((1, 2, n, h, w, 3), jnp.float32)
            for k, tail in (("rots", (3, 3)), ("intrins", (3, 3)),
                            ("post_rots", (3, 3)), ("trans", (3,)),
                            ("post_trans", (3,))):
                b[f"{k}_{m}"] = s((1, 2, n) + tail, jnp.float32)
        elif mc.get("core_method") == "second":
            b[f"points_{m}"] = s((1, 2, points, 4), jnp.float32)
            b[f"point_mask_{m}"] = s((1, 2, points), jnp.bool_)
        else:
            b[f"decorated_{m}"] = s((1, 2, points, 10), jnp.float32)
            b[f"gids_{m}"] = s((1, 2, points), jnp.int32)
            b[f"dvalid_{m}"] = s((1, 2, points), jnp.bool_)
    return b


# DAIR-V2X's range gives fused maps (50 x 126 for PointPillars) which
# V2X-ViT's windows of 4, 8 and 16 do not divide: the JAX model cannot even
# be initialised on them (suspected reference fault k, test_torch_fusion.py).
# Parameter shapes do not depend on the map (nor, for SECOND, on x and y),
# so those configs' are taken on the 204.8 x 102.4 m range.
WINDOWED_RANGE = {c: [-102.4, -51.2, -3.5, 102.4, 51.2, 1.5] for c in (
    "configs/dairv2x/gencomm/stage1/m1_v2xvit.yaml",
    "configs/dairv2x/gencomm/stage1/m3_v2xvit.yaml")}


def _load_both(config):
    """(the port's hypes, the JAX package's) of a config, on
    ``WINDOWED_RANGE`` where it names one."""
    out = []
    for load in (yaml_utils.load_yaml, jax_yaml.load_yaml):
        hypes = load(os.path.join(REPO, config))
        if config in WINDOWED_RANGE:
            args = hypes["model"]["args"]
            args["lidar_range"] = list(WINDOWED_RANGE[config])
            for c in args.values():
                if isinstance(c, dict) and "encoder_args" in c:
                    c["encoder_args"]["lidar_range"] = list(
                        WINDOWED_RANGE[config])
        out.append(hypes)
    return out


@pytest.mark.parametrize("config", GENCOMM + HEAL + BASELINES + V2XREAL)
def test_gencomm_config_has_jax_parameter_names_and_shapes(config):
    hypes, jhypes = _load_both(config)
    jmodel = jax_create_model(jhypes)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, b, train=False),
        _shape_batch(hypes))
    with torch.device("meta"):
        model = create_model(hypes, device="meta")
    # flax_to_state_dict raises on a flax variable without a counterpart,
    # a key of the port's state_dict that no flax variable fills, or a
    # shape that differs after the layout change
    sd = flax_to_state_dict(model, jax.tree_util.tree_map(
        lambda x: np.zeros(x.shape, np.float32), shapes))
    assert set(sd) == set(model.state_dict())
    n_flax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
        shapes["params"]))
    assert n_flax == sum(p.numel() for p in model.parameters())
    # the multi-class heads (A * C * C class scores) come across too
    c = int(hypes["model"]["args"].get("num_class", 1))
    a = hypes["model"]["args"].get("anchor_number", 2)
    assert sd["heads.cls_head.weight"].shape[0] == a * c * c
    assert sd["heads.reg_head.weight"].shape[0] == 7 * a * c

def test_m1m2_camera_bev_lands_on_the_lidar_grid():
    """At full width: the camera branch's 64 x 64 feature (a 102.4 m
    square) is padded to the lidar branch's 64 x 128 (204.8 x 102.4 m)."""
    hypes = yaml_utils.load_yaml(os.path.join(REPO, GENCOMM[3]))
    with torch.device("meta"):
        model = create_model(hypes, device="meta")
    assert model.lidar_range == (-102.4, -51.2, -3, 102.4, 51.2, 1)
    # lidar: a 512 x 256 pillar grid, the neck at stride 4; camera: a
    # 256 x 256 grid of 0.4 m cells, the same neck
    assert model.camera_bev_shape("m2", 64, 64) == (64, 128)
    assert list(model.camera_extent) == ["m2"]


# the camera model that chip_smoke.py carried by hand before it was built
# from m2_att.yaml, kept as it was
_CAMERA_RANGE = (-51.2, -51.2, -3.0, 51.2, 51.2, 1.0)
_CAMERA_GRID = {"xbound": [-51.2, 51.2, 0.4], "ybound": [-51.2, 51.2, 0.4],
                "zbound": [-10, 10, 20.0], "ddiscr": [2, 50, 48],
                "mode": "LID"}
_NECK = {"layer_nums": [3, 5, 8], "layer_strides": [2, 2, 2],
         "num_filters": [64, 128, 256], "upsample_strides": [1, 2, 4],
         "num_upsample_filter": [128, 128, 128]}
_SHRINK = {"kernal_size": [3], "stride": [2], "padding": [1], "dim": [128],
           "input_dim": 384}
CHIP_SMOKE_CAMERA = dict(
    modality_args={"m1": {
        "core_method": "lift_splat_shoot", "sensor_type": "camera",
        "encoder_args": {"grid_conf": _CAMERA_GRID,
                         "data_aug_conf": {"final_dim": [384, 512],
                                           "Ncams": 4},
                         "img_downsample": 8, "img_features": 128,
                         "trunk_blocks": 2, "depth_topk": 8,
                         "lidar_range": list(_CAMERA_RANGE)},
        "backbone_args": _NECK,
        "shrink_header": _SHRINK,
    }},
    fusion_method="att", lidar_range=_CAMERA_RANGE, anchor_number=2,
    use_gencomm=True, use_enhancer=True, half=False)


def _contains(got, want, path="kw"):
    """Every key of ``want`` is in ``got`` with the same value."""
    if isinstance(want, dict):
        for k, v in want.items():
            assert k in got, f"{path}.{k}"
            _contains(got[k], v, f"{path}.{k}")
    else:
        assert got == want, (path, got, want)


def test_m2_att_builds_the_camera_model_chip_smoke_carried_by_hand():
    hypes = yaml_utils.load_yaml(os.path.join(REPO, GENCOMM[1]))
    kw = model_kwargs(hypes)
    _contains(kw, CHIP_SMOKE_CAMERA)
    # the yaml's extra keys are ones the constructor does not read, and the
    # two models have the same parameters
    with torch.device("meta"):
        a = create_model(hypes, device="meta")
        from gencomm_tpu_torch.models.heter_baseline import HeterModel

        b = HeterModel(**CHIP_SMOKE_CAMERA, device="meta")
    assert {k: v.shape for k, v in a.state_dict().items()} == \
        {k: v.shape for k, v in b.state_dict().items()}
    assert (kw["use_gencomm"], kw["use_enhancer"], kw["half"],
            kw["missing_message_rate"], kw["gencomm_trick"]) == (
        True, True, False, 0.0, False)


# ---------------------------------------------------------------- slice
def narrowed(config, **extra):
    """A copy of a GenComm config at a 32 x 16 m range and narrow widths;
    the same dict goes into both packages."""
    with open(os.path.join(REPO, config)) as fh:
        h = yaml.safe_load(fh)
    h["cav_lidar_range"] = list(SMALL_RANGE)
    h["preprocess"]["cav_lidar_range"] = list(SMALL_RANGE)
    h["postprocess"]["gt_range"] = list(SMALL_RANGE)
    h["postprocess"]["anchor_args"]["cav_lidar_range"] = list(SMALL_RANGE)
    h["train_params"].update(batch_size=1, max_cav=3, save_freq=1,
                             eval_freq=1)
    args = h["model"]["args"]
    args["lidar_range"] = list(SMALL_RANGE)
    for m, c in args.items():
        if not (isinstance(c, dict) and "encoder_args" in c):
            continue
        enc = c["encoder_args"]
        enc["lidar_range"] = list(SMALL_RANGE)
        if "pillar_vfe" in enc:
            enc["pillar_vfe"]["num_filters"] = [16]
        if "grid_conf" in enc:
            enc["grid_conf"].update(xbound=[-8.0, 8.0, 0.4],
                                    ybound=[-8.0, 8.0, 0.4], ddiscr=[2, 10, 8])
            enc["data_aug_conf"]["final_dim"] = [32, 64]
            enc.update(img_features=16, depth_topk=4, trunk_blocks=1)
        c["backbone_args"] = {"layer_nums": [1, 1], "layer_strides": [2, 2],
                              "num_filters": [16, 32],
                              "upsample_strides": [1, 2],
                              "num_upsample_filter": [16, 16]}
        c["shrink_header"] = {"kernal_size": [3], "stride": [2],
                              "padding": [1], "dim": [32], "input_dim": 32}
    args["att"] = {"feat_dim": 32}
    args["in_head"] = 32
    if "gencomm" in args:
        args["gencomm"]["model"]["ch"] = 4
    h.update(extra)
    return h


def small_scenes_config(hypes, jax_side=False):
    """The synthetic sampler of a narrowed config, few points."""
    mods = {}
    for m, c in hypes["model"]["args"].items():
        if isinstance(c, dict) and "encoder_args" in c:
            if c.get("sensor_type") == "camera":
                dac = c["encoder_args"]["data_aug_conf"]
                mods[m] = {"sensor": "camera",
                           "final_dim": tuple(dac["final_dim"]), "ncam": 4}
            else:
                mods[m] = {"sensor": "lidar"}
    kw = dict(lidar_range=tuple(SMALL_RANGE), max_cav=3, num_agents=2,
              points_per_agent=2000, num_vehicles=6, points_per_vehicle=60,
              comm_range=12.0, modalities=mods)
    if jax_side:
        return JaxSyntheticConfig(**kw)
    from gencomm_tpu_torch.data.synthetic import SyntheticConfig

    return SyntheticConfig(**kw)


def _replayed_normal(noises):
    replay = iter(noises)
    return lambda key, shape, dtype=jnp.float32: jnp.asarray(
        next(replay)).reshape(shape).astype(dtype)


@pytest.fixture(scope="module", params=[(GENCOMM[0], {}), (GENCOMM[3], {}),
                                        (GENCOMM[0], {"trick": True})],
                ids=["m1_att", "m1m2_att", "m1_att_trick"])
def slice_run(request):
    """One eval frame of a narrowed yaml through both packages: the same
    hypes dict, frame (decorated by the JAX package's host decoration),
    weights and diffusion noise. ``trick``: the prediction masked where the
    true feature is zero (``gencomm_trick``)."""
    config, model_args = request.param
    raw = narrowed(config)
    raw["model"]["args"].update(model_args)
    hypes = jax_yaml.update_yaml(copy.deepcopy(raw))
    port_hypes = yaml_utils.update_yaml(copy.deepcopy(raw))
    _same(port_hypes, hypes)
    # the sampler gives slot 0 (the ego) the first modality, slot 1 the
    # next: a lidar ego and a camera agent for m1m2_att
    host = JaxScenes(small_scenes_config(hypes, jax_side=True)).sample(3, 1)
    batch = host_decorate_pillars(trim_agent_slots(host), hypes)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jax_create_model(hypes)
    # flax's own initial weights, as test_torch_pipeline.py takes them
    variables = jax.tree_util.tree_map(np.array, jmodel.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        jbatch, train=False))
    n = batch["agent_mask"].size
    rng = np.random.RandomState(7)
    noises = [rng.randn(n, 10, 20, 32).astype(np.float32) for _ in range(3)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", _replayed_normal(noises))
        jout = jmodel.apply(variables, jbatch, train=False,
                            rngs={"diffusion": jax.random.PRNGKey(7)})
    model = create_model(port_hypes, device="cpu")
    model.load_state_dict(flax_to_state_dict(model, variables))
    with torch.inference_mode():
        tout = model(batch_to_device(batch, "cpu"),
                     noises=[torch.from_numpy(z) for z in noises])
    return dict(hypes=hypes, port_hypes=port_hypes, batch=batch, jout=jout,
                tout=tout)


@pytest.mark.parametrize("key", ["message", "pred_feature", "cls_preds",
                                 "reg_preds", "dir_preds"])
def test_yaml_built_slice_matches_jax(slice_run, key):
    # the tolerance of test_torch_pipeline.py: fp32 sums in other orders
    # through ~40 layers and three UNet passes, 1e-4 of the scale
    want = np.asarray(slice_run["jout"][key], np.float32)
    assert np.abs(want).max() > 0
    _close(slice_run["tout"][key].numpy(), want, 1e-4, key)


def test_yaml_built_losses_match_jax(slice_run):
    """create_loss of both packages on the JAX slice's outputs and the
    frame's labels (the loss alone, as test_torch_train.py holds it)."""
    jout, batch = slice_run["jout"], slice_run["batch"]
    keys = ("cls_preds", "reg_preds", "dir_preds", "gt_feature",
            "pred_feature", "feature_mask")
    out = {k: np.asarray(jout[k]) for k in keys}
    labels = {k: batch[k] for k in ("pos_equal_one", "neg_equal_one",
                                    "targets")}
    want = jax_create_loss(slice_run["hypes"])(
        {k: jnp.asarray(v) for k, v in out.items()},
        {k: jnp.asarray(v) for k, v in labels.items()})
    got = create_loss(slice_run["port_hypes"])(
        {k: torch.from_numpy(np.array(v)) for k, v in out.items()},
        {k: torch.from_numpy(np.array(v)) for k, v in labels.items()})
    assert set(got) == set(want) and "gen_loss" in got
    for k in want:  # fp32 sums over the anchors in another order
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


@functools.lru_cache(maxsize=None)
def _supervise_single_outputs():
    """(JAX hypes, port hypes, seeded head outputs with per-agent heads, the
    sampler's labels with the per-agent ones) of a narrowed stage1/m1_att
    with supervise_single: 2 samples of 3 agent slots."""
    raw = narrowed(GENCOMM[0])
    raw["model"]["args"]["supervise_single"] = True
    hypes = jax_yaml.update_yaml(copy.deepcopy(raw))
    port_hypes = yaml_utils.update_yaml(copy.deepcopy(raw))
    cfg = small_scenes_config(hypes, jax_side=True)
    cfg.per_agent_labels = True
    batch = trim_agent_slots(JaxScenes(cfg).sample(5, 2), buckets=(3,))
    labels = {k: batch[k] for k in batch if k.startswith(
        ("pos_equal_one", "neg_equal_one", "targets"))}
    b, l = batch["agent_mask"].shape
    h, w, a = labels["pos_equal_one"].shape[1:]
    rng = np.random.RandomState(8)
    out = {"feature_mask": batch["agent_mask"].reshape(-1)}
    for n, lead in ((b, ""), (b * l, "_single")):
        for key, ch in (("cls", a), ("reg", 7 * a), ("dir", 2 * a)):
            out[f"{key}_preds{lead}"] = rng.randn(n, h, w, ch).astype(
                np.float32)
    for key in ("gt_feature", "pred_feature"):
        out[key] = rng.randn(b * l, 4, 8, 32).astype(np.float32)
    return hypes, port_hypes, out, labels


@pytest.mark.parametrize("suffix", ["", "_single"])
def test_create_loss_wraps_supervise_single_as_jax_does(suffix):
    """``supervise_single``: the criterion of both packages on the outputs
    of the JAX model with per-agent heads (narrowed stage1/m1_att) and the
    sampler's per-agent labels, in the plain pass and in the train step's
    "_single" pass; the single terms join as ``single_<term>``."""
    hypes, port_hypes, out, labels = _supervise_single_outputs()
    assert "pos_equal_one_single" in labels and "cls_preds_single" in out
    crit = jax_create_loss(hypes)
    want = jax.jit(lambda o, t: crit(o, t, suffix))(
        {k: jnp.asarray(v) for k, v in out.items()},
        {k: jnp.asarray(v) for k, v in labels.items()})
    got = create_loss(port_hypes)(
        {k: torch.from_numpy(np.array(v)) for k, v in out.items()},
        {k: torch.from_numpy(np.array(v)) for k, v in labels.items()}, suffix)
    assert set(got) == set(want) and "single_cls_loss" in got
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    # the range and the depth weight of a camera config, injected
    crit = create_loss(yaml_utils.load_yaml(os.path.join(REPO, GENCOMM[1])))
    assert crit.depth_weight == 1.0


def test_missing_messages_drop_non_ego_cells_at_eval():
    """``missing_message`` (stage 2's eval-time robustness): about 40% of
    the non-ego message cells dropped, drawn from the caller's generator;
    the ego's kept; none in train mode; no generator, no draw."""
    hypes = yaml_utils.update_yaml(narrowed(GENCOMM[0]))
    host = JaxScenes(small_scenes_config(hypes, jax_side=True)).sample(3, 1)
    batch = batch_to_device(host_decorate_pillars(trim_agent_slots(host),
                                                  hypes), "cpu")
    plain = create_model(hypes, device="cpu")
    hypes["model"]["args"]["missing_message"] = True
    model = create_model(hypes, device="cpu")
    model.load_state_dict(plain.state_dict())
    assert (model.missing_message_rate, plain.missing_message_rate) == (0.4, 0)
    noises = [torch.zeros(batch["agent_mask"].numel(), 10, 20, 32)] * 3
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    with torch.inference_mode():
        msg = model(batch, noises=noises, generator=gen())["message"]
        again = model(batch, noises=noises, generator=gen())["message"]
        full = plain(batch, noises=noises)["message"]
        with pytest.raises(ValueError, match="generator"):
            model(batch, noises=noises)
    assert torch.equal(msg, again) and torch.equal(msg[:, 0], full[:, 0])
    sent = (full[:, 1:] != 0).any(-1)
    dropped = (msg[:, 1:] == 0).all(-1) & sent
    kept = (msg[:, 1:] == full[:, 1:]).all(-1) & sent
    assert bool((dropped | kept)[sent].all())
    share = float(dropped.sum()) / float(sent.sum())
    assert 0.3 < share < 0.5, share
    model.train()
    with torch.no_grad():
        train_out = model(batch, noises=noises)  # no draw in train mode
    assert torch.isfinite(train_out["message"]).all()
