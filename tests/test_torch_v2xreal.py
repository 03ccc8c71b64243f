"""V2X-Real's loader and multi-class detection in the port against the JAX
package, on the CPU, on the fixture tree of ``tests/test_v2xreal.py`` (its
writer copied here: a scenario of two vehicles and a roadside unit, and a
2023-04-07 scenario of one vehicle and the roadside unit; a Car and a Truck
in range, a Pedestrian out of it, a Tree of no known class).

- ``V2XRealDataset``: every key of every sample and of ``collate`` equal to
  the JAX loader's, in training and eval, in the four ``dataset_mode``
  topologies; the class alignment when an object is dropped; the unknown
  class dropped; the eval exclusion of 2023-04-07; ``class_id``;
- ``generate_anchor_box_multiclass`` / ``generate_label_multiclass`` bit
  for bit (the fixture's and the shipped yaml's anchor settings, the
  fixture's GT and random GT);
- ``decode_and_nms_multiclass`` against JAX's: the kept boxes as sets,
  labels equal, scores within 1e-6, corners within 1e-4;
- the four V2X-Real losses: values within 1e-5 relative and gradients
  within 1e-4 of the largest, against ``jax.grad``;
- the multi-class heads' widths and a narrowed V2X-Real GenComm stage-1
  model with weights carried across: heads within 1e-4 of their scale;
- the slice: the port's inference CLI on the fixture against JAX's
  ``_multiclass_eval`` with the same weights and diffusion noise, the
  per-class APs and mAPs within 1e-6; the CLIs' batches, and one train-CLI
  epoch with ``--dataset v2xreal``.

JAX's jitted decode is built once for the module (``jax_decode``). The
torch side runs on one thread (``one_torch_thread``).
"""

import copy
import json
import os
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from gencomm_tpu.config import yaml_utils as jax_yaml
from gencomm_tpu.data import postprocessor as jax_post
from gencomm_tpu.data import v2xreal as jax_v2xreal
from gencomm_tpu.data.decorate import host_decorate_pillars
from gencomm_tpu.loss import create_loss as jax_create_loss
from gencomm_tpu.models import create_model as jax_create_model
from gencomm_tpu.tools import inference as jax_inference
from gencomm_tpu.tools import train as jax_train_cli

from gencomm_tpu_torch.config import yaml_utils
from gencomm_tpu_torch.data import postprocessor
from gencomm_tpu_torch.data import v2xreal
from gencomm_tpu_torch.data.bucketing import trim_agent_slots
from gencomm_tpu_torch.loss import create_loss
from gencomm_tpu_torch.models import create_model
from gencomm_tpu_torch.models.gencomm.diffusion import GenCommDiffusion
from gencomm_tpu_torch.models.heads import DetectionHeads
from gencomm_tpu_torch.pipeline import InferencePipeline, batch_to_device
from gencomm_tpu_torch.tools import inference
from gencomm_tpu_torch.tools import train as train_cli
from gencomm_tpu_torch.train import checkpoint
from gencomm_tpu_torch.utils.transformation_utils import x_to_world
from gencomm_tpu_torch.weights import flax_to_state_dict

from tests.test_torch_config import narrowed
from tests.test_torch_datasets import assert_samples_equal
from tests.test_torch_kernels import _close
from tests.test_torch_train import _random_variables

LIDAR_RANGE = [-16.0, -8.0, -3.0, 16.0, 8.0, 1.0]
# the narrowed yamls' range: 32 x 16 m, V2X-Real's heights
SMALL_V2XREAL = [-16.0, -8.0, -15.0, 16.0, 8.0, 15.0]
V2XREAL_M1 = "configs/v2xreal/gencomm/stage1/m1_att.yaml"
CLASSES = 3

ANCHOR_GEN = [
    {"class_name": "vehicle", "anchor_sizes": [[3.9, 1.6, 1.56]],
     "anchor_rotations": [0, 1.57], "anchor_bottom_heights": [-1.78],
     "align_center": True, "feature_map_stride": 4,
     "matched_threshold": 0.6, "unmatched_threshold": 0.45},
    {"class_name": "pedestrian", "anchor_sizes": [[0.8, 0.6, 1.73]],
     "anchor_rotations": [0, 1.57], "anchor_bottom_heights": [-0.6],
     "align_center": True, "feature_map_stride": 4,
     "matched_threshold": 0.5, "unmatched_threshold": 0.35},
    {"class_name": "truck", "anchor_sizes": [[8.0, 3.0, 3.0]],
     "anchor_rotations": [0, 1.57], "anchor_bottom_heights": [-1.78],
     "align_center": True, "feature_map_stride": 4,
     "matched_threshold": 0.6, "unmatched_threshold": 0.45},
]
OBJECTS = {
    100: {"obj_type": "Car", "location": [5.0, 2.0, 0.0],
          "angle": [0.0, 20.0, 0.0], "center": [0.0, 0.0, 0.78],
          "extent": [1.95, 0.8, 0.78]},
    101: {"obj_type": "Pedestrian", "location": [60.0, 30.0, 0.0],
          "angle": [0.0, 0.0, 0.0], "center": [0.0, 0.0, 0.85],
          "extent": [0.4, 0.3, 0.85]},
    102: {"obj_type": "Truck", "location": [-6.0, -3.0, 0.0],
          "angle": [0.0, 95.0, 0.0], "center": [0.0, 0.0, 1.5],
          "extent": [4.0, 1.5, 1.5]},
    103: {"obj_type": "Tree", "location": [2.0, -4.0, 0.0],
          "angle": [0.0, 0.0, 0.0], "center": [0.0, 0.0, 1.0],
          "extent": [0.5, 0.5, 1.0]},
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one thread: the suite runs several workers on the
    machine's cores, where small operators split over every core wait on
    one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_scenario(sc_dir, cav_poses, n_ts=2, rng=None):
    """The writer of tests/test_v2xreal.py: per CAV and timestamp the
    objects' yaml and 600 points (KITTI .bin) on the Car and the Truck in
    the CAV's frame."""
    rng = rng or np.random.RandomState(7)
    for cav_id, pose in cav_poses.items():
        cav_dir = os.path.join(sc_dir, cav_id)
        os.makedirs(cav_dir, exist_ok=True)
        for t in range(n_ts):
            ts = f"{t:06d}"
            params = {
                "lidar_pose": [float(x) for x in pose],
                "vehicles": {
                    oid: {k: (list(map(float, v)) if isinstance(v, list)
                              else v) for k, v in obj.items()}
                    for oid, obj in OBJECTS.items()},
            }
            with open(os.path.join(cav_dir, f"{ts}.yaml"), "w") as f:
                yaml.dump(params, f)
            world = []
            for obj in (OBJECTS[100], OBJECTS[102]):
                c = np.asarray(obj["location"], np.float64) + [0, 0, 1.0]
                world.append(c + rng.uniform(-1.2, 1.2, (300, 3))
                             * [1, 0.6, 0.5])
            world = np.concatenate(world)
            hom = np.concatenate([world, np.ones((len(world), 1))], 1)
            local = (hom @ np.linalg.inv(x_to_world(list(pose))).T)[:, :3]
            pts = np.concatenate([local, rng.uniform(0, 1, (len(local), 1))],
                                 1).astype(np.float32)
            pts.tofile(os.path.join(cav_dir, f"{ts}.bin"))


def _params(root, dataset_mode="vc"):
    return {
        "root_dir": root, "validate_dir": root, "dataset_mode": dataset_mode,
        "train_params": {"max_cav": 3}, "comm_range": 120,
        "input_source": ["lidar"], "label_type": "lidar",
        "preprocess": {"cav_lidar_range": list(LIDAR_RANGE)},
        "postprocess": {
            "max_num": 10, "order": "hwl", "gt_range": list(LIDAR_RANGE),
            "nms_thresh": 0.15,
            "anchor_args": {
                "cav_lidar_range": list(LIDAR_RANGE),
                "l": 3.9, "w": 1.6, "h": 1.56, "r": [0, 90],
                "vw": 0.4, "vh": 0.4, "feature_stride": 4, "num": 2,
                "anchor_generator_config": [dict(c) for c in ANCHOR_GEN]},
            "target_args": {"pos_threshold": 0.6, "neg_threshold": 0.45,
                            "score_threshold": 0.2},
        },
    }


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("v2xreal"))
    _write_scenario(os.path.join(root, "2023-03-17_scene0"),
                    {"1": [0.0, 0.0, 1.9, 0, 0, 0],
                     "-1": [10.0, 3.0, 4.5, 0, 15, 0],
                     "2": [-8.0, -2.0, 1.9, 0, 180, 0]})
    _write_scenario(os.path.join(root, "2023-04-07_scene1"),
                    {"1": [0.0, 0.0, 1.9, 0, 0, 0],
                     "-1": [10.0, 3.0, 4.5, 0, 15, 0]})
    return root


@pytest.fixture(scope="module")
def jax_decode():
    """JAX's decode (jitted where it is defined: one build for the module's
    shapes)."""
    return jax_post.decode_and_nms_multiclass


# ---------------------------------------------------------------- loader
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("mode", ["vc", "ic", "v2v", "i2i"])
def test_v2xreal_samples_match_jax(root, mode, train):
    got_ds = v2xreal.V2XRealDataset(_params(root, mode), train=train,
                                    max_points=1024)
    want_ds = jax_v2xreal.V2XRealDataset(_params(root, mode), train=train,
                                         max_points=1024)
    assert len(got_ds) == len(want_ds) > 0
    assert got_ds.num_class == want_ds.num_class == CLASSES
    np.testing.assert_array_equal(got_ds.anchors_mc, want_ds.anchors_mc)
    for rnd in range(2):
        assert list(got_ds.scenario_database) == list(
            want_ds.scenario_database)
        for sc in got_ds.scenario_database:
            assert list(got_ds.scenario_database[sc]) == list(
                want_ds.scenario_database[sc])
        got = [got_ds[i] for i in range(len(got_ds))]
        want = [want_ds[i] for i in range(len(want_ds))]
        for i, (g, w) in enumerate(zip(got, want)):
            assert_samples_equal(g, w, f"{mode} round {rnd} sample {i}")
            assert "neg_equal_one" not in g
        assert_samples_equal(got_ds.collate(got), want_ds.collate(want),
                             f"{mode} collate")
        got_ds.reinitialize()
        want_ds.reinitialize()


def test_classes_align_unknown_dropped_and_eval_exclusion(root):
    ds = v2xreal.V2XRealDataset(_params(root), train=False, max_points=1024)
    s = ds[0]
    n = int(s["gt_mask"].sum())
    # the Pedestrian is out of range, the Tree of no class: the Car and the
    # Truck stay, in yaml order, their classes aligned with their boxes
    assert n == 2 and s["gt_classes"][:n].tolist() == [1, 3]
    assert s["gt_boxes"][1, 5] > 6.0  # the Truck's length (hwl)
    assert s["point_mask_m1"][0].sum() == 600
    assert s["pos_equal_one"].shape == (10, 20, CLASSES * 2)
    assert s["targets"].shape == (10, 20, CLASSES * 2 * 7)
    blocks = s["pos_equal_one"].reshape(10, 20, CLASSES, 2)
    assert (blocks[:, :, 0] == 1).any() and (blocks[:, :, 2] == 3).any()
    assert not (blocks[:, :, 1] > 0).any()
    assert all("2023-04-07" not in sc for sc in ds.scenario_database)
    for mode, train, kept in (("vc", True, True), ("v2v", False, True),
                              ("ic", False, False)):
        names = v2xreal.V2XRealDataset(_params(root, mode), train=train,
                                       max_points=64).scenario_database
        assert any("2023-04-07" in sc for sc in names) == kept
    order = v2xreal.V2XRealDataset(_params(root, "ic"), train=False,
                                   max_points=64).scenario_database
    assert list(order["2023-03-17_scene0"]) == ["-1", "1", "2"]
    with pytest.raises(ValueError, match="dataset_mode"):
        v2xreal.V2XRealDataset(_params(root, "v2i"), train=False)


def test_class_id_matches_jax():
    names = [n for ns in v2xreal.SUPER_CLASS_MAP.values() for n in ns] + [
        "vehicle", "Truck", "truck", "Tree", "", "PEDESTRIAN"]
    for name in names:
        for key in ("obj_type", "class"):
            assert v2xreal.class_id({key: name}) == \
                jax_v2xreal.class_id({key: name}), name
    assert v2xreal.CLASS_NAMES == jax_v2xreal.CLASS_NAMES


# ---------------------------------------------------------------- labels
def _anchor_args(config):
    if config == "fixture":
        aa = dict(_params("")["postprocess"]["anchor_args"], W=80, H=40)
    else:
        aa = yaml_utils.load_yaml(config)["postprocess"]["anchor_args"]
    return aa


@pytest.mark.parametrize("config", ["fixture", V2XREAL_M1])
def test_multiclass_anchors_and_labels_bit_exact(root, config):
    aa = _anchor_args(config)
    got = postprocessor.generate_anchor_box_multiclass(aa, "hwl")
    want = jax_post.generate_anchor_box_multiclass(aa, "hwl")
    for g, w in zip(got, want):
        if isinstance(w, list):
            assert g == w
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    anchors, matched, unmatched, _ = got
    rng_ = aa["cav_lidar_range"]
    cases = []
    if config == "fixture":
        s = jax_v2xreal.V2XRealDataset(_params(root), train=False,
                                       max_points=64)[0]
        cases.append((s["gt_boxes"], s["gt_classes"], s["gt_mask"]))
    rng = np.random.RandomState(1)
    for n in (0, 1, 7, 25):
        boxes = np.zeros((30, 7), np.float32)
        boxes[:n, 0] = rng.uniform(rng_[0], rng_[3], n)
        boxes[:n, 1] = rng.uniform(rng_[1], rng_[4], n)
        boxes[:n, 2] = rng.uniform(-2, 0, n)
        boxes[:n, 3:6] = rng.uniform(0.5, 9.0, (n, 3))
        boxes[:n, 6] = rng.uniform(-np.pi, np.pi, n)
        classes = np.zeros(30, np.int32)
        classes[:n] = rng.randint(1, CLASSES + 1, n)
        mask = np.zeros(30, np.float32)
        mask[:n] = 1.0
        cases.append((boxes, classes, mask))
    for boxes, classes, mask in cases:
        g = postprocessor.generate_label_multiclass(
            boxes, classes, mask, anchors, matched, unmatched, "hwl")
        w = jax_post.generate_label_multiclass(
            boxes, classes, mask, anchors, matched, unmatched, "hwl")
        assert_samples_equal(g, w, config)


# ---------------------------------------------------------------- decode
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_and_nms_multiclass_matches_jax(jax_decode, seed):
    aa = _anchor_args("fixture")
    anchors = postprocessor.generate_anchor_box_multiclass(aa, "hwl")[0]
    _, h, w, a, _ = anchors.shape
    rng = np.random.RandomState(seed)
    cls = rng.randn(h, w, a * CLASSES * CLASSES).astype(np.float32) * 2 - 1
    reg = (rng.randn(h, w, a * CLASSES * 7) * 0.3).astype(np.float32)
    tfm = np.eye(4, dtype=np.float32)
    if seed == 2:  # a rotation and a shift into another frame
        c, s = np.cos(0.3), np.sin(0.3)
        tfm[:2, :2] = [[c, -s], [s, c]]
        tfm[:3, 3] = [1.5, -2.0, 0.2]
    kw = dict(score_threshold=0.2, nms_thresh=0.15, topk=512)
    want = jax_decode(jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(anchors),
                      jnp.asarray(tfm), jnp.asarray(LIDAR_RANGE, jnp.float32),
                      **kw)
    got = postprocessor.decode_and_nms_multiclass(
        torch.from_numpy(cls), torch.from_numpy(reg),
        torch.from_numpy(anchors), torch.from_numpy(tfm), tuple(LIDAR_RANGE),
        **kw)
    assert isinstance(got, postprocessor.Detections) and got.labels is not None
    wv, gv = np.asarray(want.valid), got.valid.numpy()
    assert wv.sum() == gv.sum() > 5
    w_sc, g_sc = np.asarray(want.scores)[wv], got.scores.numpy()[gv]
    w_c, g_c = np.asarray(want.corners3d)[wv], got.corners3d.numpy()[gv]
    w_l, g_l = np.asarray(want.labels)[wv], got.labels.numpy()[gv]
    assert set(g_l.tolist()) <= {1, 2, 3}
    # the kept boxes as sets: each of the port's matched to JAX's nearest
    for i in range(len(g_sc)):
        j = int(np.argmin(np.abs(w_c - g_c[i]).reshape(len(w_c), -1).max(1)))
        np.testing.assert_allclose(g_c[i], w_c[j], atol=1e-4)
        assert abs(g_sc[i] - w_sc[j]) <= 1e-6 and g_l[i] == w_l[j]
    np.testing.assert_allclose(np.sort(g_sc), np.sort(w_sc), atol=1e-6)


# ---------------------------------------------------------------- losses
LOSSES = {
    "point_pillar_v2xreal_loss": {"cls": {"weight": 2.0},
                                  "reg": {"weight": 2.0}},
    "point_pillar_v2xreal_gencomm_loss": {"cls_weight": 1.5, "reg": 2.0,
                                          "generate_weight": 0.7},
    "point_pillar_v2xreal_codebook_loss": {},
    "point_pillar_v2xreal_mpda_loss": {"reg": {"weight": 1.0}},
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_v2xreal_losses_and_gradients_match_jax(root, name):
    ds = jax_v2xreal.V2XRealDataset(_params(root), train=False,
                                    max_points=64)
    labels = ds.collate([ds[0], ds[1]])
    b, h, w, ca = labels["pos_equal_one"].shape
    rng = np.random.RandomState(4)
    out = {"cls_preds": rng.randn(b, h, w, ca * CLASSES),
           "reg_preds": rng.randn(b, h, w, ca * 7) * 0.5,
           "pred_feature": rng.randn(b * 3, 4, 8, 16),
           "gt_feature": rng.randn(b * 3, 4, 8, 16),
           "codebook_loss": np.asarray(0.37),
           "da_feature": rng.randn(b, 3, 4, 8, 1)}
    out = {k: np.asarray(v, np.float32) for k, v in out.items()}
    fixed = {"feature_mask": labels["agent_mask"].reshape(-1)}
    target = {k: labels[k] for k in ("pos_equal_one", "targets",
                                     "agent_mask")}
    hypes = {"loss": {"core_method": name,
                      "args": dict(LOSSES[name], num_class=CLASSES)},
             "model": {"core_method": "heter_model_baseline", "args": {}}}
    jcrit = jax_create_loss(hypes)
    want = jcrit({**{k: jnp.asarray(v) for k, v in out.items()},
                  **{k: jnp.asarray(v) for k, v in fixed.items()}},
                 {k: jnp.asarray(v) for k, v in target.items()})
    wgrad = jax.grad(lambda o: jcrit(
        {**o, **{k: jnp.asarray(v) for k, v in fixed.items()}},
        {k: jnp.asarray(v) for k, v in target.items()})["total_loss"])(
        {k: jnp.asarray(v) for k, v in out.items()})
    tout = {k: torch.tensor(v, requires_grad=True) for k, v in out.items()}
    got = create_loss(hypes)(
        {**tout, **{k: torch.from_numpy(v) for k, v in fixed.items()}},
        {k: torch.from_numpy(np.asarray(v)) for k, v in target.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-5, err_msg=k)
    got["total_loss"].backward()
    for k, t in tout.items():
        wg = np.asarray(wgrad[k])
        gg = t.grad.numpy() if t.grad is not None else np.zeros_like(wg)
        scale = max(float(np.abs(wg).max()), 1e-30)
        np.testing.assert_allclose(gg, wg, rtol=0, atol=1e-4 * scale,
                                   err_msg=k)
    assert float(np.abs(np.asarray(wgrad["cls_preds"])).max()) > 0


# ---------------------------------------------------------------- model
def _narrowed_v2xreal(config=V2XREAL_M1, **extra):
    """A narrowed V2X-Real yaml (tests/test_torch_config.py:narrowed) on a
    32 x 16 m range at V2X-Real's heights."""
    raw = narrowed(config, **extra)
    raw["cav_lidar_range"] = list(SMALL_V2XREAL)
    raw["preprocess"]["cav_lidar_range"] = list(SMALL_V2XREAL)
    raw["postprocess"]["gt_range"] = list(SMALL_V2XREAL)
    raw["postprocess"]["anchor_args"]["cav_lidar_range"] = list(SMALL_V2XREAL)
    for m in raw.get("heter", {}).get("modality_setting", {}).values():
        m.setdefault("preprocess", {})["cav_lidar_range"] = list(SMALL_V2XREAL)
    args = raw["model"]["args"]
    args["lidar_range"] = list(SMALL_V2XREAL)
    for c in args.values():
        if isinstance(c, dict) and "encoder_args" in c:
            c["encoder_args"]["lidar_range"] = list(SMALL_V2XREAL)
    return raw


def test_multiclass_heads_widths():
    heads = DetectionHeads(32, anchor_number=2, dir_bins=2, num_class=3)
    x = torch.zeros(1, 4, 8, 32)
    assert [t.shape[-1] for t in heads(x)] == [18, 42, 4]
    assert [t.shape[-1] for t in DetectionHeads(32)(x)] == [2, 14, 4]


def _const_noise(shape):
    """The same diffusion noise for every draw of a shape."""
    return np.random.RandomState(int(np.prod(shape)) % 9973).randn(
        *shape).astype(np.float32)


@pytest.fixture(scope="module")
def slice_run(root, tmp_path_factory):
    """The narrowed V2X-Real GenComm stage-1 model on the fixture through
    both packages: seeded weights carried into the port, one eval frame
    with the same diffusion noise (``jout``, ``tout``); and a port run dir
    of the same weights with the heads' regression zeroed and the class
    biases raised (``v_eval``), so that anchors become boxes and the APs
    are not all 0."""
    tmp = str(tmp_path_factory.mktemp("v2xreal_slice"))
    raw = _narrowed_v2xreal(root_dir=root, validate_dir=root)
    # a looser NMS keeps the anchor grid's neighbours (IoU 0.42 along x),
    # so that a box of each GT's class lies on it
    raw["postprocess"]["nms_thresh"] = 0.5
    jh = jax_yaml.update_yaml(copy.deepcopy(raw))
    ph = yaml_utils.update_yaml(copy.deepcopy(raw))
    jds = jax_train_cli.build_dataset(copy.deepcopy(jh), False, "v2xreal")
    batch = host_decorate_pillars(trim_agent_slots(jds.collate([jds[0]])),
                                  jh)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jax_create_model(jh)
    v = _random_variables(jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        b, train=False), jbatch), seed=0)
    v = jax.tree_util.tree_map(np.asarray, v)
    normal = lambda key, shape, dtype=jnp.float32: jnp.asarray(  # noqa: E731
        _const_noise(tuple(shape))).astype(dtype)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        jout = jax.jit(lambda v, b: jmodel.apply(
            v, b, train=False, rngs={"diffusion": jax.random.PRNGKey(7)}))(
            v, jbatch)
    model = create_model(ph, device="cpu")
    model.load_state_dict(flax_to_state_dict(model, v))
    shape = tuple(np.asarray(jout["pred_feature"]).shape)
    with torch.inference_mode():
        tout = model(batch_to_device(batch, "cpu"),
                     noises=[torch.from_numpy(_const_noise(shape))] * 3)
    v_eval = jax.tree_util.tree_map(np.array, v)
    # the regression scaled down: boxes near their anchors, off the grid
    # (boxes that share an edge to within rounding are ROADMAP fault u)
    v_eval["params"]["heads"]["reg_head"]["kernel"] *= 0.02
    v_eval["params"]["heads"]["reg_head"]["bias"][...] = 0.0
    # and each anchor-class slot's own class the likeliest: the channels
    # are (class of the slot, anchor, class scored)
    bias = v_eval["params"]["heads"]["cls_head"]["bias"].reshape(
        CLASSES, -1, CLASSES)
    for c in range(CLASSES):
        bias[c, :, c] += 2.0
    model.load_state_dict(flax_to_state_dict(model, v_eval))
    run = os.path.join(tmp, "run")
    os.makedirs(run)
    yaml_utils.save_yaml(ph, os.path.join(run, "config.yaml"))
    checkpoint.save_checkpoint(run, model.state_dict(), 1, epoch=1)
    return SimpleNamespace(raw=raw, jh=jh, ph=ph, v_eval=v_eval,
                           jmodel=jmodel, jout=jout, tout=tout, run=run,
                           normal=normal, tmp=tmp)


@pytest.mark.parametrize("key", ["message", "pred_feature", "cls_preds",
                                 "reg_preds", "dir_preds"])
def test_v2xreal_gencomm_slice_matches_jax(slice_run, key):
    want = np.asarray(slice_run.jout[key], np.float32)
    got = slice_run.tout[key].numpy()
    if key == "cls_preds":
        assert got.shape[-1] == 2 * CLASSES * CLASSES
    assert np.abs(want).max() > 0
    _close(got, want, 1e-4, key)


def test_inference_cli_matches_jax_multiclass_eval(slice_run, monkeypatch):
    """The port's inference CLI on the fixture's validation frames against
    JAX's ``_multiclass_eval`` with the same weights and diffusion noise;
    ``--use_cav 1`` through both too. JAX's frames get the host decoration
    that the port's CLI gives its own (JAX's tool voxelizes on the device,
    whose sums in another order part the heads by rounding)."""
    from gencomm_tpu.data import bucketing as jax_bucketing

    monkeypatch.setattr(
        GenCommDiffusion, "draw_noises",
        lambda self, shape, generator, device: [torch.from_numpy(
            _const_noise(tuple(shape))).to(device)] * self.num_timesteps)
    monkeypatch.setattr(jax.random, "normal", slice_run.normal)
    trim = jax_bucketing.trim_agent_slots
    monkeypatch.setattr(jax_bucketing, "trim_agent_slots",
                        lambda host, buckets: host_decorate_pillars(
                            trim(host, buckets=buckets), slice_run.jh))
    jdir = os.path.join(slice_run.tmp, "jax")
    os.makedirs(jdir, exist_ok=True)
    aps = {}
    for use_cav, info in ((0, None), (1, "one_cav")):
        got = inference.main(
            ["--model_dir", slice_run.run, "--dataset", "v2xreal",
             "--frames", "3", "--device", "cpu", "--use_cav", str(use_cav)]
            + (["--infer_info", info] if info else []))
        jh = copy.deepcopy(slice_run.jh)
        args = SimpleNamespace(frames=3, dataset="v2xreal", use_cav=use_cav,
                               infer_info=info, model_dir=jdir)
        jds = jax_train_cli.build_dataset(jh, False, "v2xreal")
        want = jax_inference._multiclass_eval(
            args, jh, jds, slice_run.jmodel, slice_run.v_eval, CLASSES)
        assert set(got) == set(want) and "vehicle_ap30" in got
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6, (use_cav, k, got, want)
        tag = "eval_multiclass" + (f"_{info}" if info else "")
        with open(os.path.join(slice_run.run, f"{tag}.yaml")) as f:
            assert yaml.safe_load(f) == got
        aps[use_cav] = got
    assert aps[0]["vehicle_ap30"] > 0 and aps[0]["truck_ap30"] > 0
    assert aps[0] != aps[1]


def test_fault_u_edge_sharing_boxes_overlap_beyond_one_in_both_packages():
    """ROADMAP fault u: two anchors of a regular grid that share an edge
    (to within rounding) get a rotated IoU far above 1 from the JAX
    package's ``quad_iou_pairwise``, and the port's gives the same values,
    so NMS suppresses a box by its edge neighbour. Boxes decoded on their
    anchors (a zero regression) meet it."""
    from gencomm_tpu.ops.rotated_iou import quad_iou_pairwise as jax_iou
    from gencomm_tpu.utils import box_utils as jax_box
    from gencomm_tpu_torch.ops.rotated_iou import quad_iou_pairwise

    boxes = np.array([[-12.0, -7.2, -1.78, 1.56, 1.6, 3.9, 0.0],
                      [-12.0, -5.6, -1.78, 1.56, 1.6, 3.9, 0.0],
                      [-10.4, -5.6, -1.78, 1.56, 1.6, 3.9, 0.0]], np.float32)
    q = jax_box.boxes_to_corners_3d(boxes, "hwl")[:, :4, :2]
    want = np.asarray(jax_iou(jnp.asarray(q), jnp.asarray(q)))
    got = quad_iou_pairwise(torch.from_numpy(q), torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the true overlaps are 0 (a shared edge) and 0.418 (along x); the
    # faulty one is not even symmetric
    assert want[1, 0] > 1e6 and want[2, 0] > 1.0 and want[0, 1] == 0.0
    assert abs(want[1, 2] - 0.4182) < 1e-3


def test_pipeline_refuses_a_multiclass_model_out_of_intermediate_mode(
        slice_run):
    model = create_model(slice_run.ph, device="cpu")
    pp = slice_run.ph["postprocess"]
    anchors = postprocessor.generate_anchor_box_multiclass(
        pp["anchor_args"])[0]
    with pytest.raises(ValueError, match="multi-class"):
        InferencePipeline(model, anchors[0], pp, device="cpu")
    pipe = InferencePipeline(model, anchors, pp, device="cpu")
    ds = train_cli.build_dataset(copy.deepcopy(slice_run.ph), False,
                                 "v2xreal")
    host = pipe.decorate(trim_agent_slots(ds.collate([ds[0]])))
    frames = {k: np.stack([v, v]) for k, v in host.items()}
    dets = pipe.run_stream(frames, seeds=[3, 3])
    assert isinstance(dets, postprocessor.Detections)
    assert dets.labels.shape == dets.scores.shape == (2, 1, 512)
    assert torch.equal(dets.scores[0], dets.scores[1])


def test_batches_and_one_train_cli_epoch_on_v2xreal(slice_run, tmp_path,
                                                     capsys):
    jds = jax_train_cli.build_dataset(copy.deepcopy(slice_run.jh), True,
                                      "v2xreal")
    pds = train_cli.build_dataset(copy.deepcopy(slice_run.ph), True,
                                  "v2xreal")
    for g, w in zip(train_cli.batches(pds, 2, 1, "v2xreal"),
                    jax_train_cli.batches(jds, 2, 1, "v2xreal")):
        assert_samples_equal(g, w, "batches")
    path = str(tmp_path / "v2xreal_m1_att.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(slice_run.raw, f)
    run = str(tmp_path / "run")
    train_cli.main(["-y", path, "--model_dir", run, "--dataset", "v2xreal",
                    "--epochs", "1", "--steps_per_epoch", "2",
                    "--val_steps", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("[epoch 0][0]"))
    terms = dict(t.split("=") for t in line.split()[2:])
    assert {"cls_loss", "reg_loss", "gen_loss", "total_loss"} <= set(terms)
    assert all(np.isfinite(float(v)) for v in terms.values())
    assert checkpoint.latest_checkpoint(run) is not None
    # the CLI's own rate over the epoch's steps after the first
    assert "[epoch 0] " in out and "ms/step over steps 1-1" in out
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rates = [r["train/ms_per_step"] for r in map(json.loads, f)
                 if "train/ms_per_step" in r]
    assert len(rates) == 1 and rates[0] > 0
