"""The port's real-data lidar loaders against the JAX package's, on the CPU:
``utils/pcd_utils.py``, ``utils/heter_utils.py``, ``data/augmentor.py``
and ``data/opv2v.py`` (OPV2V, OPV2V-H and V2XSet share its format).

- ``pcd_utils`` on ascii and binary ``.pcd`` files (with and without an
  intensity field) and on KITTI ``.bin`` files with NaN rows, the masks and
  the seeded shuffle, bit for bit;
- the ``Adaptor`` (eval reordering, train draws, the 32 / 16-channel swap,
  ``from_hypes``) and ``assign_modality``;
- ``DataAugmentor``'s draws and transforms;
- ``OPV2VDataset`` on the fixture tree of ``tests/test_opv2v_loader.py``
  (its writer copied here): every key of every sample and of ``collate``
  equal to the JAX loader's, in training and eval, plain and with delay
  ('sim', 'random', 'real'), pose noise (Gaussian, Laplace), the
  communication range, late and early fusion augmentation, per-agent labels
  and STAMP's per-modality labels with an assignment file;
- camera modalities and camera labels, ``dairv2x`` and ``v2xsim`` raise
  naming ROADMAP item 20;
- the train CLI's ``batches`` over a dataset against the JAX CLI's, and
  one train-CLI epoch and the inference CLI on the fixture for
  ``--dataset opv2v`` and ``v2xset`` (narrowed ``stage1/m1_att``).

The torch side runs on one thread (``one_torch_thread``).
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
import yaml

from gencomm_tpu.data import augmentor as jax_augmentor
from gencomm_tpu.data.opv2v import OPV2VDataset as JaxOPV2V
from gencomm_tpu.tools import train as jax_train_cli
from gencomm_tpu.utils import heter_utils as jax_heter
from gencomm_tpu.utils import pcd_utils as jax_pcd

from gencomm_tpu_torch.config import yaml_utils
from gencomm_tpu_torch.data import augmentor
from gencomm_tpu_torch.data.opv2v import OPV2VDataset
from gencomm_tpu_torch.tools import inference
from gencomm_tpu_torch.tools import train as train_cli
from gencomm_tpu_torch.train import checkpoint
from gencomm_tpu_torch.utils import heter_utils, pcd_utils
from gencomm_tpu_torch.utils.transformation_utils import x_to_world

from tests.test_torch_config import narrowed

LIDAR_RANGE = [-16, -8, -3, 16, 8, 1]
M1_ATT = "configs/opv2v/gencomm/stage1/m1_att.yaml"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one thread: the suite runs several workers on the
    machine's cores, where small operators split over every core wait on
    one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_mock_opv2v(root, n_scenarios=1, n_cavs=2, n_ts=3, seed=0):
    """The writer of tests/test_opv2v_loader.py: per scenario two CAVs, one
    vehicle in front of the ego, and per CAV and timestamp 500 points on
    the vehicle's surface in the CAV's lidar frame (ascii .pcd)."""
    rng = np.random.RandomState(seed)
    for s in range(n_scenarios):
        sc = os.path.join(root, f"scenario_{s:02d}")
        cav_poses = [[0.0, 0, 1.9, 0, 0, 0], [8.0, 2, 1.9, 0, 30, 0]][:n_cavs]
        veh = {100: {"location": [6.0, 0.5, 0.0], "angle": [0.0, 15.0, 0.0],
                     "center": [0.0, 0.0, 0.75],
                     "extent": [2.2, 0.95, 0.75]}}
        for c, pose in enumerate(cav_poses):
            cav_dir = os.path.join(sc, str(200 + c))
            os.makedirs(cav_dir, exist_ok=True)
            for t in range(n_ts):
                ts = f"{t:06d}"
                params = {"lidar_pose": [float(x) for x in pose],
                          "true_ego_pos": [float(x) for x in pose],
                          "vehicles": veh}
                with open(os.path.join(cav_dir, f"{ts}.yaml"), "w") as f:
                    yaml.dump(params, f)
                world_pts = np.array(veh[100]["location"]) + rng.uniform(
                    -1.5, 1.5, (500, 3)) * np.array([1.0, 0.5, 0.3]) \
                    + np.array([0, 0, 0.75])
                hom = np.concatenate([world_pts, np.ones((500, 1))], 1)
                local = (hom @ np.linalg.inv(x_to_world(pose)).T)[:, :3]
                pts = np.concatenate([local, rng.uniform(0, 1, (500, 1))],
                                     1).astype(np.float32)
                pcd_utils.write_pcd(os.path.join(cav_dir, f"{ts}.pcd"), pts)


PARAMS = {
    "root_dir": None,
    "validate_dir": None,
    "train_params": {"max_cav": 3},
    "comm_range": 70,
    "preprocess": {"cav_lidar_range": LIDAR_RANGE},
    "postprocess": {
        "max_num": 10,
        "order": "hwl",
        "anchor_args": {
            "W": 80, "H": 40, "l": 3.9, "w": 1.6, "h": 1.56,
            "r": [0, 90], "vw": 0.4, "vh": 0.4,
            "cav_lidar_range": LIDAR_RANGE, "feature_stride": 4,
        },
        "target_args": {"pos_threshold": 0.6, "neg_threshold": 0.45},
    },
}
AUGMENT = [{"NAME": "random_world_flip"},
           {"NAME": "random_world_rotation",
            "WORLD_ROT_ANGLE": [-0.78539816, 0.78539816]},
           {"NAME": "random_world_scaling", "WORLD_SCALE_RANGE": [0.95, 1.05]}]


@pytest.fixture(scope="module")
def mock_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("opv2v"))
    _write_mock_opv2v(root, n_scenarios=2)
    with open(os.path.join(root, "assign.json"), "w") as f:
        json.dump({"scenario_00": {"200": "m1", "201": "m3"},
                   "scenario_01": {"200": "m3", "201": "m1"}}, f)
    return root


def _stamp(root):
    """Heter settings in STAMP's style: m1 and m3 pillar lidars at
    different ranges, each with its own postprocess block, and a fixed
    assignment (tests/test_opv2v_loader.py:_stamp_params)."""
    m3_range = [-8.0, -4.0, -3.0, 8.0, 4.0, 1.0]
    tgt = {"pos_threshold": 0.6, "neg_threshold": 0.45}
    return {"heter": {
        "ego_modality": "m1",
        "assignment_path": os.path.join(root, "assign.json"),
        "mapping_dict": {"m1": "m1", "m3": "m3"},
        "modality_setting": {
            "m1": {"sensor_type": "lidar",
                   "preprocess": {"cav_lidar_range": list(LIDAR_RANGE)},
                   "postprocess": {"anchor_args": dict(
                       PARAMS["postprocess"]["anchor_args"]),
                       "target_args": tgt}},
            "m3": {"sensor_type": "lidar",
                   "preprocess": {"cav_lidar_range": m3_range},
                   "postprocess": {"anchor_args": {
                       "W": 40, "H": 20, "l": 3.9, "w": 1.6, "h": 1.56,
                       "r": [0, 90], "vw": 0.4, "vh": 0.4,
                       "cav_lidar_range": m3_range, "feature_stride": 4},
                       "target_args": tgt}}}}}


SETTINGS = {
    "plain": {},
    "delay_sim": {"wild_setting": {"async": True, "async_overhead": 100}},
    "delay_random": {"wild_setting": {"async": True, "async_overhead": 250,
                                      "async_method": "random"}},
    "delay_real": {"noise_setting": {
        "add_noise": True, "add_async_noise": True,
        "async_args": {"async_mode": "real", "async_overhead": 200,
                       "data_size": 1.06, "transmission_speed": 27,
                       "backbone_delay": 20}}},
    "pose_noise": {"noise_setting": {
        "add_noise": True, "add_pose_noise": True,
        "args": {"pos_std": 0.5, "rot_std": 2.0}}},
    "pose_noise_laplace": {"noise_setting": {
        "add_noise": True, "add_pose_noise": True,
        "args": {"pos_std": 0.3, "rot_std": 1.0, "laplace": True}}},
    "comm_range": {"comm_range": 5},
    "late_aug": {"fusion": {"core_method": "latefusion"},
                 "data_augment": AUGMENT},
    "late_aug_single": {"fusion": {"core_method": "latefusion"},
                        "data_augment": AUGMENT,
                        "model": {"core_method": "point_pillar",
                                  "args": {"supervise_single": True}}},
    "early_aug": {"fusion": {"core_method": "early"},
                  "data_augment": AUGMENT},
    "second_per_agent": {"model": {"core_method": "second", "args": {}}},
    "stamp": "stamp",
}


def _params(root, setting):
    extra = _stamp(root) if setting == "stamp" else SETTINGS[setting]
    return dict(copy.deepcopy(PARAMS), root_dir=root, validate_dir=root,
                **copy.deepcopy(extra))


def assert_samples_equal(got: dict, want: dict, where=""):
    assert set(got) == set(want), (where, set(got) ^ set(want))
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (where, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{where} {k}")


# ---------------------------------------------------------------- pcd
def _write_binary_pcd(path, pts, fields):
    n = len(pts)
    header = (f"# a comment\nVERSION 0.7\nFIELDS {' '.join(fields)}\n"
              f"SIZE {' '.join(['4'] * len(fields))}\n"
              f"TYPE {' '.join(['F'] * len(fields))}\n"
              f"COUNT {' '.join(['1'] * len(fields))}\n"
              f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
              f"POINTS {n}\nDATA binary\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(np.ascontiguousarray(pts[:, :len(fields)],
                                     np.float32).tobytes())


@pytest.mark.parametrize("kind", ["ascii", "binary", "binary_xyz", "bin"])
def test_pcd_readers_match_jax(tmp_path, kind):
    rng = np.random.RandomState(3)
    pts = rng.uniform(-20, 20, (700, 4)).astype(np.float32)
    pts[5, 1] = np.nan
    pts[9, 3] = np.inf
    path = str(tmp_path / f"cloud.{'bin' if kind == 'bin' else 'pcd'}")
    if kind == "ascii":
        pcd_utils.write_pcd(path, pts)
        jax_pcd.write_pcd(str(tmp_path / "jax.pcd"), pts)
        assert open(path).read() == open(str(tmp_path / "jax.pcd")).read()
    elif kind == "bin":
        pts.tofile(path)
    else:
        _write_binary_pcd(path, pts, ["x", "y", "z"] + (
            ["intensity"] if kind == "binary" else []))
    if kind == "bin":
        for zero in (False, True):
            got = pcd_utils.load_lidar_bin(path, zero_intensity=zero)
            want = jax_pcd.load_lidar_bin(path, zero_intensity=zero)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    else:
        got, want = pcd_utils.read_pcd(path), jax_pcd.read_pcd(path)
        assert got.dtype == want.dtype == np.float32 and len(got) < 700
        np.testing.assert_array_equal(got, want)


def test_point_masks_and_shuffle_match_jax():
    rng = np.random.RandomState(4)
    pts = rng.uniform(-5, 5, (900, 4)).astype(np.float32)
    for fn, args in ((pcd_utils.mask_points_by_range, (LIDAR_RANGE,)),
                     (pcd_utils.mask_ego_points, ())):
        want = getattr(jax_pcd, fn.__name__)(pts, *args)
        np.testing.assert_array_equal(fn(pts, *args), want)
    np.testing.assert_array_equal(
        pcd_utils.shuffle_points(pts, np.random.RandomState(9)),
        jax_pcd.shuffle_points(pts, np.random.RandomState(9)))


# ---------------------------------------------------------------- heter
def test_adaptor_matches_jax(mock_root, tmp_path):
    hypes = _stamp(mock_root)
    hypes["heter"]["lidar_channels_dict"] = {"m1": 32, "m3": 16.0}
    hypes["heter"]["cav_preference"] = {"m1": 0.3, "m3": 0.7}
    hypes["heter"]["ego_modality"] = "m1&m3"
    for train in (False, True):
        got = heter_utils.Adaptor.from_hypes(hypes, train)
        want = jax_heter.Adaptor.from_hypes(hypes, train)
        assert got.modality_assignment == want.modality_assignment
        for sc in ("scenario_00", "scenario_01", "missing"):
            for cavs in (["200", "201"], ["201", "200"], []):
                assert got.reorder_cav_list(cavs, sc) == \
                    want.reorder_cav_list(cavs, sc)
        for i in range(12):
            assert got.reassign_cav_modality("m3", i % 3) == \
                want.reassign_cav_modality("m3", i % 3)
        for m in ("m1", "m3", "m2"):
            p = "/data/OPV2V/train/a/200/000000.pcd"
            assert got.switch_lidar_channels(m, p) == \
                want.switch_lidar_channels(m, p)
            assert got.unmatched_modality(m) == want.unmatched_modality(m)
    assert heter_utils.Adaptor.from_hypes({}, True) is None
    # the offline assignment over a tree of splits
    tree = str(tmp_path / "tree")
    for split in ("train", "validate"):
        _write_mock_opv2v(os.path.join(tree, split), n_ts=1)
    got = heter_utils.assign_modality(tree, str(tmp_path / "p.json"))
    want = jax_heter.assign_modality(tree, str(tmp_path / "j.json"))
    assert got == want
    assert open(tmp_path / "p.json").read() == open(tmp_path / "j.json").read()


# ---------------------------------------------------------------- augmentor
def test_augmentor_matches_jax():
    rng = np.random.RandomState(5)
    pts = rng.uniform(-10, 10, (300, 4)).astype(np.float32)
    boxes = rng.uniform(-5, 5, (6, 7)).astype(np.float32)
    for train in (True, False):
        got = augmentor.DataAugmentor(AUGMENT, train, seed=11)
        want = jax_augmentor.DataAugmentor(AUGMENT, train, seed=11)
        for _ in range(6):
            for g, w in zip(got.transform(pts, boxes),
                            want.transform(pts, boxes)):
                np.testing.assert_array_equal(g, w)
    with pytest.raises(KeyError, match="unknown augmentation"):
        augmentor.DataAugmentor([{"NAME": "random_world_shear"}])


# ---------------------------------------------------------------- loader
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_opv2v_samples_match_jax(mock_root, setting, train):
    """Every sample and ``collate`` of the port's loader equal to the JAX
    loader's (one RandomState stream: the samples are read in order), and
    again after ``reinitialize``."""
    got_ds = OPV2VDataset(_params(mock_root, setting), train=train,
                          max_points=2048)
    want_ds = JaxOPV2V(_params(mock_root, setting), train=train,
                       max_points=2048)
    assert len(got_ds) == len(want_ds) == 6
    for rnd in range(2):
        got = [got_ds[i] for i in range(len(got_ds))]
        want = [want_ds[i] for i in range(len(want_ds))]
        for i, (g, w) in enumerate(zip(got, want)):
            assert_samples_equal(g, w, f"{setting} round {rnd} sample {i}")
        assert_samples_equal(got_ds.collate(got[:3]), want_ds.collate(want[:3]),
                             f"{setting} collate")
        got_ds.reinitialize()
        want_ds.reinitialize()
        assert list(got_ds.scenario_database) == list(
            want_ds.scenario_database)
    s = got[0]
    assert s["points_m1"].shape == (3, 2048, 4) and s["gt_mask"].sum() == 1
    if setting == "comm_range":
        assert s["agent_mask"].tolist() == [True, False, False]
    if setting == "stamp":
        assert s["pos_equal_one_single_m3"].shape == (3, 5, 10, 2)
    if setting in ("late_aug_single", "second_per_agent"):
        assert s["pos_equal_one_single"].shape == (3, 10, 20, 2)


def test_camera_modalities_and_labels_raise_naming_item_20(mock_root):
    params = _params(mock_root, "stamp")
    params["heter"]["modality_setting"]["m2"] = {
        "sensor_type": "camera", "data_aug_conf": {"final_dim": [32, 64]}}
    with pytest.raises(NotImplementedError, match="ROADMAP item 20"):
        OPV2VDataset(params, train=False)
    params = dict(_params(mock_root, "plain"), label_type="camera")
    with pytest.raises(NotImplementedError, match="ROADMAP item 20"):
        OPV2VDataset(params, train=True)
    hypes = yaml_utils.load_yaml(M1_ATT)
    for name in ("dairv2x", "v2xsim"):
        with pytest.raises(NotImplementedError, match="ROADMAP item 20"):
            train_cli.build_dataset(hypes, True, name)


# ---------------------------------------------------------------- CLIs
def _fixture_yaml(tmp_path, root):
    """Narrowed stage1/m1_att on the fixture tree."""
    raw = narrowed(M1_ATT, root_dir=root, validate_dir=root)
    path = str(tmp_path / "m1_att_fixture.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def test_batches_over_a_dataset_match_the_jax_cli(mock_root, tmp_path):
    """``batches`` of both CLIs over the loader of the same yaml: the
    seeded permutation, the collated samples, the partial batch dropped."""
    from gencomm_tpu.config import yaml_utils as jax_yaml

    path = _fixture_yaml(tmp_path, mock_root)
    pds = train_cli.build_dataset(yaml_utils.load_yaml(path), True, "opv2v")
    jds = jax_train_cli.build_dataset(jax_yaml.load_yaml(path), True, "opv2v")
    assert isinstance(pds, OPV2VDataset)
    for seed, bs in ((0, 1), (3, 4), (2 ** 32 + 5, 2)):
        got = list(train_cli.batches(pds, bs, seed, "opv2v"))
        want = list(jax_train_cli.batches(jds, bs, seed, "opv2v"))
        assert len(got) == len(want) == 6 // bs
        for g, w in zip(got, want):
            assert_samples_equal(g, w, f"seed {seed}")


@pytest.mark.parametrize("dataset", ["opv2v", "v2xset"])
def test_train_and_inference_clis_on_the_fixture(mock_root, tmp_path, dataset,
                                                 capsys):
    path = _fixture_yaml(tmp_path, mock_root)
    run = str(tmp_path / "run")
    train_cli.main(["-y", path, "--model_dir", run, "--dataset", dataset,
                    "--epochs", "1", "--steps_per_epoch", "2",
                    "--val_steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[epoch 0][0] " in out and "val loss" in out
    assert checkpoint.latest_checkpoint(run) is not None
    res = inference.main(["--model_dir", run, "--dataset", dataset,
                          "--frames", "10", "--device", "cpu"])
    assert set(res) >= {"ap30", "ap50", "ap70"}
    assert os.path.exists(os.path.join(run, "eval.yaml"))


def test_worker_processes_over_a_loader_give_each_workers_stream(mock_root,
                                                                tmp_path):
    """``--workers``: each worker process runs its own pass over the loader
    (seed ``epoch * 100 + worker``, from the loader's state when the epoch
    began), as the JAX CLI's workers do; the stream ends when every worker's
    pass has."""
    import functools

    from gencomm_tpu_torch.data.prefetch import multi_worker_iter

    hypes = yaml_utils.load_yaml(_fixture_yaml(tmp_path, mock_root))
    ds = train_cli.build_dataset(hypes, True, "opv2v")
    adapt = train_cli.Adapt(hypes)
    want = [adapt(b) for w in (0, 1) for b in train_cli.batches(
        copy.deepcopy(ds), 2, 3 * 100 + w, "opv2v")]
    it = multi_worker_iter(functools.partial(
        train_cli.epoch_batches, ds, 2, "opv2v", adapt, 3), 2)
    got = list(it)
    assert len(got) == len(want) == 6
    for g in got:
        assert any(set(g) == set(w) and all(np.array_equal(g[k], w[k])
                                            for k in w) for w in want)
