"""The port's serving path against the JAX package, on the CPU.

AP accounting (``utils/eval_utils.py``) against the JAX copy on random
detection and GT sets; the JAX package's own decode and AP tests through the
port's decode; the rotated NMS (the plain version of kernel N1) against
JAX's ``rotated_nms`` on random box sets and on a suppression chain as deep
as the set; the per-agent heads (``supervise_single``), the ``late`` and
``no`` inference modes and ``evaluate`` against
``gencomm_tpu.pipeline.InferencePipeline`` on ``tests/test_late_fusion.py``'s
tiny model with the weights carried over; ``run_stream`` on the CPU against
looped ``run``; and the port's bench flagship against ``bench.py``'s, by
parameter names and shapes (``jax.eval_shape``, no full-width forward).
"""

import dataclasses
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gencomm_tpu
from gencomm_tpu.models.heter_baseline import HeterModel as JaxHeterModel
from gencomm_tpu.ops.nms import rotated_nms as jax_rotated_nms
from gencomm_tpu.pipeline import InferencePipeline as JaxPipeline
from gencomm_tpu.utils import box_utils as jax_box_utils
from gencomm_tpu.utils import eval_utils as jax_eval

from gencomm_tpu_torch import bench as torch_bench
from gencomm_tpu_torch.data.bucketing import trim_agent_slots
from gencomm_tpu_torch.data.decorate import decorate_modality
from gencomm_tpu_torch.data.postprocessor import (
    decode_and_nms, generate_anchor_box, generate_label,
)
from gencomm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from gencomm_tpu_torch.models.heter_baseline import HeterModel
from gencomm_tpu_torch.native import PillarVoxelizer
from gencomm_tpu_torch.ops.nms import (
    nms_closure_plain, overlap_matrix, rotated_nms,
)
from gencomm_tpu_torch.pipeline import InferencePipeline, batch_to_device
from gencomm_tpu_torch.utils import box_utils, eval_utils
from gencomm_tpu_torch.weights import (
    flax_to_state_dict, load_flax_variables, random_state_dict,
)

# tests/test_late_fusion.py's tiny model (test_model_forward.TINY and
# MODALITY_ARGS), built with supervise_single and without the diffusion
TINY = SyntheticConfig(lidar_range=(-16.0, -8.0, -3.0, 16.0, 8.0, 1.0),
                       max_cav=3, num_agents=2, points_per_agent=2048,
                       num_vehicles=3, points_per_vehicle=200, comm_range=10.0)
VOXEL = (0.4, 0.4, 4.0)
MODALITY_ARGS = {"m1": {
    "encoder_args": {"voxel_size": list(VOXEL),
                     "lidar_range": list(TINY.lidar_range),
                     "pillar_vfe": {"use_norm": True, "num_filters": [32]}},
    "backbone_args": {"layer_nums": [2, 2], "layer_strides": [2, 2],
                      "num_filters": [32, 64], "upsample_strides": [1, 2],
                      "num_upsample_filter": [32, 32]},
    "shrink_header": {"kernal_size": [3], "stride": [2], "padding": [1],
                      "dim": [64], "input_dim": 64},
}}
POSTPROCESS = {"gt_range": list(TINY.lidar_range),
               "target_args": {"score_threshold": 0.05}, "nms_thresh": 0.15,
               "dir_args": {"dir_offset": 0.7853, "num_bins": 2},
               "nms_topk": 64}
# tests/test_postprocess_eval.py's anchor grid
ANCHOR_ARGS = {"W": 80, "H": 40, "l": 3.9, "w": 1.6, "h": 1.56, "r": [0, 90],
               "vw": 0.4, "vh": 0.4, "cav_lidar_range": [-16, -8, -3, 16, 8, 1],
               "feature_stride": 4}


def _boxes(rng, n, extent=20.0):
    """n random (x, y, z, h, w, l, yaw) boxes of car size, 'hwl' order."""
    return np.stack([rng.uniform(-extent, extent, n),
                     rng.uniform(-extent / 2, extent / 2, n),
                     rng.uniform(-1.5, -0.5, n), rng.uniform(1.4, 1.7, n),
                     rng.uniform(1.5, 2.0, n), rng.uniform(3.5, 4.5, n),
                     rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)


def _detections(seed):
    """Random detections and GT for one frame: some detections jittered
    copies of GT boxes (so that they match at several IoUs), some spurious,
    tied scores included."""
    rng = np.random.RandomState(seed)
    gt = _boxes(rng, 1 + seed % 5)
    near = gt[rng.randint(0, len(gt), 6)].copy()
    near[:, :2] += rng.normal(0, 0.4, (6, 2))
    near[:, 6] += rng.normal(0, 0.15, 6)
    det = np.concatenate([near, _boxes(rng, 4)])
    scores = rng.uniform(0.1, 1.0, len(det)).round(2)
    return (jax_box_utils.boxes_to_corners_3d(det, "hwl"), scores,
            jax_box_utils.boxes_to_corners_3d(gt, "hwl"))


def test_eval_utils_copy_names_every_function():
    public = {n for n in dir(jax_eval) if not n.startswith("__")
              and callable(getattr(jax_eval, n))}
    assert public <= set(dir(eval_utils))


@pytest.mark.parametrize("thresholds", [(0.3, 0.5, 0.7), (0.1, 0.5)])
def test_eval_utils_match_jax(thresholds):
    mine, theirs = (eval_utils.new_result_stat(thresholds),
                    jax_eval.new_result_stat(thresholds))
    for seed in range(6):
        corners, scores, gt = _detections(seed)
        # the first detection against every GT quad: the polygon IoU
        assert np.array_equal(eval_utils.polygon_iou(corners[0, :4, :2],
                                                     gt[:, :4, :2]),
                              jax_eval.polygon_iou(corners[0, :4, :2],
                                                   gt[:, :4, :2]))
        for t in thresholds:
            eval_utils.calculate_tp_fp(corners, scores, gt, mine, t)
            jax_eval.calculate_tp_fp(corners, scores, gt, theirs, t)
    # no detections at all in one more frame: only the GT count moves
    for t in thresholds:
        eval_utils.calculate_tp_fp(None, None, gt, mine, t)
        jax_eval.calculate_tp_fp(None, None, gt, theirs, t)
    assert mine == theirs
    assert sum(mine[thresholds[0]]["tp"]) > 0, "some detections should match"
    for glob in (False, True):
        for t in thresholds:
            assert eval_utils.calculate_ap(mine, t, glob) == \
                jax_eval.calculate_ap(theirs, t, glob)
    if thresholds == (0.3, 0.5, 0.7):
        for glob in (False, True):
            assert eval_utils.eval_final_results(mine, glob) == \
                jax_eval.eval_final_results(theirs, glob)
    rec = sorted(np.random.RandomState(9).uniform(0, 1, 8).tolist())
    prec = np.random.RandomState(10).uniform(0, 1, 8).tolist()
    assert eval_utils.voc_ap(rec, prec) == jax_eval.voc_ap(rec, prec)


def test_eval_utils_multiclass_match_jax():
    names = ("car", "truck")
    mine, theirs = (eval_utils.new_multiclass_stat(names),
                    jax_eval.new_multiclass_stat(names))
    for i, cls in enumerate(names):
        for seed in range(3):
            corners, scores, gt = _detections(10 * i + seed)
            for t in (0.3, 0.5, 0.7):
                eval_utils.calculate_tp_fp(corners, scores, gt, mine[cls], t)
                jax_eval.calculate_tp_fp(corners, scores, gt, theirs[cls], t)
    for glob in (False, True):
        assert eval_utils.eval_multiclass_results(mine, glob) == \
            jax_eval.eval_multiclass_results(theirs, glob)


def test_decode_and_nms_perfect_predictions():
    # tests/test_postprocess_eval.py's test through the port's decode
    anchors_np = generate_anchor_box(ANCHOR_ARGS)
    gt = np.zeros((150, 7), np.float32)
    gt[0] = [2.0, 1.0, -1.0, 1.56, 1.6, 3.9, 0.0]
    gt[1] = [-5.0, -2.0, -1.0, 1.56, 1.6, 3.9, np.pi / 2]
    mask = np.zeros(150, np.float32)
    mask[:2] = 1
    label = generate_label(gt, mask, anchors_np, 0.6, 0.45)
    hp, wp, a = anchors_np.shape[:3]
    cls_logits = np.where(label["pos_equal_one"] > 0, 8.0, -8.0).astype(
        np.float32)
    dirp = np.zeros((hp, wp, a * 2), np.float32)
    dirp[..., 0::2] = 5.0
    dets = decode_and_nms(
        torch.from_numpy(cls_logits),
        torch.from_numpy(label["targets"].astype(np.float32)),
        torch.from_numpy(dirp), torch.from_numpy(anchors_np), torch.eye(4),
        tuple(ANCHOR_ARGS["cav_lidar_range"]), topk=64)
    kept = dets.valid.numpy()
    corners = dets.corners3d.numpy()[kept]
    scores = dets.scores.numpy()[kept]
    assert corners.shape[0] == 2

    stat = eval_utils.new_result_stat()
    gt_corners = box_utils.boxes_to_corners_3d(gt[:2], "hwl")
    for t in (0.3, 0.5, 0.7):
        eval_utils.calculate_tp_fp(corners, scores, gt_corners, stat, t)
    res = eval_utils.eval_final_results(stat)
    assert res["ap50"] > 0.99 and res["ap70"] > 0.99


def test_eval_ap_with_false_positive():
    # tests/test_postprocess_eval.py's test on the port's copies
    stat = eval_utils.new_result_stat()
    gt = box_utils.boxes_to_corners_3d(
        np.array([[0, 0, 0, 1.5, 1.6, 3.9, 0.0]]), "hwl")
    det = box_utils.boxes_to_corners_3d(
        np.array([[0, 0, 0, 1.5, 1.6, 3.9, 0.0],
                  [20, 5, 0, 1.5, 1.6, 3.9, 0.3]]), "hwl")
    eval_utils.calculate_tp_fp(det, np.array([0.9, 0.95]), gt, stat, 0.5)
    ap = eval_utils.calculate_ap(stat, 0.5, global_sort_detections=False)
    assert 0.4 < ap < 0.75


def _chain(k):
    """k unit-width boxes along x, 0.6 m apart, scores falling along the
    line: each overlaps its neighbours only (IoU 0.25 > 0.15), so greedy NMS
    keeps every other box and the round-parallel closure needs k / 2
    rounds."""
    boxes = np.zeros((k, 7), np.float32)
    boxes[:, 0] = 0.6 * np.arange(k) - 0.3 * k
    boxes[:, 3:6] = (1.5, 1.0, 1.0)
    corners = box_utils.boxes_to_corners_3d(boxes, "hwl")[:, :4, :2]
    scores = np.linspace(0.9, 0.3, k).astype(np.float32)
    return corners, scores, np.ones(k, bool)


def _random_set(seed, k):
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, k, extent=8.0)
    corners = box_utils.boxes_to_corners_3d(boxes, "hwl")[:, :4, :2]
    return (corners, rng.uniform(0, 1, k).astype(np.float32),
            rng.uniform(0, 1, k) > 0.2)


@pytest.mark.parametrize("case", ["random64", "random200", "chain128"])
def test_rotated_nms_matches_jax(case):
    """The port's rotated NMS on the CPU (kernel N1's plain version) keeps
    the boxes JAX's on-device while_loop keeps, in the same order."""
    if case.startswith("chain"):
        corners, scores, valid = _chain(int(case[5:]))
    else:
        corners, scores, valid = _random_set(int(case[6:]), int(case[6:]))
    order, keep = rotated_nms(torch.from_numpy(corners),
                              torch.from_numpy(scores),
                              torch.from_numpy(valid), 0.15)
    jorder, jkeep = jax_rotated_nms(jnp.asarray(corners), jnp.asarray(scores),
                                    jnp.asarray(valid), 0.15)
    assert np.array_equal(order.numpy(), np.asarray(jorder))
    assert np.array_equal(keep.numpy(), np.asarray(jkeep))
    if case.startswith("chain"):
        assert np.array_equal(keep.numpy(), np.arange(len(scores)) % 2 == 0)
    else:
        assert 0 < int(keep.sum()) < int(valid.sum())


def test_nms_closure_plain_is_sequential_greedy():
    """The round-parallel closure against greedy NMS written as a loop over
    the sorted boxes, on random overlap matrices of several densities."""
    rng = np.random.RandomState(3)
    for k, density in ((1, 0.5), (40, 0.02), (97, 0.1), (150, 0.4)):
        over = np.triu(rng.uniform(0, 1, (k, k)) < density, 1)
        valid = rng.uniform(0, 1, k) > 0.1
        want = np.zeros(k, bool)
        for i in range(k):
            want[i] = valid[i] and not (over[:i, i] & want[:i]).any()
        got = nms_closure_plain(torch.from_numpy(over), torch.from_numpy(valid))
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [4097, 5120])
def test_nms_closure_plain_is_sequential_greedy_past_4096(k):
    """The round-parallel closure against greedy NMS as a loop over the
    sorted boxes at K past kernel N1's old 4,096-box limit, on banded random
    overlap matrices (a few overlaps a box)."""
    from tests.test_torch_kernels import banded_nms_case

    over, valid = banded_nms_case(k, seed=k)
    o, v = over.numpy(), valid.numpy()
    band = 48
    want = np.zeros(k, bool)
    for i in range(k):
        lo = max(0, i - band)
        want[i] = v[i] and not (o[lo:i, i] & want[lo:i]).any()
    got = nms_closure_plain(over, valid)
    assert np.array_equal(got.numpy(), want)
    assert 0 < int(want.sum()) < int(v.sum())


def test_overlap_matrix_is_upper_triangular():
    corners, _, _ = _random_set(5, 60)
    over = overlap_matrix(torch.from_numpy(corners), 0.15).numpy()
    assert over.dtype == np.bool_ and over.any()
    assert not np.tril(over).any()


@pytest.fixture(scope="module")
def tiny():
    """test_late_fusion.py's model (supervise_single, no diffusion) in both
    packages with the same perturbed weights, on one decorated frame."""
    scenes = SyntheticScenes(TINY)
    voxelizer = PillarVoxelizer(TINY.lidar_range, VOXEL)
    batch = decorate_modality(scenes.sample(seed=21, batch_size=1), voxelizer)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JaxHeterModel(modality_args=MODALITY_ARGS, fusion_method="att",
                           fusion_args={"att": {"feat_dim": 64}},
                           lidar_range=TINY.lidar_range, anchor_number=2,
                           in_head=64, supervise_single=True)
    variables = jmodel.init({"params": jax.random.PRNGKey(0)}, jbatch,
                            train=False)
    rng = np.random.RandomState(1)
    variables = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.05 * rng.randn(*v.shape).astype(
            np.float32), variables)
    model = HeterModel(modality_args=MODALITY_ARGS, fusion_method="att",
                       lidar_range=TINY.lidar_range, anchor_number=2,
                       supervise_single=True, device="cpu")
    load_flax_variables(model, variables)
    return dict(scenes=scenes, voxelizer=voxelizer, batch=batch, jbatch=jbatch,
                jmodel=jmodel, variables=variables, model=model)


@pytest.mark.parametrize("key", ["cls_preds_single", "reg_preds_single",
                                 "dir_preds_single", "cls_preds"])
def test_single_heads_match_jax(tiny, key):
    want = np.asarray(tiny["jmodel"].apply(tiny["variables"], tiny["jbatch"],
                                           train=False)[key])
    with torch.inference_mode():
        got = tiny["model"](batch_to_device(tiny["batch"], "cpu"))[key].numpy()
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    # fp32 both sides, sums in other orders (test_torch_pipeline's bound)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_heads_single_carried_by_name(tiny):
    sd = flax_to_state_dict(tiny["model"], tiny["variables"])
    single = sorted(k for k in sd if k.startswith("heads_single."))
    assert single == sorted(f"heads_single.{h}.{p}" for h in (
        "cls_head", "reg_head", "dir_head") for p in ("weight", "bias"))


@pytest.fixture(scope="module")
def pipelines(tiny):
    """One JAX and one port pipeline per mode, the same weights."""
    return {mode: (JaxPipeline(tiny["jmodel"], tiny["variables"],
                               tiny["scenes"].anchors, POSTPROCESS, mode=mode),
                   InferencePipeline(tiny["model"], tiny["scenes"].anchors,
                                     POSTPROCESS, mode=mode, device="cpu"))
            for mode in ("late", "no")}


@pytest.mark.parametrize("mode", ["late", "no"])
def test_modes_match_jax(tiny, pipelines, mode):
    jpipe, pipe = pipelines[mode]
    want = jpipe.run(tiny["jbatch"], seed=0)
    got = pipe.run(tiny["batch"], seed=0)
    assert got.corners3d.shape == tuple(want.corners3d.shape)
    if mode == "late":
        # the union of both agents' boxes: L x per-agent K candidates
        l = tiny["batch"]["agent_mask"].shape[1]
        assert got.scores.shape[1] == min(POSTPROCESS["nms_topk"],
                                          l * POSTPROCESS["nms_topk"])
    wv, gv = np.asarray(want.valid[0]), got.valid[0].numpy()
    assert wv.sum() > 0, "the frame should give detections"
    assert gv.sum() == wv.sum()
    # test_torch_pipeline.py::test_detections_match_jax's tolerances
    np.testing.assert_allclose(got.scores[0].numpy()[gv],
                               np.asarray(want.scores[0])[wv], atol=1e-4)
    np.testing.assert_allclose(got.corners3d[0].numpy()[gv],
                               np.asarray(want.corners3d[0])[wv], atol=1e-3)


def test_late_mode_drops_absent_agents(tiny, pipelines):
    """With agent 1 masked out, late fusion keeps the ego's boxes only:
    every kept box is one of the no-fusion mode's."""
    _, late = pipelines["late"]
    _, ego = pipelines["no"]
    batch = dict(tiny["batch"])
    batch["agent_mask"] = batch["agent_mask"] * np.array([[1, 0, 0]],
                                                         batch["agent_mask"].dtype)
    got, want = late.run(batch), ego.run(batch)
    assert int(got.valid.sum()) == int(want.valid.sum()) > 0
    np.testing.assert_array_equal(got.scores[got.valid].numpy(),
                                  want.scores[want.valid].numpy())


class _DecoratedScenes:
    """The scenes with every sample decorated on the host, so that JAX's
    evaluate runs on the inputs the port's evaluate decorates itself."""

    def __init__(self, scenes, voxelizer):
        self.scenes, self.voxelizer = scenes, voxelizer

    def sample(self, seed, batch_size):
        return decorate_modality(self.scenes.sample(seed, batch_size),
                                 self.voxelizer)

    def gt_corners(self, batch, b):
        return self.scenes.gt_corners(batch, b)


def test_evaluate_matches_jax(tiny):
    """AP of the late mode over 4 frames, JAX's evaluate against the port's.
    The regression heads are zeroed (every box is its anchor, car-sized)
    and the class biases raised, so that some boxes match GT at IoU 0.3 and
    the comparison is not one of zeros."""
    variables = jax.tree_util.tree_map(np.array, tiny["variables"])
    for h in ("heads", "heads_single"):
        variables["params"][h]["reg_head"]["kernel"][...] = 0.0
        variables["params"][h]["reg_head"]["bias"][...] = 0.0
        variables["params"][h]["cls_head"]["bias"] += 1.0
    model = HeterModel(modality_args=MODALITY_ARGS, fusion_method="att",
                       lidar_range=TINY.lidar_range, anchor_number=2,
                       supervise_single=True, device="cpu")
    load_flax_variables(model, variables)
    jpipe = JaxPipeline(tiny["jmodel"], variables, tiny["scenes"].anchors,
                        POSTPROCESS, mode="late")
    pipe = InferencePipeline(model, tiny["scenes"].anchors, POSTPROCESS,
                             mode="late", device="cpu")
    want = jpipe.evaluate(_DecoratedScenes(tiny["scenes"], tiny["voxelizer"]),
                          n_frames=4, seed0=21)
    got = pipe.evaluate(tiny["scenes"], n_frames=4, seed0=21)
    assert set(got) == {"ap30", "ap50", "ap70"}
    assert got["ap30"] > 0
    for key in got:
        assert abs(got[key] - want[key]) <= 1e-6, (key, got, want)


def test_pipeline_refuses_unknown_modes(tiny):
    with pytest.raises(ValueError, match="unknown mode"):
        InferencePipeline(tiny["model"], tiny["scenes"].anchors, POSTPROCESS,
                          mode="early", device="cpu")
    plain = HeterModel(modality_args=MODALITY_ARGS, fusion_method="att",
                       lidar_range=TINY.lidar_range, device="cpu")
    with pytest.raises(ValueError, match="supervise_single"):
        InferencePipeline(plain, tiny["scenes"].anchors, POSTPROCESS,
                          mode="late", device="cpu")


def test_run_stream_equals_looped_run_on_the_cpu():
    """run_stream over three different frames (one agent bucket) against
    run frame by frame: the same seeds give the same diffusion noise, so
    the detections are equal bit for bit."""
    lr = TINY.lidar_range
    scenes = SyntheticScenes(TINY)
    voxelizer = PillarVoxelizer(lr, VOXEL)
    model = HeterModel(modality_args=MODALITY_ARGS, fusion_method="att",
                       lidar_range=lr, anchor_number=2, use_gencomm=True,
                       use_enhancer=True, device="cpu")
    model.load_state_dict(random_state_dict(model, seed=0))
    pipe = InferencePipeline(model, scenes.anchors, POSTPROCESS, device="cpu")
    frames = [decorate_modality(trim_agent_slots(scenes.sample(s, 1)),
                                voxelizer) for s in (3, 4, 5)]
    assert len({f["agent_mask"].shape for f in frames}) == 1
    seeds = [11, 12, 13]
    stacked = {k: np.stack([f[k] for f in frames]) for k in frames[0]
               if not k.startswith(("points_", "point_mask_"))}
    got = pipe.run_stream(stacked, seeds)
    assert got.scores.shape[:2] == (3, 1)
    for f, (frame, s) in enumerate(zip(frames, seeds)):
        want = pipe.run(frame, seed=s)
        for a, b in zip(got, want):
            assert torch.equal(a[f], b)
    # another seed draws other noise
    other = pipe.run(frames[0], seed=99)
    assert not torch.equal(other.scores, got.scores[0])


def test_flagship_matches_bench_py(monkeypatch):
    """The port's bench flagship has bench.py's parameters, by name and
    shape (flax's init traced with jax.eval_shape: nothing runs)."""
    monkeypatch.setattr(gencomm_tpu, "enable_persistent_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr(gencomm_tpu, "enable_fast_prng", lambda *a, **k: None)
    jax_bench = importlib.import_module("bench")
    scenes, jmodel, cfg = jax_bench.build_flagship(half=True, striped=False)
    _, model, tcfg = torch_bench.build_flagship(half=True, device="cpu")
    # the port's sampler has no pose noise or delay (bench.py leaves them 0)
    want = dataclasses.asdict(cfg)
    assert dataclasses.asdict(tcfg) == {k: want[k] for k in
                                        dataclasses.asdict(tcfg)}
    assert model.bf16
    np.testing.assert_array_equal(SyntheticScenes(tcfg).anchors,
                                  scenes.anchors)
    p, l = cfg.points_per_agent, 2
    shapes = {"agent_mask": ((1, l), jnp.float32),
              "pairwise_t_matrix": ((1, l, l, 4, 4), jnp.float32),
              "modality_mask_m1": ((1, l), jnp.float32),
              "decorated_m1": ((1, l, p, 10), jnp.float32),
              "gids_m1": ((1, l, p), jnp.int32),
              "dvalid_m1": ((1, l, p), jnp.bool_)}
    batch = {k: jax.ShapeDtypeStruct(s, d) for k, (s, d) in shapes.items()}
    abstract = jax.eval_shape(
        lambda b: jmodel.init({"params": jax.random.PRNGKey(0),
                               "diffusion": jax.random.PRNGKey(1)}, b,
                              train=False), batch)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   abstract)
    # raises on a flax variable without a counterpart, a missing key or a
    # shape that differs
    sd = flax_to_state_dict(model, zeros)
    assert set(sd) == set(model.state_dict())


def test_bench_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_bench.main([])
