"""The robustness evaluation and late, no and early fusion training of the
port against the JAX package, on the CPU: ``utils/pose_utils.py``, the
sampler's pose noise and delay (bit for bit at five settings, for lidar and
camera modalities), the batch adapters (``ego_only_batch``,
``per_agent_label_batch``, ``merge_points_to_ego``) and the train CLI's
``Adapt`` by fusion mode, ``build_dataset`` threading the hypes' knobs (the
cases of ``tests/test_synthetic_robustness.py`` on the port's sampler),
one late-fusion train step of ``single/m1_pretrain.yaml`` narrowed
(``test_torch_config.narrowed``) against ``jax.grad`` with the same
weights and batch, the train CLI on late and early fusion, and the
inference CLI's robustness sweeps (``inference_w_noise``,
``inference_w_delay``) against the JAX tools on one seeded checkpoint.
"""

import contextlib
import copy
import dataclasses
import io
import os
import sys
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from gencomm_tpu.config import yaml_utils as jax_yaml
from gencomm_tpu.data import bucketing as jax_bucketing
from gencomm_tpu.data.decorate import host_decorate_pillars
from gencomm_tpu.data.early_fusion import merge_points_to_ego as jax_merge
from gencomm_tpu.data.synthetic import SyntheticConfig as JaxConfig
from gencomm_tpu.data.synthetic import SyntheticScenes as JaxScenes
from gencomm_tpu.loss import create_loss as jax_create_loss
from gencomm_tpu.models import create_model as jax_create_model
from gencomm_tpu.tools import inference_w_delay as jax_w_delay
from gencomm_tpu.tools import inference_w_noise as jax_w_noise
from gencomm_tpu.tools import train as jax_train_cli
from gencomm_tpu.train import checkpoint as jax_ckpt
from gencomm_tpu.utils import pose_utils as jax_pose

from gencomm_tpu_torch.data import bucketing
from gencomm_tpu_torch.data.early_fusion import merge_points_to_ego
from gencomm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from gencomm_tpu_torch.loss import create_loss
from gencomm_tpu_torch.models import create_model
from gencomm_tpu_torch.models.encoders import point_pillar
from gencomm_tpu_torch.pipeline import InferencePipeline, batch_to_device
from gencomm_tpu_torch.tools import inference_w_delay, inference_w_noise
from gencomm_tpu_torch.tools import train as train_cli
from gencomm_tpu_torch.train import trainer
from gencomm_tpu_torch.utils import pose_utils
from gencomm_tpu_torch.weights import flax_grads_to_torch, flax_to_state_dict

from tests.test_torch_config import SMALL_RANGE, narrowed
from tests.test_torch_pyramid import hypes_pair
from tests.test_torch_train import _random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import jax_checkpoint_to_torch  # noqa: E402

M1_PRETRAIN = "configs/opv2v/single/m1_pretrain.yaml"
EARLY = "configs/opv2v/point_pillar_early_fusion.yaml"
LATE = "configs/opv2v/point_pillar_late_fusion.yaml"
# (pos_std, rot_std, laplace, delay_ms)
SETTINGS = [(0.0, 0.0, False, 0.0), (0.4, 0.4, False, 0.0),
            (0.6, 0.6, True, 0.0), (0.0, 0.0, False, 200.0),
            (0.2, 0.2, False, 300.0)]
MODALITIES = {"lidar": {"m1": {"sensor": "lidar"}},
              "camera": {"m1": {"sensor": "lidar"},
                         "m2": {"sensor": "camera", "final_dim": (24, 32),
                                "ncam": 2}}}


def _same_batches(got, want):
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


# ---------------------------------------------------------------- pose utils
@pytest.mark.parametrize("seed", [0, 5])
def test_pose_noise_draws_match_jax(seed):
    for fn, args in ((pose_utils.generate_noise, (0.4, 0.3)),
                     (pose_utils.generate_noise_laplace, (0.2, 0.6))):
        jfn = getattr(jax_pose, fn.__name__)
        assert np.array_equal(fn(*args, rng=np.random.RandomState(seed)),
                              jfn(*args, rng=np.random.RandomState(seed)))
    poses = np.random.RandomState(seed).randn(4, 6)
    for pos, rot in ((0.3, 0.5), (0.0, 0.5), (0.3, 0.0)):
        assert np.array_equal(
            pose_utils.generate_noise_von_mises(
                poses, pos, rot, rng=np.random.RandomState(seed)),
            jax_pose.generate_noise_von_mises(
                poses, pos, rot, rng=np.random.RandomState(seed)))
    t = np.random.RandomState(seed).randn(4, 4)
    assert np.array_equal(pose_utils.remove_z_axis(t.copy()),
                          jax_pose.remove_z_axis(t.copy()))


@pytest.mark.parametrize("setting", [
    None, {}, {"add_noise": True}, {"add_pose_noise": True},
    {"add_noise": True, "add_pose_noise": False},
    {"add_noise": True, "add_pose_noise": True,
     "args": {"pos_std": 0.4, "rot_std": 0.2}},
    {"add_noise": True, "add_pose_noise": True,
     "args": {"pos_std": 0.4, "rot_std": 0.2, "laplace": True}}])
def test_add_noise_to_poses_matches_jax(setting):
    assert pose_utils.pose_noise_enabled(setting) == \
        jax_pose.pose_noise_enabled(setting)
    poses = np.random.RandomState(2).randn(3, 6)
    assert np.array_equal(
        pose_utils.add_noise_to_poses(poses, setting,
                                      np.random.RandomState(9)),
        jax_pose.add_noise_to_poses(poses, setting, np.random.RandomState(9)))


# ------------------------------------------------------------- sampler knobs
def _config(cls, modalities, setting, **kw):
    pos, rot, laplace, delay = setting
    return cls(lidar_range=tuple(SMALL_RANGE), max_cav=3, num_agents=3,
               points_per_agent=1500, num_vehicles=4, points_per_vehicle=60,
               comm_range=12.0, modalities=modalities, pos_std=pos,
               rot_std=rot, laplace_noise=laplace, delay_ms=delay, **kw)


@pytest.mark.parametrize("kind", sorted(MODALITIES))
@pytest.mark.parametrize("setting", SETTINGS)
def test_sampler_matches_jax_at_every_robustness_setting(kind, setting):
    """Bit for bit, at a seed past 2**32 too (validation streams reach it)."""
    port = SyntheticScenes(_config(SyntheticConfig, MODALITIES[kind], setting,
                                   per_agent_labels=True))
    ref = JaxScenes(_config(JaxConfig, MODALITIES[kind], setting,
                            per_agent_labels=True))
    for seed in (7, 2 ** 32 + 5):
        _same_batches(port.sample(seed, 2), ref.sample(seed, 2))


def _cfg(**kw):
    return dataclasses.replace(
        SyntheticConfig(num_agents=3, points_per_agent=3000, num_vehicles=4,
                        points_per_vehicle=120), **kw)


def test_pose_noise_only_moves_warp():
    b0 = SyntheticScenes(_cfg()).sample(11)
    b1 = SyntheticScenes(_cfg(pos_std=0.4, rot_std=0.4)).sample(11)
    for k in ("gt_boxes", "points_m1", "pos_equal_one"):
        assert np.array_equal(b0[k], b1[k]), k
    assert not np.allclose(b0["pairwise_t_matrix"], b1["pairwise_t_matrix"])
    # an agent's own-frame transform stays the identity
    for i in range(3):
        np.testing.assert_allclose(b1["pairwise_t_matrix"][0, i, i],
                                   np.eye(4, dtype=np.float32), atol=1e-5)


def test_noise_magnitude_tracks_sigma():
    b0 = SyntheticScenes(_cfg()).sample(5)
    deltas = [np.abs(SyntheticScenes(_cfg(pos_std=s)).sample(5)[
        "pairwise_t_matrix"][0, :, :, :2, 3]
        - b0["pairwise_t_matrix"][0, :, :, :2, 3]).max() for s in (0.1, 0.6)]
    assert deltas[1] > deltas[0] > 0


def test_laplace_differs_from_gaussian():
    g = SyntheticScenes(_cfg(pos_std=0.4)).sample(3)
    lp = SyntheticScenes(_cfg(pos_std=0.4, laplace_noise=True)).sample(3)
    assert not np.allclose(g["pairwise_t_matrix"], lp["pairwise_t_matrix"])


def test_delay_staleness_only_hits_neighbors():
    b0 = SyntheticScenes(_cfg()).sample(11)
    b2 = SyntheticScenes(_cfg(delay_ms=300)).sample(11)
    assert np.array_equal(b0["gt_boxes"], b2["gt_boxes"])
    assert np.array_equal(b0["points_m1"][0, 0], b2["points_m1"][0, 0])
    assert np.allclose(b0["pairwise_t_matrix"], b2["pairwise_t_matrix"])
    assert not np.allclose(b0["points_m1"][0, 1], b2["points_m1"][0, 1])


def _knob_hypes(max_cav=3):
    return {
        "preprocess": {"cav_lidar_range": [-16, -8, -3, 16, 8, 1],
                       "args": {"voxel_size": [0.4, 0.4, 4.0]}},
        "postprocess": {"anchor_args": {"feature_stride": 4}},
        "train_params": {"max_cav": max_cav},
        "model": {"core_method": "point_pillar", "args": {}},
        "noise_setting": {"add_noise": True, "add_pose_noise": True,
                          "args": {"pos_std": 0.3, "rot_std": 0.2,
                                   "laplace": True}},
        "wild_setting": {"async": True, "async_overhead": 200},
    }


def test_build_dataset_threads_noise_and_delay():
    ds = train_cli.build_dataset(_knob_hypes(), False, "synthetic")
    assert (ds.cfg.pos_std, ds.cfg.rot_std, ds.cfg.laplace_noise,
            ds.cfg.delay_ms) == (0.3, 0.2, True, 200.0)
    want = jax_train_cli.build_dataset(_knob_hypes(), False, "synthetic").cfg
    assert dataclasses.asdict(ds.cfg) == dataclasses.asdict(want)
    # the gate: noise needs add_noise and add_pose_noise, delay async
    off = _knob_hypes()
    off["noise_setting"]["add_pose_noise"] = False
    off["wild_setting"]["async"] = False
    ds = train_cli.build_dataset(off, False, "synthetic")
    assert (ds.cfg.pos_std, ds.cfg.rot_std, ds.cfg.delay_ms) == (0, 0, 0)


def test_fault_q_single_agent_yamls_sample_two_agents_into_one_slot():
    """Suspected reference fault q: the JAX CLI's build_dataset leaves the
    sampler at 2 agents where a yaml has ``max_cav: 1`` (13 of the 15 late
    yamls, the single/ pretrain yamls), and sampling then fails; the port
    caps the agents at max_cav and otherwise samples as JAX does."""
    hypes = jax_yaml.load_yaml(os.path.join(REPO, M1_PRETRAIN))
    jds = jax_train_cli.build_dataset(hypes, True, "synthetic")
    assert (jds.cfg.num_agents, jds.cfg.max_cav) == (2, 1)
    with pytest.raises(IndexError):
        jds.sample(0, 1)
    ds = train_cli.build_dataset(hypes, True, "synthetic")
    assert ds.cfg.num_agents == 1
    small = dict(points_per_agent=2000, num_vehicles=4)
    ref = JaxScenes(dataclasses.replace(jds.cfg, num_agents=1, **small))
    port = SyntheticScenes(dataclasses.replace(ds.cfg, **small))
    _same_batches(port.sample(3, 2), ref.sample(3, 2))


# ------------------------------------------------------------ batch adapters
@pytest.fixture(scope="module")
def sampled():
    cfg = dict(lidar_range=tuple(SMALL_RANGE), max_cav=5, num_agents=3,
               points_per_agent=1500, num_vehicles=4, points_per_vehicle=60,
               comm_range=12.0, per_agent_labels=True)
    return SyntheticScenes(SyntheticConfig(**cfg)).sample(4, 2)


def test_ego_only_and_per_agent_label_batches_match_jax(sampled):
    _same_batches(bucketing.ego_only_batch(sampled),
                  jax_bucketing.ego_only_batch(sampled))
    _same_batches(bucketing.per_agent_label_batch(sampled),
                  jax_bucketing.per_agent_label_batch(sampled))
    got = bucketing.per_agent_label_batch(sampled)
    assert got["pos_equal_one"].shape[0] == 10  # 2 samples x 5 slots
    plain = {k: v for k, v in sampled.items() if "_single" not in k}
    _same_batches(bucketing.per_agent_label_batch(plain),
                  jax_bucketing.ego_only_batch(plain))


@pytest.mark.parametrize("lidar_range", [None, [-12, -6, -2.5, 12, 6, 0.5]])
def test_merge_points_to_ego_matches_jax(sampled, lidar_range):
    got = merge_points_to_ego(sampled, lidar_range)
    _same_batches(got, jax_merge(sampled, lidar_range))
    assert got["points_m1"].shape == (2, 1, 5 * 1500, 4)
    # the clouds of the 3 agents, each in the ego frame
    assert got["point_mask_m1"].sum() > 2 * 1500


@pytest.mark.parametrize("config,mode", [(EARLY, "early"), (LATE, "ego"),
                                         (M1_PRETRAIN, "ego"),
                                         ("configs/opv2v/gencomm/stage1/"
                                          "m1_att.yaml", "trim")])
def test_adapt_by_fusion_mode_matches_jax(sampled, config, mode):
    """The train CLI's adaptation of a batch: the JAX CLI's per fusion mode
    (merge, ego slot or agent-slot trimming), then the pillar decoration."""
    raw = narrowed(config)
    jh, ph = hypes_pair(raw)
    adapt = train_cli.Adapt(ph)
    assert adapt.mode == mode
    batch = {k: v for k, v in sampled.items()
             if not k.endswith("_single")}
    jaxed = {"early": lambda b: jax_merge(b, jh["preprocess"][
        "cav_lidar_range"]), "ego": jax_bucketing.ego_only_batch,
        "trim": jax_bucketing.trim_agent_slots}[mode](batch)
    _same_batches(adapt(batch), host_decorate_pillars(jaxed, jh))


def test_fault_r_early_fusion_keeps_every_slots_single_labels(sampled):
    """Suspected reference fault r: both point_pillar_early_fusion.yaml set
    supervise_single, and the JAX CLI's early adaptation (merge_points_to_
    ego) keeps every slot's per-agent labels beside one merged agent's
    heads, so JAX's "_single" loss pass fails to broadcast. The port's
    Adapt keeps the ego slot's, which label the merged ego."""
    raw = narrowed(EARLY)
    jh, ph = hypes_pair(raw)
    assert jh["model"]["args"]["supervise_single"]
    jbatch = {k: jnp.asarray(v) for k, v in host_decorate_pillars(
        jax_merge(sampled, jh["preprocess"]["cav_lidar_range"]), jh).items()}
    jmodel, crit = jax_create_model(jh), jax_create_loss(jh)

    def single_loss(b):
        v = jmodel.init({"params": jax.random.PRNGKey(0)}, b, train=False)
        return crit(jmodel.apply(v, b, train=False), b, suffix="_single")

    with pytest.raises(TypeError, match="broadcast"):
        jax.eval_shape(single_loss, jbatch)
    got = train_cli.Adapt(ph)(sampled)
    assert got["pos_equal_one_single"].shape[1] == 1
    assert np.array_equal(got["pos_equal_one_single"][:, 0],
                          sampled["pos_equal_one_single"][:, 0])


# ----------------------------------------------------- one late-fusion step
def narrowed_single():
    raw = narrowed(M1_PRETRAIN)
    raw["train_params"].update(batch_size=2, max_cav=1)
    return raw


@pytest.fixture(scope="module")
def late_step():
    """One train step of narrowed single/m1_pretrain.yaml (late fusion,
    supervise_single) in both packages on the train CLI's batch (the ego
    slot, per-agent labels, decorated) with the same weights."""
    raw = narrowed_single()
    jh, ph = hypes_pair(raw)
    ds = train_cli.build_dataset(ph, True, "synthetic")
    host = train_cli.Adapt(ph)(next(train_cli.batches(ds, 2, 0,
                                                      "synthetic")))
    assert host["agent_mask"].shape == (2, 1)
    jbatch = {k: jnp.asarray(v) for k, v in host.items()}
    jmodel = jax_create_model(jh)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, b, train=False), jbatch)
    variables = _random_variables(shapes, seed=3)
    criterion = jax_create_loss(jh)

    def loss_fn(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jbatch, train=True, mutable=["batch_stats"],
            rngs={"diffusion": jax.random.PRNGKey(0),
                  "dropout": jax.random.PRNGKey(1)})
        losses = criterion(out, jbatch)
        single = criterion(out, jbatch, suffix="_single")
        losses = dict(losses, **{(k if k not in losses else f"{k}_single"): v
                                 for k, v in single.items()
                                 if k != "total_loss"})
        losses["total_loss"] = losses["total_loss"] + single["total_loss"]
        return losses["total_loss"], losses

    grads, jlosses = jax.jit(jax.grad(loss_fn, has_aux=True))(
        variables["params"])
    model = create_model(ph, device="cpu")
    model.load_state_dict(flax_to_state_dict(model, variables))
    opt, sched = trainer.make_optimizer(ph, model.named_parameters(), 1)
    step = trainer.make_train_step(model, create_loss(ph), opt, sched,
                                   supervise_single=True)
    tbatch = batch_to_device(host, "cpu")
    losses = step(tbatch)
    # the gradients again with the JAX encoder's canvas values (the bf16
    # canvas may round one ulp apart where the PFN sums differ)
    jcanvas = []
    real_canvas = point_pillar.pillar_canvas
    enc_vars = {c: variables[c]["branch_m1"]["encoder"]
                for c in ("params", "batch_stats")}
    from gencomm_tpu.models.encoders.point_pillar import PointPillarEncoder

    enc_args = jh["model"]["args"]["m1"]["encoder_args"]
    jenc = PointPillarEncoder(
        voxel_size=tuple(enc_args["voxel_size"]),
        lidar_range=tuple(enc_args["lidar_range"]),
        num_filters=tuple(enc_args["pillar_vfe"]["num_filters"]))
    jc, _ = jenc.apply(enc_vars, None, None, True,
                       decorated=jbatch["decorated_m1"],
                       gids=jbatch["gids_m1"], dvalid=jbatch["dvalid_m1"],
                       mutable=["batch_stats"])
    jcanvas.append(torch.from_numpy(np.array(jc.astype(jnp.float32))))

    def jax_valued_canvas(*args):
        out = real_canvas(*args)
        return out + (jcanvas[0].to(out.dtype).reshape(out.shape)
                      - out).detach()

    same = create_model(ph, device="cpu")
    same.load_state_dict(flax_to_state_dict(same, variables))
    same_step = trainer.make_train_step(
        same, create_loss(ph), *trainer.make_optimizer(
            ph, same.named_parameters(), 1), supervise_single=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(point_pillar, "pillar_canvas", jax_valued_canvas)
        same_step(tbatch)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return SimpleNamespace(losses=losses, model=model, same=same,
                           jlosses={k: float(v) for k, v in jlosses.items()},
                           jgrads=flax_grads_to_torch(model, to_np(grads)))


def test_late_step_losses_match_jax(late_step):
    assert set(late_step.losses) == set(late_step.jlosses)
    assert "total_loss_single" not in late_step.losses
    for k, want in late_step.jlosses.items():
        np.testing.assert_allclose(float(late_step.losses[k]), want,
                                   rtol=1e-4, err_msg=k)


def test_late_step_gradients_match_jax(late_step):
    """Every gradient within 1e-3 of its tensor's largest entry (the
    gradients of the step taken on the JAX encoder's bf16 canvas values,
    which may round one ulp apart from the port's)."""
    worst = []
    for name, p in late_step.same.named_parameters():
        want = late_step.jgrads[name].numpy()
        scale = float(np.abs(want).max())
        assert scale > 0, name
        worst.append((float(np.abs(p.grad.numpy() - want).max()) / scale,
                      name))
    assert max(worst)[0] <= 1e-3, max(worst)


@pytest.mark.parametrize("config", [M1_PRETRAIN, EARLY])
def test_train_cli_trains_late_and_early_fusion(tmp_path, config):
    raw = narrowed_single() if config == M1_PRETRAIN else narrowed(config)
    y = tmp_path / "h.yaml"
    y.write_text(yaml.safe_dump(raw))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_cli.main(["-y", str(y), "--dataset", "synthetic", "--device",
                        "cpu", "--model_dir", str(tmp_path / "run"),
                        "--epochs", "1", "--steps_per_epoch", "2",
                        "--val_steps", "1"])
    text = out.getvalue()
    assert "[epoch 0][0] " in text and "val loss" in text
    assert "nan" not in text.lower()


# ------------------------------------------------- the robustness sweeps
@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """``inference_w_noise`` (levels 0 and 0.4, and 0.4 Laplace) and
    ``inference_w_delay`` (0 and 200 ms) of both packages over the same
    frames, on one seeded checkpoint of narrowed point_pillar_late_fusion.
    yaml (attentive fusion of 2 agents, no diffusion noise, so that the two
    packages' detections may be compared; the tools evaluate it as they
    evaluate every config) written by the JAX package and carried across by
    ``scripts/jax_checkpoint_to_torch.py``; the heads' weights zeroed and
    the class biases raised, so that every box sits on its anchor with its
    type's score and some match the GT: the packages' bf16 pillar canvases
    may round one ulp apart (ROADMAP section 3), which moves feature-made
    scores by ~1e-3 and may reorder near-tied boxes, so the APs are held on
    boxes that no feature moves. The frames' pairwise transforms the port's
    tool saw are recorded: the noise must reach the model."""
    from flax.traverse_util import flatten_dict
    from gencomm_tpu.train import trainer as jax_trainer

    root = tmp_path_factory.mktemp("sweeps")
    jh, _ = hypes_pair(narrowed(LATE))
    jmodel = jax_create_model(jh)
    first = jax_train_cli.build_dataset(jh, False, "synthetic").sample(0, 1)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, b, train=False), first)
    v = jax.tree_util.tree_map(np.array, _random_variables(shapes, 4))
    for head in ("reg_head", "cls_head"):
        v["params"]["heads"][head]["kernel"][...] = 0.0
    v["params"]["heads"]["reg_head"]["bias"][...] = 0.0
    v["params"]["heads"]["cls_head"]["bias"] += 2.0
    r = SimpleNamespace(jdir=str(root / "jax"), pdir=str(root / "port"),
                        thetas=[])
    real_run = InferencePipeline.run

    def recorded_run(self, host, *a, **kw):
        r.thetas.append(np.array(host["pairwise_t_matrix"]))
        return real_run(self, host, *a, **kw)

    os.makedirs(r.jdir)
    jax_yaml.save_yaml(jh, os.path.join(r.jdir, "config.yaml"))
    jax_ckpt.save_checkpoint(r.jdir, SimpleNamespace(
        params=v["params"], batch_stats=v["batch_stats"], step=0), step=1)
    jax_checkpoint_to_torch.convert(r.jdir, r.pdir)
    init_dir = str(root / "init")
    os.makedirs(init_dir)
    tool_hypes = jax_yaml.load_yaml(None, r.jdir)
    key = jax_trainer._init_cache_key(
        jax_create_model(tool_hypes),
        jax_train_cli.build_dataset(tool_hypes, False, "synthetic").sample(
            0, 1), jax.random.PRNGKey(0), False)
    np.savez(os.path.join(init_dir, f"init_{key}.npz"), **{
        "//".join((col,) + k): a for col, tree in v.items()
        for k, a in flatten_dict(tree).items()})
    argv = ["--dataset", "synthetic", "--frames", "2"]
    runs = (("noise", jax_w_noise, inference_w_noise, ["--levels", "0,0.4"]),
            ("laplace", jax_w_noise, inference_w_noise,
             ["--levels", "0.4", "--laplace"]),
            ("delay", jax_w_delay, inference_w_delay, ["--delays", "0,200"]))
    r.want, r.got = {}, {}
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(io.StringIO()):
        # the JAX tool's process-wide settings stay out of the test worker
        import gencomm_tpu

        mp.setattr(gencomm_tpu, "enable_persistent_cache", lambda: None)
        mp.setattr(gencomm_tpu, "enable_fast_prng", lambda: None)
        mp.setattr(jax_trainer, "_INIT_CACHE_DIR", init_dir)
        mp.setattr(InferencePipeline, "run", recorded_run)
        for name, jtool, tool, extra in runs:
            r.want[name] = jtool.main(["--model_dir", r.jdir] + argv + extra)
            r.got[name] = tool.main(["--model_dir", r.pdir, "--device",
                                     "cpu"] + argv + extra)
    return r


def _aps(run_dir, tag):
    with open(os.path.join(run_dir, f"{tag}.yaml")) as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("info", ["noise_0.0", "noise_0.4",
                                  "noise_0.4_laplace", "delay_0ms",
                                  "delay_200ms"])
def test_sweep_aps_match_the_jax_tools(sweeps, info):
    """Per frame the APs agree within 1e-6; sorted over all frames,
    detections whose scores differ in the last bits may swap ranks across
    frames, which moves the global-sort APs by up to 1e-3."""
    for tag, tol in ((f"eval_{info}", 1e-6), (f"eval_global_sort_{info}",
                                                1e-3)):
        w, g = _aps(sweeps.jdir, tag), _aps(sweeps.pdir, tag)
        assert set(g) == set(w)
        for k in w:
            assert abs(g[k] - w[k]) <= tol, (tag, k, g, w)
    assert _aps(sweeps.pdir, "eval_noise_0.0")["ap30"] > 0


def test_sweeps_return_each_level_and_the_noise_reaches_the_model(sweeps):
    assert sorted(sweeps.got["noise"]) == [0.0, 0.4]
    assert sorted(sweeps.got["delay"]) == [0, 200]
    assert sweeps.got["noise"][0.0] == sweeps.got["delay"][0]
    # 2 frames a level: noise 0 and 0.4, Laplace 0.4, delay 0 and 200
    clean, noisy, laplace, delay0, delay = (
        sweeps.thetas[i:i + 2] for i in range(0, 10, 2))
    for a, b in zip(clean, delay0 + delay):
        assert np.array_equal(a, b)
    for a, b, c in zip(clean, noisy, laplace):
        assert not np.allclose(a, b) and not np.allclose(b, c)
