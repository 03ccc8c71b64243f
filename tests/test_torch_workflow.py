"""The port's GenComm two-stage workflow against the JAX package, on the
CPU: checkpoints, the stage-1 merge, freezing and the stage-2 step, the
train, heal_tools and inference command lines.

Models are narrowed copies of the GenComm yamls (``test_torch_config.
narrowed``); weights are seeded (``test_torch_train._random_variables``)
and carried across by ``weights.py`` or by ``scripts/
jax_checkpoint_to_torch.py``. The command lines run with ``--device cpu``.
The inference CLI's APs are held against the JAX package's
``eval_final_results`` on the same detections (the port's, recorded), and
its first frame's detections against the JAX pipeline's on the same frame
with the same injected diffusion noise.
"""

import copy
import functools
import json
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml
from flax.traverse_util import flatten_dict

from gencomm_tpu.config import yaml_utils as jax_yaml
from gencomm_tpu.data import bucketing as jax_bucketing
from gencomm_tpu.data.decorate import host_decorate_pillars
from gencomm_tpu.data.postprocessor import generate_anchor_box as jax_anchors
from gencomm_tpu.loss import create_loss as jax_create_loss
from gencomm_tpu.models import create_model as jax_create_model
from gencomm_tpu.tools import heal_tools as jax_heal
from gencomm_tpu.tools import train as jax_train_cli
from gencomm_tpu.train import checkpoint as jax_ckpt
from gencomm_tpu.train import trainer as jax_trainer
from gencomm_tpu.utils import eval_utils as jax_eval

from gencomm_tpu_torch.data.bucketing import trim_agent_slots
from gencomm_tpu_torch.data.prefetch import multi_worker_iter
from gencomm_tpu_torch.loss import create_loss
from gencomm_tpu_torch.models import create_model
from gencomm_tpu_torch.pipeline import InferencePipeline, batch_to_device
from gencomm_tpu_torch.tools import heal_tools, inference
from gencomm_tpu_torch.tools import inference_heter_in_order
from gencomm_tpu_torch.tools import train as train_cli
from gencomm_tpu_torch.train import checkpoint, trainer
from gencomm_tpu_torch.train.metrics import MetricsLogger
from gencomm_tpu_torch import weights
from gencomm_tpu_torch.weights import flax_to_state_dict

from tests.test_torch_config import GENCOMM, _shape_batch, narrowed
from tests.test_torch_kernels import _close
from tests.test_torch_train import _random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import jax_checkpoint_to_torch  # noqa: E402

M1, M2, M1M2 = GENCOMM[0], GENCOMM[1], GENCOMM[3]


def _hypes(config):
    """(raw narrowed dict, JAX-derived hypes, port-derived hypes)."""
    from gencomm_tpu_torch.config import yaml_utils

    raw = narrowed(config)
    return (raw, jax_yaml.update_yaml(copy.deepcopy(raw)),
            yaml_utils.update_yaml(copy.deepcopy(raw)))


def _variables(hypes, seed):
    jmodel = jax_create_model(hypes)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        b, train=False), _shape_batch(hypes, points=500))
    return _random_variables(shapes, seed)


def _jax_run_dir(root, name, hypes, variables, epoch, step):
    """A run dir of the JAX package: config.yaml and step_<epoch>."""
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    jax_yaml.save_yaml(hypes, os.path.join(d, "config.yaml"))
    jax_ckpt.save_checkpoint(d, SimpleNamespace(
        params=variables["params"], batch_stats=variables["batch_stats"],
        step=step), step=epoch)
    return d


def _to_torch(models, col, path, value):
    """A flax leaf as (torch key, array) on the first of ``models`` that has
    its module."""
    mod_path = ".".join(path[:-1])
    for m in models:
        mods = dict(m.named_modules())
        if mod_path in mods:
            name, arr = weights._convert(mods[mod_path], col, path[-1],
                                         np.asarray(value, np.float32))
            return f"{mod_path}.{name}", arr
    raise KeyError(path)


def _jax_as_torch(models, tree):
    """JAX ``{params, batch_stats}`` (any subset of leaves) as torch keys."""
    out = {}
    for col in ("params", "batch_stats"):
        for path, v in flatten_dict(tree.get(col, {})).items():
            k, arr = _to_torch(models, col, path, v)
            out[k] = arr
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Stage-1 checkpoints of the narrowed m1_att (lidar) and m2_att
    (camera) written by the JAX package and carried across by the script;
    the port's models of both and of m1m2_att, on the CPU."""
    root = str(tmp_path_factory.mktemp("runs"))
    r = SimpleNamespace(root=root)
    for tag, config, seed, epoch in (("m1", M1, 0, 2), ("m2", M2, 1, 1)):
        raw, jh, ph = _hypes(config)
        v = _variables(jh, seed)
        jdir = _jax_run_dir(root, f"jax_{tag}", jh, v, epoch, step=12 * epoch)
        pdir = os.path.join(root, f"port_{tag}")
        jax_checkpoint_to_torch.convert(jdir, pdir)
        setattr(r, tag, SimpleNamespace(raw=raw, jh=jh, ph=ph, v=v,
                                        jdir=jdir, pdir=pdir,
                                        model=create_model(ph, device="cpu")))
    raw, jh, ph = _hypes(M1M2)
    r.m1m2 = SimpleNamespace(raw=raw, jh=jh, ph=ph,
                             model=create_model(ph, device="cpu"))
    return r


def _load_port(path):
    return checkpoint.load_checkpoint(
        checkpoint.latest_checkpoint(path) or path)


# ---------------------------------------------------------------- hygiene
def test_new_modules_import_without_jax():
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'flax', 'orbax', 'optax'): sys.modules[m] = None\n"
        "for n in ('registry', 'config.yaml_utils', 'train.checkpoint', "
        "'train.metrics', 'data.prefetch', 'tools.train', "
        "'tools.heal_tools', 'tools.inference', "
        "'tools.inference_heter_in_order', 'tools.inference_w_noise', "
        "'tools.inference_w_delay', 'tools.pose_graph', 'models.coalign', "
        "'utils.pose_utils', 'data.early_fusion', 'utils.misc_utils', "
        "'models', "
        "'loss', 'models.fuse.fusion', 'models.fuse.v2xvit', "
        "'models.fuse.cobevt', 'models.fuse.where2comm', "
        "'models.fuse.v2vnet', 'train.trainer'):\n"
        "    importlib.import_module('gencomm_tpu_torch.' + n)\n"
        "assert not any(k == 'gencomm_tpu' or k.startswith('gencomm_tpu.') "
        "for k in sys.modules), 'the JAX package was imported'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_command_lines_need_a_device_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y = tmp_path / "m1.yaml"
    y.write_text(yaml.safe_dump(narrowed(M1)))
    for call in (
            lambda: train_cli.main(["-y", str(y), "--dataset", "synthetic"]),
            lambda: heal_tools.main(["best", "--model_dir", str(tmp_path)]),
            lambda: inference.main(["--model_dir", str(tmp_path),
                                    "--dataset", "synthetic"]),
            lambda: inference_heter_in_order.main([
                "--model_dir", str(tmp_path), "--dataset", "synthetic"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_unported_flags_and_cores_raise(runs, tmp_path):
    y = tmp_path / "m1.yaml"
    y.write_text(yaml.safe_dump(runs.m1.raw))
    base = ["-y", str(y), "--dataset", "synthetic", "--device", "cpu",
            "--model_dir", str(tmp_path / "run")]
    for extra, item in ((["--trainer", "gmatch"], 16),
                        (["--no_host_decorate"], 18), (["--half"], None)):
        with pytest.raises(NotImplementedError) as exc:
            train_cli.main(base + extra)
        assert item is None or f"item {item}" in str(exc.value)
    # distillation is ported (tests/test_torch_fusion.py); as the JAX CLI,
    # it needs a teacher
    with pytest.raises(SystemExit, match="teacher_ckpt"):
        train_cli.main(base + ["--trainer", "kd"])
    with pytest.raises(NotImplementedError, match="item 20"):
        train_cli.main(base[:2] + ["--dataset", "opv2v", "--device", "cpu",
                                   "--model_dir", str(tmp_path / "run")])
    with pytest.raises(NotImplementedError, match="item 21"):
        inference.main(["--model_dir", runs.m1.pdir, "--dataset",
                        "synthetic", "--device", "cpu",
                        "--save_vis_interval", "2"])
    # pose noise and delay are ported (tests/test_torch_robustness.py)
    for tag, extra in (("noise", ["--pos_std", "0.2"]),
                       ("delay", ["--delay", "100"])):
        aps = inference.main(["--model_dir", runs.m1.pdir, "--dataset",
                              "synthetic", "--device", "cpu", "--frames", "1",
                              "--infer_info", tag] + extra)
        assert set(aps) == {"ap30", "ap50", "ap70"}
        assert os.path.exists(os.path.join(runs.m1.pdir, f"eval_{tag}.yaml"))
    # STAMP's merge-final and BackAlign's freeze are ported
    # (tests/test_torch_baselines.py): the merge of one run is its newest
    # checkpoint
    merged = heal_tools.main(["--device", "cpu", "merge-final", "--ckpts",
                              runs.m1.pdir, "--out", str(tmp_path / "mf")])
    own = checkpoint.load_checkpoint(checkpoint.latest_checkpoint(
        runs.m1.pdir))["state_dict"]
    got = checkpoint.load_checkpoint(merged)["state_dict"]
    assert set(got) == set(own) and all(torch.equal(got[k], own[k])
                                        for k in own)
    assert trainer.backalign_frozen_modules(runs.m1.ph) == [
        "fusion_net", "heads", "branch_m1"]
    # late-fusion training takes the ego slot (tests/test_torch_robustness.py)
    late = copy.deepcopy(runs.m1.ph)
    late["fusion"] = {"core_method": "late"}
    assert train_cli.Adapt(late).mode == "ego"
    # supervise_single's per-agent labels are ported
    # (tests/test_torch_pyramid.py), and so is pose noise
    noisy = copy.deepcopy(runs.m1.ph)
    noisy["noise_setting"] = {"add_noise": True, "add_pose_noise": True,
                              "args": {"pos_std": 0.2, "rot_std": 0.1}}
    ds = train_cli.build_dataset(noisy, True, "synthetic")
    assert (ds.cfg.pos_std, ds.cfg.rot_std) == (0.2, 0.1)
    multi = copy.deepcopy(runs.m1.ph)
    multi["model"]["args"]["num_class"] = 3
    with pytest.raises(NotImplementedError, match="item 19"):
        create_model(multi, device="cpu")


# ---------------------------------------------------------------- checkpoints
def test_jax_checkpoint_carried_across_bit_for_bit(runs):
    for r in (runs.m1, runs.m2):
        want = flax_to_state_dict(r.model, r.v)
        ck = _load_port(r.pdir)
        assert ck["step"] == int(jax_ckpt.load_checkpoint(
            jax_ckpt.latest_checkpoint(r.jdir))["step"])
        assert os.path.basename(checkpoint.latest_checkpoint(r.pdir)) == \
            os.path.basename(jax_ckpt.latest_checkpoint(r.jdir))
        got = checkpoint.load_into(r.model.state_dict(), ck["state_dict"])
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                                 want[k]), k
        r.model.load_state_dict(got)
        assert os.path.exists(os.path.join(r.pdir, "config.yaml"))


def test_checkpoint_names_and_rolling_bestval_match_jax(runs, tmp_path):
    v = runs.m1.v
    state = SimpleNamespace(params=v["params"], batch_stats=v["batch_stats"],
                            step=30)
    sd = flax_to_state_dict(runs.m1.model, v)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    for epoch in (1, 2, 10):
        jax_ckpt.save_checkpoint(jdir, state, step=epoch)
        checkpoint.save_checkpoint(pdir, sd, 30, epoch=epoch)
    for epoch in (1, 3):
        jax_ckpt.save_bestval(jdir, state, epoch)
        checkpoint.save_bestval(pdir, sd, 30, epoch)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(pdir)) == [
        "bestval_at_3", "step_1", "step_10", "step_2"]
    for fn in ("latest_checkpoint", "bestval_checkpoint"):
        assert os.path.basename(getattr(checkpoint, fn)(pdir)) == \
            os.path.basename(getattr(jax_ckpt, fn)(jdir))
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None
    assert checkpoint.load_checkpoint(os.path.join(pdir, "step_2"))["step"] == 30
    # save_checkpoint without an epoch names the directory by the step
    assert checkpoint.save_checkpoint(pdir, sd, 40).endswith("step_40")


def _report(text, tag):
    m = re.findall(rf"\[{tag}\]\D*(\d+)\D+(\d+)", text)
    return [tuple(int(x) for x in t) for t in m]


def test_diff_keys_and_load_into_reports_match_jax(runs, capsys):
    """The lidar model's checkpoint as the template, the camera model's
    as the incoming one: the same names are missing and unexpected, and the
    same tensors restored, in both packages."""
    models = [runs.m1.model, runs.m2.model]
    tv, iv = runs.m1.v, runs.m2.v
    jmissing, junexpected, jcounts = set(), set(), [0, 0]
    restored_j = {}
    for col in ("params", "batch_stats"):
        miss, unexp = jax_ckpt.diff_keys(tv[col], iv[col])
        jmissing |= {_key(models, col, p) for p in miss}
        junexpected |= {_key(models, col, p) for p in unexp}
        capsys.readouterr()
        restored_j[col] = jax_ckpt.load_into(tv[col], iv[col])
        (counts,) = _report(capsys.readouterr().out, "load_into")
        jcounts = [a + b for a, b in zip(jcounts, counts)]
    tsd = flax_to_state_dict(runs.m1.model, tv)
    isd = {k: torch.from_numpy(a.copy()) for k, a in
           _jax_as_torch(models, iv).items()}
    miss, unexp = checkpoint.diff_keys(tsd, isd)
    assert (miss, unexp) == (jmissing, junexpected)
    assert miss and unexp
    got = checkpoint.load_into(tsd, isd)
    (counts,) = _report(capsys.readouterr().out, "load_into")
    assert list(counts) == jcounts
    want = _jax_as_torch(models, restored_j)
    assert set(got) == set(want)
    for k, arr in want.items():
        assert np.array_equal(got[k].numpy(), arr), k


def _key(models, col, path):
    mod_path = ".".join(path[:-1])
    for m in models:
        mods = dict(m.named_modules())
        if mod_path in mods:
            return f"{mod_path}." + weights._convert(
                mods[mod_path], col, path[-1],
                np.zeros((1, 1, 1, 1), np.float32))[0]
    raise KeyError(path)


@pytest.mark.parametrize("prefer_new", [False, True],
                         ids=["base_wins", "prefer_new_agent"])
def test_heal_tools_merge_matches_jax(runs, tmp_path, capsys, prefer_new):
    flag = ["--prefer_new_agent"] if prefer_new else []
    jout, pout = str(tmp_path / "jax_merged"), str(tmp_path / "port_merged")
    capsys.readouterr()
    jax_heal.main(["merge", "--new_ckpt", runs.m2.jdir, "--base_ckpt",
                   runs.m1.jdir, "--out", jout] + flag)
    (jparams,) = _report(capsys.readouterr().out, "merge_params")
    # the JAX tool reports the parameters' conflicts; its batch_stats
    # merge is silent, so count those here
    jnew = jax_ckpt.load_checkpoint(jax_ckpt.latest_checkpoint(runs.m2.jdir))
    jbase = jax_ckpt.load_checkpoint(jax_ckpt.latest_checkpoint(runs.m1.jdir))
    jax_ckpt.merge_params(jnew["batch_stats"], jbase["batch_stats"])
    (jstats,) = _report(capsys.readouterr().out, "merge_params")
    heal_tools.main(["--device", "cpu", "merge", "--new_ckpt", runs.m2.pdir,
                     "--base_ckpt", runs.m1.pdir, "--out", pout] + flag)
    (pcounts,) = _report(capsys.readouterr().out, "merge_params")
    assert list(pcounts) == [a + b for a, b in zip(jparams, jstats)]
    assert pcounts[1] > 0  # the two stage-1 runs share module names
    jmerged = jax_ckpt.load_checkpoint(os.path.join(jout, "step_0"))
    want = _jax_as_torch([runs.m1.model, runs.m2.model], jmerged)
    got = _load_port(pout)
    assert got["step"] == 0 and set(got["state_dict"]) == set(want)
    for k, arr in want.items():
        assert np.array_equal(got["state_dict"][k].numpy(), arr), k


def test_fault_h_merged_stage1_checkpoint_has_no_branch_m2(runs, tmp_path):
    """Reference fault h, recorded: m2_att.yaml names its camera modality
    m1, and the merge lets the base's lidar branch_m1 win, so the merged
    m1_att + m2_att checkpoint holds no branch_m2 (nor
    message_extractor_m2). Restored into m1m2_att, both packages report
    exactly those modules missing (they keep their initial values) and the
    camera encoder's leaves under branch_m1 unexpected."""
    jout, pout = str(tmp_path / "jax_merged"), str(tmp_path / "port_merged")
    jax_heal.main(["merge", "--new_ckpt", runs.m2.jdir, "--base_ckpt",
                   runs.m1.jdir, "--out", jout])
    heal_tools.main(["--device", "cpu", "merge", "--new_ckpt", runs.m2.pdir,
                     "--base_ckpt", runs.m1.pdir, "--out", pout])
    merged = _load_port(pout)["state_dict"]
    assert not any(k.startswith(("branch_m2.", "message_extractor_m2."))
                   for k in merged)
    template = runs.m1m2.model.state_dict()
    missing = {k for k, v in template.items()
               if k not in merged or merged[k].shape != v.shape}
    unexpected = set(merged) - set(template)
    assert {k.partition(".")[0] for k in missing} == {
        "branch_m2", "message_extractor_m2"}
    assert missing == {k for k in template if k.startswith(
        ("branch_m2.", "message_extractor_m2."))}
    assert unexpected and all(k.startswith("branch_m1.encoder.")
                              for k in unexpected)
    # the JAX package's restore into the same model
    jmerged = jax_ckpt.load_checkpoint(os.path.join(jout, "step_0"))
    jtemplate = _variables(runs.m1m2.jh, seed=2)
    models = [runs.m1m2.model, runs.m1.model, runs.m2.model]
    jmissing, junexpected = set(), set()
    for col in ("params", "batch_stats"):
        t, m = flatten_dict(jtemplate[col]), flatten_dict(jmerged[col])
        jmissing |= {_key(models, col, p) for p, v in t.items()
                     if p not in m or np.shape(m[p]) != v.shape}
        junexpected |= {_key(models, col, p) for p in m if p not in t}
    assert (jmissing, junexpected) == (missing, unexpected)


# ---------------------------------------------------------------- stage 2
def test_stage2_trainable_prefixes_match_jax(runs):
    for h in (runs.m1m2.ph, runs.m1.ph):
        assert trainer.stage2_trainable_prefixes(h) == \
            jax_trainer.stage2_trainable_prefixes(h)
    assert trainer.stage2_trainable_prefixes(runs.m1m2.ph) == [
        "message_extractor_m2"]


def _labelled_batch(hypes):
    from tests.test_torch_config import small_scenes_config
    from gencomm_tpu.data.synthetic import SyntheticScenes as JaxScenes

    host = JaxScenes(small_scenes_config(hypes, jax_side=True)).sample(5, 2)
    return host_decorate_pillars(jax_bucketing.trim_agent_slots(host), hypes)


@pytest.fixture(scope="module")
def stage2_run(runs):
    """One stage-2 step of the narrowed m1m2_att from the same weights,
    batch (2 samples) and diffusion noise: the JAX package's
    (``make_optimizer`` / ``make_train_step`` with the stage-2 predicate)
    and the port's."""
    jh, ph = runs.m1m2.jh, runs.m1m2.ph
    variables = _variables(jh, seed=3)
    batch = _labelled_batch(jh)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jax_create_model(jh)
    pred = jax_trainer.freeze_all_except(
        jax_trainer.stage2_trainable_prefixes(jh))
    tx = jax_trainer.make_optimizer(jh, 1, pred)
    state = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]))
    n = batch["agent_mask"].size
    rng = np.random.RandomState(11)
    noises = [rng.randn(n, 10, 20, 32).astype(np.float32) for _ in range(3)]
    replay = iter(noises)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal",
                   lambda key, shape, dtype=jnp.float32: jnp.asarray(
                       next(replay)).reshape(shape).astype(dtype))
        step = jax_trainer.make_train_step(jmodel, jax_create_loss(jh), tx,
                                           pred)
        new_state, jlosses = step(state, jbatch, jax.random.PRNGKey(0))
    model = create_model(ph, device="cpu")
    start = flax_to_state_dict(model, variables)
    model.load_state_dict(start)
    tpred = trainer.freeze_all_except(trainer.stage2_trainable_prefixes(ph))
    opt, sched = trainer.make_optimizer(ph, model.named_parameters(), 1, tpred)
    tstep = trainer.make_train_step(model, create_loss(ph), opt, sched,
                                    frozen_predicate=tpred)
    losses = tstep(batch_to_device(batch, "cpu"),
                   noises=[torch.from_numpy(z) for z in noises])
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    return SimpleNamespace(
        model=model, start=start, losses=losses, pred=pred, opt=opt,
        variables=variables,
        jlosses={k: float(v) for k, v in jlosses.items()},
        jstate=flax_to_state_dict(model, {
            "params": to_np(new_state.params),
            "batch_stats": to_np(new_state.batch_stats)}))


def test_stage2_trainable_set_is_jax_multi_transform_label(stage2_run):
    run = stage2_run
    models = [run.model]
    trainable = {_key(models, "params", p)
                 for p in flatten_dict(run.variables["params"])
                 if not run.pred(p)}
    got = {n for n, p in run.model.named_parameters() if p.requires_grad}
    assert got == trainable and all(k.startswith("message_extractor_m2.")
                                    for k in got)
    held = {id(p) for g in run.opt.param_groups for p in g["params"]}
    assert held == {id(p) for n, p in run.model.named_parameters()
                    if n in trainable}


@pytest.mark.parametrize("build,names", [
    ("freeze_by_prefixes", ["branch_m1", "heads"]),
    ("freeze_all_except", ["message_extractor", "gencomm"]),
    ("freeze_exact", ["heads", "branch_m2", "fusion_net"]),
], ids=["by_prefixes", "all_except", "exact"])
def test_freeze_predicates_take_the_jax_packages_paths(stage2_run, build,
                                                       names):
    """Each predicate builder of both packages, on every parameter of the
    narrowed m1m2_att: the port's takes a torch name exactly where JAX's
    takes the flax path it carries across to."""
    jpred = getattr(jax_trainer, build)(names)
    pred = getattr(trainer, build)(names)
    taken = set()
    for col in ("params", "batch_stats"):
        for path in flatten_dict(stage2_run.variables[col]):
            key = _key([stage2_run.model], col, path)
            assert pred(tuple(key.split("."))) == jpred(path), key
            taken.add(jpred(path))
    assert taken == {True, False}


def test_stage2_step_leaves_the_frozen_state_bit_equal(stage2_run):
    run = stage2_run
    now = run.model.state_dict()
    moved = {k for k in now if not torch.equal(now[k], run.start[k])}
    assert moved and all(k.startswith("message_extractor_m2.") for k in moved)
    # the JAX step leaves the same entries where they were
    jmoved = {k for k in now if not torch.equal(run.jstate[k], run.start[k])}
    assert moved == jmoved
    assert not any(k.endswith(("running_mean", "running_var")) for k in moved)


def test_stage2_step_matches_jax_and_optax(stage2_run):
    run = stage2_run
    assert set(run.losses) == set(run.jlosses)
    for k, want in run.jlosses.items():
        # the tolerance of test_torch_train.py's whole step
        np.testing.assert_allclose(float(run.losses[k]), want, rtol=1e-4,
                                   err_msg=k)
    lr = float(run.opt.param_groups[0]["lr"])
    for name, p in run.model.named_parameters():
        if not p.requires_grad:
            continue
        # the first Adam step moves a weight by ~lr * sign(grad) plus the
        # decay: test_torch_train.py:698-711's tolerance on the whole
        # update, and its tighter one where the gradient has settled
        got, want = p.detach().numpy(), run.jstate[name].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 * lr + 1e-6,
                                   err_msg=name)
        g = p.grad.numpy()
        settled = np.abs(g) > 1e-2 * np.abs(g).max()
        np.testing.assert_allclose(got[settled], want[settled], rtol=0,
                                   atol=1e-6 + 1e-4 * lr, err_msg=name)


@pytest.mark.parametrize("lr_scheduler", [
    {"core_method": "step", "gamma": 0.5, "step_size": 3},
    {"core_method": "exponential", "gamma": 0.9},
    {"core_method": "cosine_with_warmup"},
], ids=["step", "exponential", "unknown_is_constant"])
def test_schedules_match_optax_around_their_boundaries(lr_scheduler):
    hypes = {"optimizer": {"core_method": "Adam", "lr": 0.002},
             "lr_scheduler": lr_scheduler}
    spe = 7
    want = jax_trainer.make_lr_schedule(hypes, steps_per_epoch=spe)
    got = trainer.make_lr_schedule(hypes, steps_per_epoch=spe)
    for count in (0, 1, 6, 7, 8, 20, 21, 22, 41, 42, 43, 100):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6,
                                   err_msg=str(count))
    opt, sched = trainer.make_optimizer(
        hypes, [("w", torch.nn.Parameter(torch.zeros(1)))],
        steps_per_epoch=spe)
    for count in range(45):
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   float(want(count)), rtol=1e-6)
        opt.step()
        sched.step()


@pytest.fixture(scope="module")
def refresh_run(runs):
    """The narrowed m1_att from the same weights, batch (2 samples) and
    diffusion noise through both packages' ``refresh_batch_stats`` and then
    ``make_eval_step``."""
    jh, ph = runs.m1.jh, runs.m1.ph
    batch = _labelled_batch(jh)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    n = batch["agent_mask"].size
    rng = np.random.RandomState(12)
    noises = [rng.randn(n, 10, 20, 32).astype(np.float32) for _ in range(3)]
    jmodel = jax_create_model(jh)
    state = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=runs.m1.v["params"],
        batch_stats=runs.m1.v["batch_stats"], opt_state=None)
    with pytest.MonkeyPatch.context() as mp:
        for fn in ("refresh", "eval"):
            replay = iter(noises)
            mp.setattr(jax.random, "normal",
                       lambda key, shape, dtype=jnp.float32: jnp.asarray(
                           next(replay)).reshape(shape).astype(dtype))
            if fn == "refresh":
                state = jax_trainer.refresh_batch_stats(
                    jmodel, state, [jbatch], jax.random.PRNGKey(0))
            else:
                jlosses = jax_trainer.make_eval_step(
                    jmodel, jax_create_loss(jh))(state, jbatch,
                                                 jax.random.PRNGKey(0))
            assert next(replay, None) is None  # every noise drawn once
    model = create_model(ph, device="cpu")
    model.load_state_dict(flax_to_state_dict(model, runs.m1.v))
    tbatch = batch_to_device(batch, "cpu")
    tnoises = [torch.from_numpy(z) for z in noises]
    trainer.refresh_batch_stats(model, [tbatch], noises=[tnoises])
    losses = trainer.make_eval_step(model, create_loss(ph))(tbatch,
                                                            noises=tnoises)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    jstate = flax_to_state_dict(model, {
        "params": runs.m1.v["params"],
        "batch_stats": to_np(state.batch_stats)})
    # the eval step alone, on the statistics JAX's refresh gave
    same_stats = create_model(ph, device="cpu")
    same_stats.load_state_dict(jstate)
    same_losses = trainer.make_eval_step(same_stats, create_loss(ph))(
        tbatch, noises=tnoises)
    return SimpleNamespace(
        model=model, losses=losses, same_stats=same_stats,
        same_losses=same_losses,
        jlosses={k: float(v) for k, v in jlosses.items()},
        start=flax_to_state_dict(model, runs.m1.v), jstate=jstate)


def test_refresh_batch_stats_recovers_the_batch_statistics(refresh_run):
    """Both packages put each norm's batch statistics b = (ra' - m ra) /
    (1 - m) in its running statistics, from the same weights, batch and
    noise. The extrapolation multiplies the fp32 rounding of ra' by
    1 / (1 - m) = 100: held to 1e-4 x max(1, max|want|) (observed 2.4e-5).
    Every running statistic moved."""
    run = refresh_run
    now = dict(run.model.named_buffers())
    stats = [k for k in now if k.endswith(("running_mean", "running_var"))]
    assert stats and set(stats) == {k for k in run.jstate if k in now}
    for k in stats:
        assert not torch.equal(now[k], run.start[k]), k
        _close(now[k].numpy(), run.jstate[k].numpy(), 1e-4, k)


def test_eval_step_matches_jax_after_the_refresh(refresh_run):
    """The eval step (running statistics, no update) on the statistics
    JAX's refresh gave: every loss within the loss tolerance of
    test_torch_train.py:370 (rtol 1e-5). After each package's own refresh
    the statistics differ as above, and the total loss is held to the
    whole step's 1e-4 (observed 2.4e-5). The model is left in eval mode
    with its weights unchanged."""
    run = refresh_run
    assert not run.model.training and not run.same_stats.training
    assert set(run.losses) == set(run.same_losses) == set(run.jlosses)
    for k, want in run.jlosses.items():
        np.testing.assert_allclose(float(run.same_losses[k]), want,
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(run.losses["total_loss"]),
                               run.jlosses["total_loss"], rtol=1e-4)
    for k, v in run.model.state_dict().items():
        if not k.endswith(("running_mean", "running_var")):
            assert torch.equal(v, run.start[k]), k


# ---------------------------------------------------------------- train CLI
def test_first_batches_equal_the_jax_clis(runs):
    """build_dataset, batches and the adapt chain (trim_agent_slots, then
    the host pillar decoration) of both command lines, on the same yaml."""
    jh, ph = runs.m1m2.jh, runs.m1m2.ph
    jds = jax_train_cli.build_dataset(jh, True, "synthetic")
    pds = train_cli.build_dataset(ph, True, "synthetic")
    jgen = jax_train_cli.batches(jds, 1, 0, "synthetic")
    pgen = train_cli.batches(pds, 1, 0, "synthetic")
    adapt = train_cli.Adapt(ph)
    for _ in range(2):
        want = host_decorate_pillars(jax_bucketing.trim_agent_slots(
            next(jgen)), jh)
        got = adapt(next(pgen))
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert "decorated_m1" in got and "imgs_m2" in got


def test_worker_processes_give_the_same_batches(runs):
    ph = runs.m1.ph
    ds = train_cli.build_dataset(ph, True, "synthetic")
    adapt = train_cli.Adapt(ph)
    it = multi_worker_iter(functools.partial(
        train_cli.epoch_batches, ds, 1, "synthetic", adapt, 0), 2)
    got = [next(it) for _ in range(4)]
    procs = list(it._procs)
    it.close()
    assert all(not p.is_alive() for p in procs)
    want = [adapt(ds.sample((0 * 100 + w) * 10000 + s, 1))
            for w in (0, 1) for s in range(4)]
    for g in got:
        assert any(all(np.array_equal(g[k], w[k]) for k in w) for w in want)


def _write_yaml(tmp_path, raw, name):
    p = tmp_path / f"{name}.yaml"
    p.write_text(yaml.safe_dump(raw))
    return str(p)


def test_train_cli_checkpoints_resumes_and_keeps_bestval(runs, tmp_path,
                                                         capsys):
    y = _write_yaml(tmp_path, runs.m1.raw, "m1")
    run = str(tmp_path / "run")
    args = ["-y", y, "--model_dir", run, "--dataset", "synthetic",
            "--steps_per_epoch", "2", "--val_steps", "1", "--device", "cpu"]
    train_cli.main(args + ["--epochs", "1"])
    out = capsys.readouterr().out
    assert "[epoch 0][0]" in out and "val loss" in out
    assert sorted(os.listdir(run)) == sorted(
        ["bestval.json", "bestval_at_1", "config.yaml", "metrics.jsonl",
         "step_1"] + (["tb"] if os.path.isdir(os.path.join(run, "tb"))
                      else []))
    assert checkpoint.load_checkpoint(os.path.join(run, "step_1"))["step"] == 2
    best1 = checkpoint.bestval_checkpoint(run)
    # a recorded best loss the next epoch cannot beat: the bestval stays
    with open(os.path.join(run, "bestval.json"), "w") as f:
        json.dump({"val_loss": 0.0, "epoch": 1}, f)
    train_cli.main(args + ["--epochs", "2"])
    out = capsys.readouterr().out
    assert "resumed from" in out and "(epoch 1)" in out
    assert "[epoch 0]" not in out and "[epoch 1][0]" in out
    assert checkpoint.bestval_checkpoint(run) == best1
    assert checkpoint.load_checkpoint(os.path.join(run, "step_2"))["step"] == 4
    with open(os.path.join(run, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert {"step", "train/total_loss"} <= set(lines[0])
    assert any("val/total_loss" in x for x in lines)
    assert jax_yaml.load_yaml(None, run)["name"] == runs.m1.raw["name"]


def test_metrics_logger_writes_the_jax_line_format(tmp_path):
    m = MetricsLogger(str(tmp_path), use_tensorboard=False)
    m.log(0, {"total_loss": torch.tensor(1.5)}, prefix="train/")
    m.log(10, {"total_loss": 1.2}, prefix="val/")
    m.close()
    with open(tmp_path / "metrics.jsonl") as f:
        assert [json.loads(x) for x in f] == [
            {"step": 0, "train/total_loss": 1.5},
            {"step": 10, "val/total_loss": 1.2}]


def test_train_cli_stage2_from_the_merge(runs, tmp_path, capsys):
    """--init_from the merged stage-1 checkpoint: the key diff is reported
    (fault h's missing modules), only message_extractor_m2 trains."""
    merged = str(tmp_path / "merged")
    heal_tools.main(["--device", "cpu", "merge", "--new_ckpt", runs.m2.pdir,
                     "--base_ckpt", runs.m1.pdir, "--out", merged])
    y = _write_yaml(tmp_path, runs.m1m2.raw, "m1m2")
    run = str(tmp_path / "stage2")
    capsys.readouterr()
    train_cli.main(["-y", y, "--model_dir", run, "--dataset", "synthetic",
                    "--init_from", merged, "--epochs", "1",
                    "--steps_per_epoch", "1", "--val_steps", "1",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    n_missing = sum(1 for k in runs.m1m2.model.state_dict()
                    if k.startswith(("branch_m2.", "message_extractor_m2.")))
    assert f"[load_into] missing {n_missing} leaves" in out
    assert "stage-2 freeze: training only ['message_extractor_m2']" in out
    before = _load_port(merged)["state_dict"]
    after = _load_port(run)["state_dict"]
    for k, v in after.items():
        if k in before and not k.startswith("message_extractor_m2."):
            assert torch.equal(v, before[k]), k
    assert any(not torch.equal(after[k], before.get(k, after[k] + 1))
               for k in after if k.startswith("message_extractor_m2."))


# ---------------------------------------------------------------- inference
@pytest.fixture(scope="module")
def eval_dir(runs, tmp_path_factory):
    """A port run dir of the narrowed m1_att whose heads give anchors as
    boxes (regression zeroed) with raised class biases, so that some boxes
    match the GT and the APs are not all 0 (test_torch_serving.py's
    way); step_2 and bestval_at_1."""
    v = jax.tree_util.tree_map(np.array, runs.m1.v)
    v["params"]["heads"]["reg_head"]["kernel"][...] = 0.0
    v["params"]["heads"]["reg_head"]["bias"][...] = 0.0
    v["params"]["heads"]["cls_head"]["bias"] += 2.0
    d = str(tmp_path_factory.mktemp("eval") / "run")
    jdir = _jax_run_dir(os.path.dirname(d), "jax_eval", runs.m1.jh, v, 2, 24)
    jax_checkpoint_to_torch.convert(jdir, d)
    checkpoint.save_bestval(d, _load_port(d)["state_dict"], 12, 1)
    return SimpleNamespace(dir=d, variables=v)


def _const_noise(shape):
    """The same diffusion noise for every draw of a shape."""
    return np.random.RandomState(int(np.prod(shape)) % 9973).randn(
        *shape).astype(np.float32)


def test_inference_cli_matches_jax_eval_on_its_detections(runs, eval_dir,
                                                          capsys):
    recorded = []
    real_run = InferencePipeline.run

    def recording_run(self, batch, seed=0, noises=None):
        dets = real_run(self, batch, seed, noises)
        recorded.append((batch, dets))
        return dets

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(InferencePipeline, "run", recording_run)
        res = inference.main(["--model_dir", eval_dir.dir, "--dataset",
                              "synthetic", "--frames", "3", "--report_comm",
                              "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"loaded {checkpoint.bestval_checkpoint(eval_dir.dir)}" in out
    assert "comm report: {'payload': 'gencomm_message_2ch', 'n_senders': 1" \
        in out
    stat = jax_eval.new_result_stat()
    for host, dets in recorded:
        valid = dets.valid[0].numpy()
        gt = host["gt_boxes"][0][host["gt_mask"][0] == 1]
        from gencomm_tpu.utils import box_utils as jax_box

        for t in (0.3, 0.5, 0.7):
            jax_eval.calculate_tp_fp(dets.corners3d[0].numpy()[valid],
                                     dets.scores[0].numpy()[valid],
                                     jax_box.boxes_to_corners_3d(gt, "hwl"),
                                     stat, t)
    for global_sort, tag in ((False, "eval"), (True, "eval_global_sort")):
        want = jax_eval.eval_final_results(stat, global_sort)
        with open(os.path.join(eval_dir.dir, f"{tag}.yaml")) as f:
            got = yaml.safe_load(f)
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6, (tag, k, got, want)
    assert res == got and got["ap30"] > 0


def test_inference_detections_match_the_jax_pipeline(runs, eval_dir):
    """The CLI's first frame through the port's and the JAX package's
    pipelines with the same weights and injected noise (the tolerances of
    test_torch_pipeline.py)."""
    from gencomm_tpu.pipeline import InferencePipeline as JaxPipeline

    hypes = runs.m1.jh
    ds = train_cli.build_dataset(runs.m1.ph, False, "synthetic")
    host = trim_agent_slots(ds.sample(1000, 1), buckets=(2, 3, 5))
    model = create_model(runs.m1.ph, device="cpu")
    model.load_state_dict(_load_port(eval_dir.dir)["state_dict"])
    anchors = jax_anchors(hypes["postprocess"]["anchor_args"])
    pipe = InferencePipeline(model, anchors, hypes["postprocess"],
                             device="cpu")
    host = pipe.decorate(host)
    n = host["agent_mask"].size
    z = _const_noise((n, 10, 20, 32))
    dets = pipe.run(host, noises=[torch.from_numpy(z)] * 3)
    jmodel = jax_create_model(hypes)
    jpipe = JaxPipeline(jmodel, eval_dir.variables, anchors,
                        hypes["postprocess"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal",
                   lambda key, shape, dtype=jnp.float32: jnp.asarray(
                       _const_noise(tuple(shape))).astype(dtype))
        want = jpipe.run({k: jnp.asarray(v) for k, v in host.items()})
    wv, gv = np.asarray(want.valid[0]), dets.valid[0].numpy()
    assert wv.sum() > 0 and gv.sum() == wv.sum()
    np.testing.assert_allclose(dets.scores[0].numpy()[gv],
                               np.asarray(want.scores[0])[wv], atol=1e-4)
    np.testing.assert_allclose(dets.corners3d[0].numpy()[gv],
                               np.asarray(want.corners3d[0])[wv], atol=1e-3)


def test_inference_cli_checkpoint_choice_and_use_cav(runs, eval_dir, capsys,
                                                     tmp_path):
    d = eval_dir.dir
    step2 = os.path.join(d, "step_2")
    for extra, want in (
            (["--ckpt", step2], step2),
            ([], jax_ckpt.bestval_checkpoint(d) or jax_ckpt.latest_checkpoint(d))):
        inference.main(["--model_dir", d, "--dataset", "synthetic",
                        "--frames", "1", "--device", "cpu"] + extra)
        assert f"loaded {want}\n" in capsys.readouterr().out
    # without a bestval the latest checkpoint, as the JAX tool chooses
    nobest = str(tmp_path / "nobest")
    os.makedirs(nobest)
    for f in ("config.yaml", "step_2"):
        os.symlink(os.path.join(d, f), os.path.join(nobest, f))
    inference.main(["--model_dir", nobest, "--dataset", "synthetic",
                    "--frames", "1", "--device", "cpu"])
    assert f"loaded {jax_ckpt.latest_checkpoint(nobest)}\n" in \
        capsys.readouterr().out
    # --use_cav: the masks as the JAX tool writes them (tools/inference.py
    # l.146-156), then the trim to the agent buckets
    ds = train_cli.build_dataset(runs.m1.ph, False, "synthetic")
    host = ds.sample(1000, 1)
    got = inference.cap_agents(host, 1)
    want = dict(host)
    am = want["agent_mask"].copy()
    am[:, 1:] = False
    want["agent_mask"] = am
    for k in [k for k in want if k.startswith("modality_mask_")]:
        mm = want[k].copy()
        mm[:, 1:] = False
        want[k] = mm
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert host["agent_mask"][0, 1]  # the frame was not changed in place
    capsys.readouterr()
    res = inference_heter_in_order.main(["--model_dir", d, "--dataset",
                                         "synthetic", "--frames", "1",
                                         "--max_cav", "2", "--device", "cpu"])
    assert sorted(res) == [1, 2]
    for k in (1, 2):
        assert os.path.exists(os.path.join(d, f"eval_in_order_{k}cav.yaml"))
