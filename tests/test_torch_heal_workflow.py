"""The HEAL workflow of the port on the CPU, on narrowed copies of its
yamls (``test_torch_pyramid.narrowed_pyramid``), as
``scripts/heal_pipeline_torch.sh`` runs it: stage 1 (``stage1/
m1_pyramid``, the collaboration base with the occupancy pass) for 2 steps,
stage 2 (``stage2/m2_single_pyramid``) from it for 1 step with the pyramid
and heads frozen, ``heal_tools merge``, inference of ``final_infer/m1m2`` on the
merged checkpoint; and the inference CLI's APs against the JAX package's
``tools/inference.py`` on the same frames and weights (a JAX checkpoint
carried across by ``scripts/jax_checkpoint_to_torch.py``).
"""

import json
import math
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
from gencomm_tpu.models import create_model as jax_create_model
from gencomm_tpu.tools import inference as jax_inference
from gencomm_tpu.train import checkpoint as jax_ckpt

from gencomm_tpu_torch.models import create_model
from gencomm_tpu_torch.tools import heal_tools, inference
from gencomm_tpu_torch.tools import train as train_cli
from gencomm_tpu_torch.train import checkpoint, trainer

from tests.test_torch_pyramid import (
    M1_PYRAMID, M1M2, M2_SINGLE, hypes_pair, narrowed_pyramid,
)
from tests.test_torch_train import _random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import jax_checkpoint_to_torch  # noqa: E402

STEPS = 2
FRAMES = 2


def _write(root, name, raw):
    path = os.path.join(root, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def _latest(run_dir):
    return checkpoint.load_checkpoint(
        checkpoint.latest_checkpoint(run_dir))["state_dict"]


@pytest.fixture(scope="module")
def heal(tmp_path_factory):
    """The three stages through the port's command lines (--device cpu),
    each training run's state when its steps start recorded."""
    root = str(tmp_path_factory.mktemp("heal"))
    r = SimpleNamespace(root=root, starts=[], out={})
    for name in ("base_m1", "single_m2", "final_m1m2"):
        setattr(r, name, os.path.join(root, name))
    real = trainer.make_train_step

    def recording(model, *a, **kw):
        r.starts.append({k: v.clone() for k, v in model.state_dict().items()})
        return real(model, *a, **kw)

    def train(yaml_name, raw, run_dir, steps, *extra):
        train_cli.main(["-y", _write(root, yaml_name, raw), "--model_dir",
                        run_dir, "--dataset", "synthetic", "--epochs", "1",
                        "--steps_per_epoch", str(steps), "--val_steps", "0",
                        "--device", "cpu", *extra])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "make_train_step", recording)
        train("m1_pyramid", narrowed_pyramid(M1_PYRAMID), r.base_m1, STEPS)
        train("m2_single_pyramid", narrowed_pyramid(M2_SINGLE), r.single_m2,
              1, "--init_from", r.base_m1)
    heal_tools.main(["--device", "cpu", "merge", "--new_ckpt", r.single_m2,
                     "--base_ckpt", r.base_m1, "--out", r.final_m1m2])
    r.final_raw = narrowed_pyramid(M1M2)
    with open(os.path.join(r.final_m1m2, "config.yaml"), "w") as f:
        yaml.safe_dump(r.final_raw, f)
    r.aps = inference.main(["--model_dir", r.final_m1m2, "--dataset",
                            "synthetic", "--frames", "1", "--device", "cpu"])
    return r


def test_stage1_trains_with_the_occupancy_pass(heal):
    with open(os.path.join(heal.base_m1, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert "train/pyramid_loss" in lines[0] and "train/cls_loss" in lines[0]
    assert all(math.isfinite(v) for x in lines for v in x.values())
    assert checkpoint.load_checkpoint(checkpoint.latest_checkpoint(
        heal.base_m1))["step"] == STEPS


def test_stage2_keeps_the_pyramid_and_heads_bit_for_bit(heal, capsys):
    """Every parameter and running statistic of ``pyramid_backbone`` and
    ``heads`` equals the base's; the camera branch was trained."""
    base, single = _latest(heal.base_m1), _latest(heal.single_m2)
    shared = [k for k in single if k.startswith(("pyramid_backbone.",
                                                 "heads."))]
    assert shared and all(torch.equal(single[k], base[k]) for k in shared)
    start = heal.starts[1]
    moved = [k for k in single if not torch.equal(single[k], start[k])]
    assert any(k.startswith("backbone_m2.") for k in moved)
    assert any(k.startswith("encoder_m2.") for k in moved)
    assert all(k.startswith(("backbone_m2.", "encoder_m2.")) for k in moved)
    with open(os.path.join(heal.single_m2, "metrics.jsonl")) as f:
        first = json.loads(f.readline())
    assert {"train/pyramid_loss", "train/depth_loss"} <= set(first)


def test_merge_fills_the_final_model(heal):
    merged = _latest(heal.final_m1m2)
    _, ph = hypes_pair(heal.final_raw)
    model = create_model(ph, device="cpu")
    model.load_state_dict(merged, strict=False)
    assert set(model.state_dict()) <= set(merged)
    for prefix, run in (("enc_branch_m1.", heal.base_m1),
                        ("encoder_m2.", heal.single_m2),
                        ("pyramid_backbone.", heal.base_m1)):
        src = _latest(run)
        keys = [k for k in merged if k.startswith(prefix)]
        assert keys and all(torch.equal(merged[k], src[k]) for k in keys)
    assert set(heal.aps) == {"ap30", "ap50", "ap70"}
    assert all(math.isfinite(v) for v in heal.aps.values())


@pytest.fixture(scope="module")
def tool_runs(tmp_path_factory):
    """``tools.inference`` of both packages (``--report_comm``) over the
    same frames, on one seeded checkpoint of the stage-1 base (collab
    m1_pyramid) written by the JAX package and carried across by the
    script; the regression head zeroed and the class biases raised, so
    that boxes sit on their anchors and some match the GT. (The final m1m2
    model's heads are held against JAX's in ``test_torch_pyramid.py``.)"""
    import contextlib
    import io

    from flax.traverse_util import flatten_dict
    from gencomm_tpu.tools.train import build_dataset
    from gencomm_tpu.train import trainer as jax_trainer

    root = tmp_path_factory.mktemp("tools")
    jh, _ = hypes_pair(narrowed_pyramid(M1_PYRAMID))
    jmodel = jax_create_model(jh)
    first = build_dataset(jh, False, "synthetic").sample(0, 1)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, b, train=False), first)
    v = jax.tree_util.tree_map(np.array, _random_variables(shapes, 4))
    v["params"]["heads"]["reg_head"]["kernel"][...] = 0.0
    v["params"]["heads"]["reg_head"]["bias"][...] = 0.0
    v["params"]["heads"]["cls_head"]["bias"] += 2.0
    r = SimpleNamespace(jdir=str(root / "jax"), pdir=str(root / "port"))
    os.makedirs(r.jdir)
    jax_yaml.save_yaml(jh, os.path.join(r.jdir, "config.yaml"))
    jax_ckpt.save_checkpoint(r.jdir, SimpleNamespace(
        params=v["params"], batch_stats=v["batch_stats"], step=0), step=1)
    jax_checkpoint_to_torch.convert(r.jdir, r.pdir)
    # the JAX tool's template init, from its own cache (keyed as the tool
    # keys it): the checkpoint overwrites every value, and compiling the
    # init would take longer than the inference
    init_dir = str(root / "init")
    os.makedirs(init_dir)
    tool_hypes = jax_yaml.load_yaml(None, r.jdir)
    key = jax_trainer._init_cache_key(
        jax_create_model(tool_hypes),
        build_dataset(tool_hypes, False, "synthetic").sample(0, 1),
        jax.random.PRNGKey(0), False)
    np.savez(os.path.join(init_dir, f"init_{key}.npz"), **{
        "//".join((col,) + k): a for col, tree in v.items()
        for k, a in flatten_dict(tree).items()})
    argv = ["--dataset", "synthetic", "--frames", str(FRAMES)]
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        # the JAX tool's process-wide settings stay out of the test worker
        import gencomm_tpu

        mp.setattr(gencomm_tpu, "enable_persistent_cache", lambda: None)
        mp.setattr(gencomm_tpu, "enable_fast_prng", lambda: None)
        mp.setattr(jax_trainer, "_INIT_CACHE_DIR", init_dir)
        r.want = jax_inference.main(["--model_dir", r.jdir] + argv)
        r.got = inference.main(["--model_dir", r.pdir, "--device", "cpu",
                                "--report_comm"] + argv)
    r.port_out = out.getvalue()
    # the keys of the JAX model's output that its report reads
    r.jax_keys = set(jax.eval_shape(lambda b: jmodel.apply(
        jax.tree_util.tree_map(jnp.asarray, v), b, train=False),
        first).keys())
    return r


def _comm_report(text):
    import ast
    import re

    return ast.literal_eval(re.search(r"comm report: (\{.*\})",
                                      text).group(1))


def test_inference_aps_match_the_jax_tool(tool_runs):
    """Per frame the APs agree within 1e-6; sorted over all frames,
    detections whose scores differ in the last bits (fp32 sums in another
    order) may swap ranks across frames, which moves the global-sort APs
    by up to 1e-3."""
    r = tool_runs
    assert r.want["ap30"] > 0
    for tag, tol in (("eval", 1e-6), ("eval_global_sort", 1e-3)):
        with open(os.path.join(r.jdir, f"{tag}.yaml")) as f:
            w = yaml.safe_load(f)
        with open(os.path.join(r.pdir, f"{tag}.yaml")) as f:
            g = yaml.safe_load(f)
        assert set(g) == set(w)
        for k in w:
            assert abs(g[k] - w[k]) <= tol, (tag, k, g, w)
    assert r.got == g


def test_fault_l_pyramid_payload_is_reported_as_zero_bytes(tool_runs):
    """Suspected reference fault l: the JAX report gives a model whose
    output has neither ``message`` nor ``gt_feature`` a zero-width payload
    (``tools/inference.py:220-227``), and the pyramid's output has neither,
    though HEAL agents send their pre-pyramid BEV feature; the port's
    report is the same: 0 raw bytes from the one sender."""
    assert not {"message", "gt_feature"} & tool_runs.jax_keys
    got = _comm_report(tool_runs.port_out)
    assert got == {"payload": "bev_feature", "n_senders": 1,
                   "cpm_bytes_fp16_raw": 0, "cpm_bytes_fp16_deflate": 8}
