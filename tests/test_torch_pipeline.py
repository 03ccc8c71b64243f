"""The port's whole eval slice against the JAX package, on the CPU.

One small scene (a 32 x 16 m range, narrow widths, 2 agents) goes through
``gencomm_tpu`` and ``gencomm_tpu_torch`` with the same weights (carried by
``weights.py``) and the same diffusion noise (the JAX draws, recorded by
wrapping ``jax.random.normal`` during one un-jitted apply). Also the port's
hygiene: it imports without JAX, names no JAX module, and its entry points
refuse to guess a device.
"""

import os
import re
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gencomm_tpu.models.heter_baseline import HeterModel as JaxHeterModel
from gencomm_tpu.data.postprocessor import decode_and_nms as jax_decode

from gencomm_tpu_torch.data.bucketing import trim_agent_slots
from gencomm_tpu_torch.data.decorate import decorate_modality
from gencomm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from gencomm_tpu_torch.models.heter_baseline import HeterModel
from gencomm_tpu_torch.native import PillarVoxelizer
from gencomm_tpu_torch.pipeline import InferencePipeline, batch_to_device
from gencomm_tpu_torch.weights import load_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = (-16.0, -8.0, -3.0, 16.0, 8.0, 1.0)
VOXEL = (0.4, 0.4, 4.0)
MODEL_KW = dict(
    modality_args={"m1": {
        "encoder_args": {"voxel_size": list(VOXEL), "lidar_range": list(LR),
                         "pillar_vfe": {"use_norm": True, "num_filters": [16]},
                         "striped_scatter": True},
        "backbone_args": {"layer_nums": [1, 1], "layer_strides": [2, 2],
                          "num_filters": [16, 32], "upsample_strides": [1, 2],
                          "num_upsample_filter": [16, 16]},
        "shrink_header": {"kernal_size": [3], "stride": [2], "padding": [1],
                          "dim": [32], "input_dim": 32},
    }},
    fusion_method="att", lidar_range=LR, anchor_number=2, use_gencomm=True,
    use_enhancer=True)
POSTPROCESS = {"gt_range": list(LR), "target_args": {"score_threshold": 0.2},
               "nms_thresh": 0.15,
               "dir_args": {"dir_offset": 0.7853, "num_bins": 2},
               "nms_topk": 512}


def _scene():
    cfg = SyntheticConfig(lidar_range=LR, max_cav=5, num_agents=2,
                          points_per_agent=3000, num_vehicles=6,
                          points_per_vehicle=60, comm_range=12.0)
    scenes = SyntheticScenes(cfg)
    host = trim_agent_slots(scenes.sample(seed=3, batch_size=1))
    return scenes, decorate_modality(host, PillarVoxelizer(LR, VOXEL))


@pytest.fixture(scope="module")
def slice_run():
    """Run the JAX model once (recording its noise) and the port once on
    the same frame and weights; returns both outputs and the port's
    pieces."""
    scenes, batch = _scene()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JaxHeterModel(**MODEL_KW, fusion_args={"att": {"feat_dim": 32}},
                           in_head=32)
    variables = jmodel.init({"params": jax.random.PRNGKey(0),
                             "diffusion": jax.random.PRNGKey(1)},
                            jbatch, train=False)
    variables = jax.tree_util.tree_map(np.array, variables)

    recorded = []
    real_normal = jax.random.normal

    def recording_normal(*args, **kwargs):
        out = real_normal(*args, **kwargs)
        recorded.append(np.asarray(out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", recording_normal)
        jout = jmodel.apply(variables, jbatch, train=False,
                            rngs={"diffusion": jax.random.PRNGKey(7)})

    model = HeterModel(**MODEL_KW, device="cpu")
    load_flax_variables(model, variables)
    noises = [torch.from_numpy(n.copy()) for n in recorded]
    with torch.inference_mode():
        tout = model(batch_to_device(batch, "cpu"), noises=noises)
    return dict(scenes=scenes, batch=batch, jout=jout, tout=tout,
                model=model, noises=noises)


def test_noise_recorded_in_jax_order(slice_run):
    # q_sample draw + one per reverse step t = 2, 1
    assert len(slice_run["noises"]) == 3
    assert slice_run["noises"][0].shape == (2, 10, 20, 32)


@pytest.mark.parametrize("key", ["message", "pred_feature", "cls_preds",
                                 "reg_preds", "dir_preds"])
def test_outputs_match_jax(slice_run, key):
    # fp32 on both sides; the orders of the sums differ (XLA vs PyTorch
    # CPU convolutions, flax vs port normalization), compounded over ~40
    # layers and three UNet passes. Observed <= 1e-5 of the output's
    # scale; held to 1e-4 of it
    want = np.asarray(slice_run["jout"][key], np.float32)
    got = slice_run["tout"][key].numpy()
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_detections_match_jax(slice_run):
    scenes, jout = slice_run["scenes"], slice_run["jout"]
    pipe = InferencePipeline(slice_run["model"], scenes.anchors, POSTPROCESS,
                             device="cpu")
    dets = pipe.run(slice_run["batch"], noises=slice_run["noises"])
    want = jax_decode(jout["cls_preds"][0], jout["reg_preds"][0],
                      jout["dir_preds"][0], jnp.asarray(scenes.anchors),
                      jnp.eye(4), tuple(LR), score_threshold=0.2,
                      nms_thresh=0.15, topk=512, dir_offset=0.7853,
                      num_bins=2)
    wv = np.asarray(want.valid)
    gv = dets.valid[0].numpy()
    assert wv.sum() > 0, "the scene should give detections"
    assert gv.sum() == wv.sum()
    # the kept boxes in score order; sigmoid scores inherit the head
    # tolerance, corners (metres, |x| <= 20) the regression's times the
    # anchor scale
    np.testing.assert_allclose(dets.scores[0].numpy()[gv],
                               np.asarray(want.scores)[wv], atol=1e-4)
    np.testing.assert_allclose(dets.corners3d[0].numpy()[gv],
                               np.asarray(want.corners3d)[wv], atol=1e-3)


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import gencomm_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "gencomm_tpu_torch.__path__, 'gencomm_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(k == 'gencomm_tpu' or k.startswith('gencomm_tpu.') "
        "for k in sys.modules), 'the JAX package was imported'\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def test_port_sources_name_no_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|gencomm_tpu)(\.|\s|$)", re.M)
    pkg = os.path.join(REPO, "gencomm_tpu_torch")
    offenders = []
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith((".py", ".cu", ".cpp")):
                path = os.path.join(root, f)
                with open(path) as fh:
                    if pattern.search(fh.read()):
                        offenders.append(path)
    assert not offenders


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HeterModel(**MODEL_KW)
    model = HeterModel(**MODEL_KW, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferencePipeline(model, np.zeros((10, 20, 2, 7), np.float32),
                          POSTPROCESS)


def test_unported_branches_raise():
    # half=True (bf16 eval) is ported; bf16 training is not
    model = HeterModel(**MODEL_KW, half=True, device="cpu")
    assert not model.training
    with pytest.raises(NotImplementedError, match="bf16 training"):
        model.train()
    # the late and no-fusion modes are ported (test_torch_serving.py), and
    # every intermediate fusion (test_torch_fusion.py); the pyramid fusion
    # runs inside the HEAL pyramid models (test_torch_pyramid.py)
    with pytest.raises(ValueError, match="heter_pyramid"):
        HeterModel(**dict(MODEL_KW, fusion_method="pyramid"), device="cpu")
