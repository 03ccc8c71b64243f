"""The intermediate-fusion family of the port against the JAX package, on
the CPU.

Each fusion (``max``, ``disconet``, ``who2com``, ``v2xvit``, ``cobevt``,
``where2comm``, ``v2vnet``) and Where2comm's ``Communication`` get the same
numpy inputs (2 samples x 3 agent slots, one of them padded, a 16 x 32 map
of 32 channels: V2X-ViT's windows of 4, 8 and 16 divide it) and the same
weights, carried from flax by ``weights.py``: the forward within 2e-5 of
max(1, max|out|), the input's and every parameter's gradient of a fixed
random projection of the output against ``jax.grad`` within 1e-4 of the
gradient's largest entry; with a bf16 input (``half``) the forward against
JAX's bf16 run, in bf16 steps. Then the fusions inside the model: a
narrowed ``stage1/m1_v2xvit.yaml`` slice against JAX's heads and losses,
the Where2comm mask of ``model.args.communication``,
``PointPillarDiscoNetLoss`` and one ``make_kd_train_step`` step against
JAX's; the train CLI on a V2X-ViT yaml and with ``--trainer kd``; and the
suspected reference faults i, j and k (``ROADMAP.md`` section 3), which the
port copies.
"""

import copy
import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import yaml

from gencomm_tpu.config import yaml_utils as jax_yaml
from gencomm_tpu.data.decorate import host_decorate_pillars
from gencomm_tpu.data.synthetic import (
    SyntheticConfig as JaxSyntheticConfig, SyntheticScenes as JaxScenes,
)
from gencomm_tpu.loss import create_loss as jax_create_loss
from gencomm_tpu.loss.point_pillar_loss import (
    PointPillarDiscoNetLoss as JaxDiscoNetLoss,
)
from gencomm_tpu.models import create_model as jax_create_model
from gencomm_tpu.models.fuse import cobevt as jax_cobevt
from gencomm_tpu.models.fuse import fusion as jax_fusion
from gencomm_tpu.models.fuse import v2vnet as jax_v2vnet
from gencomm_tpu.models.fuse import v2xvit as jax_v2xvit
from gencomm_tpu.models.fuse import where2comm as jax_where2comm
from gencomm_tpu.ops.warp_pallas import warp_affine_mxu
from gencomm_tpu.train import trainer as jax_trainer

from gencomm_tpu_torch.config import yaml_utils
from gencomm_tpu_torch.data.bucketing import trim_agent_slots
from gencomm_tpu_torch.loss import create_loss
from gencomm_tpu_torch.loss.point_pillar_loss import PointPillarDiscoNetLoss
from gencomm_tpu_torch.models import create_model
from gencomm_tpu_torch.pipeline import batch_to_device
from gencomm_tpu_torch.tools import train as train_cli
from gencomm_tpu_torch.train import checkpoint, trainer

from gencomm_tpu_torch.models.fuse import cobevt, fusion, v2vnet, v2xvit
from gencomm_tpu_torch.models.fuse import where2comm
from gencomm_tpu_torch.weights import flax_grads_to_torch, flax_to_state_dict

from tests.test_torch_config import REPO, narrowed
from tests.test_torch_kernels import _close
from tests.test_torch_train import _random_variables

B, L, H, W, C = 2, 3, 16, 32, 32
MASK = np.array([[True, True, False], [True, True, True]])
FWD_TOL = 2e-5
GRAD_TOL = 1e-4
EPS = 2.0 ** -7  # bf16's step in [1, 2)


def _inputs(seed):
    """A map and rigid pairwise warps, the identity from an agent to itself
    (as ``normalize_pairwise_tfm`` gives): a max over agents would
    otherwise meet ties at the zeros that two warps leave outside the map,
    where a last-bit change of a sampling coordinate moves the gradient."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, L, H, W, C).astype(np.float32)
    ang = rng.uniform(-0.3, 0.3, (B, L, L))
    affine = np.zeros((B, L, L, 2, 3), np.float32)
    affine[..., 0, 0] = np.cos(ang)
    affine[..., 0, 1] = -np.sin(ang)
    affine[..., 1, 0] = np.sin(ang)
    affine[..., 1, 1] = np.cos(ang)
    affine[..., :, 2] = rng.uniform(-0.3, 0.3, (B, L, L, 2))
    affine[:, np.arange(L), np.arange(L)] = np.eye(2, 3)
    return x, affine


# name -> (the JAX module, the port's), built alike
FUSIONS = {
    "max": (lambda: jax_fusion.MaxFusion(), lambda: fusion.MaxFusion()),
    "disconet": (lambda: jax_fusion.DiscoFusion(),
                 lambda: fusion.DiscoFusion(C)),
    "who2com": (lambda: jax_fusion.Who2comFusion(feat_dim=C),
                lambda: fusion.Who2comFusion(C, C)),
    "v2xvit": (lambda: jax_v2xvit.V2XViTFusion(dim=C, depth=2),
               lambda: v2xvit.V2XViTFusion(C, depth=2)),
    "cobevt": (lambda: jax_cobevt.CoBEVTFusion(
        input_dim=C, mlp_dim=64, dim_head=16, window_size=8, depth=2),
        lambda: cobevt.CoBEVTFusion(C, L, mlp_dim=64, dim_head=16,
                                    window_size=8, depth=2)),
    "where2comm": (lambda: jax_where2comm.Where2commFusion(feat_dim=C),
                   lambda: where2comm.Where2commFusion(C, feat_dim=C)),
    "v2vnet": (lambda: jax_v2vnet.V2VNetFusion(in_channels=C),
               lambda: v2vnet.V2VNetFusion(C, in_channels=C)),
    "v2vnet_max_nogru": (
        lambda: jax_v2vnet.V2VNetFusion(in_channels=C, num_iteration=1,
                                        gru_flag=False, agg_operator="max"),
        lambda: v2vnet.V2VNetFusion(C, num_iteration=1, gru_flag=False,
                                    agg_operator="max")),
}


# fusions with a max over agents: their JAX gradient is taken op by op. Under
# jax.jit, XLA's fused gradient routes the cotangent of 3% of the input's
# entries elsewhere than the op-by-op rule (max's VJP: an equal share to each
# tied agent), which the port follows to 3e-6
EAGER = ("max", "v2vnet_max_nogru")


@functools.lru_cache(maxsize=None)
def _fusion_run(name, train):
    """One fusion's forward and gradients in both packages: JAX's
    ``jax.grad`` of sum(out * R) for the parameters and the input, the
    port's backward of the same."""
    make_jax, make_port = FUSIONS[name]
    x, affine = _inputs(3)
    r = np.random.RandomState(4).randn(B, H, W, C).astype(np.float32)
    jm = make_jax()
    args = (jnp.asarray(affine), jnp.asarray(MASK))
    # seeded values on flax's variable tree (flax's eager init of V2X-ViT
    # alone takes 17 s)
    variables = _random_variables(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.asarray(x), *args), 5)
    params = variables.get("params", {})
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss(p, xx):
        out = jm.apply({"params": p, **rest}, xx, *args, train=train,
                       mutable=["batch_stats"] if train else False)
        out = out[0] if train else out
        return (out * r).sum(), out

    grad = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)
    if name not in EAGER:
        grad = jax.jit(grad)
    (_, want), (gp, gx) = grad(params, jnp.asarray(x))
    pm = make_port()
    pm.load_state_dict(flax_to_state_dict(pm, variables), strict=True)
    pm.train(train)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = pm(tx, torch.from_numpy(affine), torch.from_numpy(MASK))
    (out * torch.from_numpy(r)).sum().backward()
    return dict(want=np.asarray(want), got=out.detach().numpy(),
                jgx=np.asarray(gx), gx=tx.grad.numpy(), model=pm,
                jgp=(flax_grads_to_torch(pm, jax.tree_util.tree_map(
                    np.asarray, gp)) if gp else {}),
                variables=variables)


def _grad_close(got, want, what, floor=0.0):
    """|got - want| <= GRAD_TOL x the largest entry of want, taken at no
    less than ``floor``."""
    scale = max(float(np.abs(want).max()), floor)
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * scale,
                               err_msg=what)


CASES = [(n, False) for n in FUSIONS] + [("disconet", True)]
IDS = [n + ("_train" if t else "") for n, t in CASES]


@pytest.mark.parametrize("name,train", CASES, ids=IDS)
def test_fusion_forward_matches_jax(name, train):
    run = _fusion_run(name, train)
    assert run["got"].shape == run["want"].shape == (B, H, W, C)
    _close(run["got"], run["want"], FWD_TOL, name)


@pytest.mark.parametrize("name,train", CASES, ids=IDS)
def test_fusion_gradients_match_jax(name, train):
    run = _fusion_run(name, train)
    _grad_close(run["gx"], run["jgx"], "d input")
    params = dict(run["model"].named_parameters())
    assert set(run["jgp"]) == set(params)
    # a gradient that is zero in exact arithmetic (a bias that shifts every
    # agent's score alike before a softmax over agents: DiscoNet's last
    # conv, Who2com's key, HMSA's k) is the noise of thousands of cancelling
    # terms in both (1.9e-5 against a largest entry of 1e2 for DiscoNet in
    # train mode): a tensor is held at no less than 1e-2 of the largest
    # entry of all the module's gradients
    floor = 1e-2 * max([float(g.abs().max()) for g in run["jgp"].values()],
                       default=0.0)
    for key, want in run["jgp"].items():
        _grad_close(params[key].grad.numpy(), want.numpy(), key, floor)


# ---------------------------------------------------------------- bf16
def _kernel_warp(x, theta):
    """The JAX warp through the Pallas kernel (interpret mode), whose bf16
    contract the port's K3 keeps (the lerp in fp32, rounded once), instead
    of the JAX main path's bf16 gather."""
    lead = x.shape[:-3]
    out = warp_affine_mxu(x.reshape((-1,) + x.shape[-3:]),
                          theta.reshape(-1, 2, 3))
    return out.reshape(lead + out.shape[1:])


def _kernel_warp_to_ego(x, affine):
    b, l, h, w, c = x.shape
    return _kernel_warp(x.reshape(b * l, h, w, c),
                        affine[:, 0].reshape(b * l, 2, 3)).reshape(x.shape)


# one bf16 step (observed 0.009-0.20), two for V2X-ViT's bf16 attention
# (observed 0.88), of max(1, max|out|)
HALF_STEPS = {"max": 1.0, "disconet": 1.0, "who2com": 1.0, "v2xvit": 2.0,
              "cobevt": 1.0, "where2comm": 1.0, "v2vnet": 1.0,
              "v2vnet_max_nogru": 1.0}


@pytest.mark.parametrize("name", list(HALF_STEPS))
def test_fusion_on_a_bf16_map_matches_jax(name, monkeypatch):
    """``half``: the fusion gets the bf16 feature; V2X-ViT is built with
    ``half=True`` (bf16 HMSA and window attention), every other fusion
    computes in the promoted type of the bf16 map and its fp32 parameters,
    in both packages. JAX warps with the Pallas kernel here."""
    for mod in (jax_fusion, jax_v2xvit, jax_cobevt, jax_where2comm):
        monkeypatch.setattr(mod, "warp_to_ego", _kernel_warp_to_ego)
    monkeypatch.setattr(jax_v2vnet, "warp_affine_nhwc", _kernel_warp)
    run = _fusion_run(name, False)
    make_jax, make_port = FUSIONS[name]
    jm, pm = make_jax(), make_port()
    if name == "v2xvit":
        jm, pm = (jax_v2xvit.V2XViTFusion(dim=C, depth=2, half=True),
                  v2xvit.V2XViTFusion(C, depth=2, half=True))
    pm.load_state_dict(flax_to_state_dict(pm, run["variables"]))
    x, affine = _inputs(3)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = jax.jit(jm.apply)(run["variables"], jx, jnp.asarray(affine),
                             jnp.asarray(MASK))
    with torch.inference_mode():
        got = pm(torch.from_numpy(x).to(torch.bfloat16),
                 torch.from_numpy(affine), torch.from_numpy(MASK))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    err = float(np.abs(got - want).max())
    scale = max(1.0, float(np.abs(want).max()))
    assert err <= HALF_STEPS[name] * EPS * scale, (name, err / (EPS * scale))


# ---------------------------------------------------------------- Where2comm
def test_communication_matches_jax():
    """Sigmoid-max confidence, the 5 x 5 Gaussian with zero padding, the
    threshold, the ego forced to 1 and the rate over the whole batch's
    valid neighbours: the same mask and rate."""
    rng = np.random.RandomState(8)
    conf = (2.0 * rng.randn(B, L, H, W, 2)).astype(np.float32)
    jm = jax_where2comm.Communication(thre=0.6)
    jmask, jrate = jm.apply({}, jnp.asarray(conf), jnp.asarray(MASK))
    mask, rate = where2comm.Communication(thre=0.6)(torch.from_numpy(conf),
                                                    torch.from_numpy(MASK))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert 0.2 < float(rate) < 0.8
    np.testing.assert_allclose(float(rate), float(jrate), rtol=1e-6)


# ---------------------------------------------------------------- the model
M1_V2XVIT = "configs/opv2v/gencomm/stage1/m1_v2xvit.yaml"
# a 51.2 x 25.6 m range: a 16 x 32 fused map, which V2X-ViT's windows divide
RANGE16 = [-25.6, -12.8, -3.0, 25.6, 12.8, 1.0]


def narrowed16(config=M1_V2XVIT, **model_args):
    """``test_torch_config.narrowed`` on RANGE16; V2X-ViT at the narrow
    width (dim 32, depth 1); ``model_args`` go into ``model.args``."""
    h = narrowed(config)
    h["cav_lidar_range"] = list(RANGE16)
    h["preprocess"]["cav_lidar_range"] = list(RANGE16)
    h["postprocess"]["gt_range"] = list(RANGE16)
    h["postprocess"]["anchor_args"]["cav_lidar_range"] = list(RANGE16)
    args = h["model"]["args"]
    args["lidar_range"] = list(RANGE16)
    for c in args.values():
        if isinstance(c, dict) and "encoder_args" in c:
            c["encoder_args"]["lidar_range"] = list(RANGE16)
    args["v2xvit"] = {"dim": 32, "depth": 1}
    args.update(model_args)
    return h


def _hypes(raw):
    """(JAX-derived hypes, port-derived hypes) of one raw dict."""
    return (jax_yaml.update_yaml(copy.deepcopy(raw)),
            yaml_utils.update_yaml(copy.deepcopy(raw)))


def _batch(hypes, seed, batch_size):
    """A decorated, labelled frame of the JAX package's sampler on RANGE16:
    2 agents in 3 slots."""
    cfg = JaxSyntheticConfig(
        lidar_range=tuple(RANGE16), max_cav=3, num_agents=2,
        points_per_agent=2000, num_vehicles=6, points_per_vehicle=60,
        comm_range=12.0, modalities={"m1": {"sensor": "lidar"}})
    host = JaxScenes(cfg).sample(seed, batch_size)
    return host_decorate_pillars(trim_agent_slots(host, buckets=(3,)), hypes)


def _variables(jh, batch, seed):
    jmodel = jax_create_model(jh)
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False), {
        "params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        {k: jnp.asarray(v) for k, v in batch.items()})
    return jmodel, _random_variables(shapes, seed)


def _replayed_normal(noises):
    replay = iter(noises)
    return lambda key, shape, dtype=jnp.float32: jnp.asarray(
        next(replay)).reshape(shape).astype(dtype)


SLICES = {
    "m1_v2xvit": {},
    # the Where2comm mask of model.args.communication before generation,
    # at a threshold that sends part of the map
    "where2comm_comm": {"fusion_method": "where2comm",
                        "where2comm": {"feat_dim": 32},
                        "communication": {"thre": 0.42}},
}


@pytest.fixture(scope="module", params=list(SLICES))
def slice_run(request):
    """One eval frame of a narrowed yaml through both packages: the same
    hypes dict, frame, weights and diffusion noise."""
    jh, ph = _hypes(narrowed16(**SLICES[request.param]))
    batch = _batch(jh, seed=3, batch_size=1)
    jmodel, variables = _variables(jh, batch, seed=0)
    n = batch["agent_mask"].size
    rng = np.random.RandomState(7)
    noises = [rng.randn(n, 16, 32, 32).astype(np.float32) for _ in range(3)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", _replayed_normal(noises))
        jout = jax.jit(functools.partial(jmodel.apply, train=False))(
            variables, {k: jnp.asarray(v) for k, v in batch.items()},
            rngs={"diffusion": jax.random.PRNGKey(7)})
    model = create_model(ph, device="cpu")
    model.load_state_dict(flax_to_state_dict(model, variables))
    with torch.inference_mode():
        tout = model(batch_to_device(batch, "cpu"),
                     noises=[torch.from_numpy(z) for z in noises])
    return dict(name=request.param, jh=jh, ph=ph, batch=batch, jout=jout,
                tout=tout)


def test_yaml_built_fusion_slice_matches_jax(slice_run):
    # the tolerance of test_torch_config.py's slice: fp32 sums in other
    # orders through ~40 layers and three UNet passes, 1e-4 of the scale
    for key in ("message", "pred_feature", "feature", "cls_preds",
                "reg_preds", "dir_preds"):
        want = np.asarray(slice_run["jout"][key], np.float32)
        got = slice_run["tout"][key].numpy()
        assert np.abs(want).max() > 0 and got.shape == want.shape, key
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale,
                                   err_msg=key)
    if slice_run["name"] == "where2comm_comm":
        rate = float(slice_run["tout"]["comm_rate"])
        assert 0.05 < rate < 0.95, rate
        np.testing.assert_allclose(rate, float(slice_run["jout"]["comm_rate"]),
                                   rtol=1e-6)


def test_yaml_built_fusion_losses_match_jax(slice_run):
    jout, batch = slice_run["jout"], slice_run["batch"]
    keys = ("cls_preds", "reg_preds", "dir_preds", "gt_feature",
            "pred_feature", "feature_mask")
    out = {k: np.asarray(jout[k]) for k in keys}
    labels = {k: batch[k] for k in ("pos_equal_one", "neg_equal_one",
                                    "targets")}
    want = jax.jit(jax_create_loss(slice_run["jh"]).__call__)(
        {k: jnp.asarray(v) for k, v in out.items()},
        {k: jnp.asarray(v) for k, v in labels.items()})
    got = create_loss(slice_run["ph"])(
        {k: torch.from_numpy(np.array(v)) for k, v in out.items()},
        {k: torch.from_numpy(np.array(v)) for k, v in labels.items()})
    assert set(got) == set(want) and "gen_loss" in got
    # the generation MSE over 49,152 values: the port's lands 1e-7 from the
    # float64 value, JAX's 1.6e-5 (where2comm_comm): held at 1e-4 to JAX's
    # and 1e-6 to the float64 value; every other term at 1e-5 to JAX's
    pred, gt = (out[k].astype(np.float64) for k in ("pred_feature",
                                                     "gt_feature"))
    m = out["feature_mask"].astype(np.float64)[:, None, None, None]
    exact = ((pred - gt) ** 2 * m).sum() / (m.sum() * np.prod(pred.shape[1:]))
    exact *= slice_run["jh"]["loss"]["args"].get("generate_weight", 1.0)
    np.testing.assert_allclose(float(got["gen_loss"]), exact, rtol=1e-6)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-4 if k in ("gen_loss", "total_loss")
                                   else 1e-5, err_msg=k)


# ---------------------------------------------------------------- DiscoNet KD
def _disconet_loss_case():
    """Head outputs, fused features and labels for the DiscoNet loss, and
    its args (kd weight 2.5)."""
    rng = np.random.RandomState(9)
    b, h, w = 2, 8, 16
    out = {"cls_preds": rng.randn(b, h, w, 2), "reg_preds": rng.randn(
        b, h, w, 14), "dir_preds": rng.randn(b, h, w, 4),
        "teacher_feature": 3.0 * rng.randn(b, h, w, 32),
        "student_feature": 3.0 * rng.randn(b, h, w, 32)}
    pos = (rng.rand(b, h, w, 2) < 0.05).astype(np.float32)
    labels = {"pos_equal_one": pos, "neg_equal_one": 1.0 - pos,
              "targets": rng.randn(b, h, w, 14)}
    args = dict(narrowed16()["loss"]["args"], kd={"weight": 2.5})
    return ({k: v.astype(np.float32) for k, v in out.items()},
            {k: v.astype(np.float32) for k, v in labels.items()}, args)


def test_disconet_loss_matches_jax():
    """Detection terms plus the KL of the teacher's channel softmax against
    the student's, torch's elementwise mean over N * H * W * C."""
    out, labels, args = _disconet_loss_case()
    want = jax.jit(JaxDiscoNetLoss(args).__call__)(
        {k: jnp.asarray(v) for k, v in out.items()},
        {k: jnp.asarray(v) for k, v in labels.items()})
    got = PointPillarDiscoNetLoss(args)(
        {k: torch.from_numpy(v) for k, v in out.items()},
        {k: torch.from_numpy(v) for k, v in labels.items()})
    assert set(got) == set(want) and "kd_loss" in got
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_disconet_loss_gradients_match_jax():
    """The total loss's gradient into the student's feature and the heads
    against ``jax.grad``: the kd weight and the KL's reduction reach the
    student's backward as in JAX, and the teacher takes no gradient."""
    out, labels, args = _disconet_loss_case()
    jlabels = {k: jnp.asarray(v) for k, v in labels.items()}
    want = jax.jit(jax.grad(lambda o: JaxDiscoNetLoss(args)(o, jlabels)[
        "total_loss"]))({k: jnp.asarray(v) for k, v in out.items()})
    tout = {k: torch.from_numpy(v).requires_grad_() for k, v in out.items()}
    PointPillarDiscoNetLoss(args)(tout, {
        k: torch.from_numpy(v) for k, v in labels.items()})[
        "total_loss"].backward()
    assert tout["teacher_feature"].grad is None
    assert not np.asarray(want["teacher_feature"]).any()
    for k in ("student_feature", "cls_preds", "reg_preds", "dir_preds"):
        assert np.abs(np.asarray(want[k])).max() > 0, k
        _grad_close(tout[k].grad.numpy(), np.asarray(want[k]), k)


KD_WEIGHT = 1000.0  # the distillation term carries ~30% of the total loss
# the student's gradients of a whole KD step: observed within 0.102 of each
# tensor's largest entry (the deformable conv's offsets; the train-mode
# norms below), held at about twice that; a 10% error in the kd weight
# moves them by 0.080 (scripts/kd_step_drift_torch.py)
KD_GRAD_TOL = 0.2


def _recording(tx):
    """``tx`` whose state also keeps the gradients of its last update."""

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def kd_run():
    """One ``make_kd_train_step`` step of a narrowed DiscoNet GenComm model
    (``point_pillar_disconet_loss``) in both packages: the same batch (2
    samples), student and teacher weights and diffusion noise (both draw
    the same, as both JAX applies take the step's rngs); JAX's gradients
    kept by its optimizer's state."""
    raw = narrowed16(fusion_method="disconet", disconet={"feat_dim": 32})
    # a one-level UNet: the jitted JAX step compiles in half the time
    raw["model"]["args"]["gencomm"]["model"].update(ch_mult=[1],
                                                    num_res_blocks=1)
    raw["loss"]["core_method"] = "point_pillar_disconet_loss"
    raw["loss"]["args"]["kd"] = {"weight": KD_WEIGHT}
    jh, ph = _hypes(raw)
    batch = _batch(jh, seed=5, batch_size=2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel, variables = _variables(jh, batch, seed=0)
    _, teacher_vars = _variables(jh, batch, seed=1)
    tx = _recording(jax_trainer.make_optimizer(jh))
    state = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]))
    rng = np.random.RandomState(11)
    noises = [rng.randn(batch["agent_mask"].size, 16, 32, 32).astype(
        np.float32) for _ in range(3)]
    with pytest.MonkeyPatch.context() as mp:
        # the teacher's three draws, then the student's: the same noises
        mp.setattr(jax.random, "normal", _replayed_normal(noises + noises))
        step = jax_trainer.make_kd_train_step(
            jmodel, jmodel, teacher_vars, jax_create_loss(jh), tx)
        new_state, jlosses = step(state, jbatch, jax.random.PRNGKey(0))
    model, teacher = (create_model(ph, device="cpu") for _ in range(2))
    model.load_state_dict(flax_to_state_dict(model, variables))
    teacher.load_state_dict(flax_to_state_dict(teacher, teacher_vars))
    teacher_start = {k: v.clone() for k, v in teacher.state_dict().items()}
    opt, sched = trainer.make_optimizer(ph, model.named_parameters())
    kd_step = trainer.make_kd_train_step(model, teacher, create_loss(ph), opt,
                                         sched)
    losses = kd_step(batch_to_device(batch, "cpu"),
                     noises=[torch.from_numpy(z) for z in noises])
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    return dict(model=model, teacher=teacher, teacher_start=teacher_start,
                losses=losses, opt=opt,
                jlosses={k: float(v) for k, v in jlosses.items()},
                jgrads=flax_grads_to_torch(model, to_np(
                    new_state.opt_state[1])),
                jstate=flax_to_state_dict(model, {
                    "params": to_np(new_state.params),
                    "batch_stats": to_np(new_state.batch_stats)}))


def test_kd_step_losses_match_jax(kd_run):
    assert set(kd_run["losses"]) == set(kd_run["jlosses"])
    assert "kd_loss" in kd_run["losses"]
    for k, want in kd_run["jlosses"].items():
        # the distillation term within 1e-5 (observed 4.1e-6). The
        # detection terms within 1e-4, as the whole train steps of
        # test_torch_train.py and test_torch_workflow.py hold theirs: the
        # train-mode norms' fast variance E[x^2] - E[x]^2 (flax's, which
        # the port copies), over channels near constant on a sparse canvas,
        # turns the sum-order rounding of a conv (3.5e-7 at the backbone's
        # second conv) into 3.7e-5 at its norm (observed: reg 4.8e-5;
        # scripts/kd_step_drift_torch.py)
        np.testing.assert_allclose(float(kd_run["losses"][k]), want,
                                   rtol=1e-5 if k == "kd_loss" else 1e-4,
                                   err_msg=k)


def test_kd_step_gradients_match_jax(kd_run):
    """The student's gradients before the update against those JAX's step
    hands its optimizer, within KD_GRAD_TOL of each tensor's largest entry;
    a tensor whose gradient is zero in exact arithmetic (the denoiser's,
    with no generation loss; the bias of DiscoNet's last conv, shared by
    every agent's score) at no less than 1e-2 of the largest entry of
    all (as test_fusion_gradients_match_jax)."""
    params = dict(kd_run["model"].named_parameters())
    jgrads = kd_run["jgrads"]
    assert set(jgrads) == set(params)
    top = max(float(g.abs().max()) for g in jgrads.values())
    for k, want in jgrads.items():
        want = want.numpy()
        scale = max(float(np.abs(want).max()), 1e-2 * top)
        np.testing.assert_allclose(params[k].grad.numpy(), want, rtol=0,
                                   atol=KD_GRAD_TOL * scale, err_msg=k)


def test_kd_step_update_matches_jax_and_leaves_the_teacher(kd_run):
    """The student's parameters and running statistics after the step
    against JAX's; the teacher (eval mode, no gradient) unchanged."""
    model = kd_run["model"]
    for k, v in kd_run["teacher"].state_dict().items():
        assert torch.equal(v, kd_run["teacher_start"][k]), k
    lr = float(kd_run["opt"].param_groups[0]["lr"])
    params = dict(model.named_parameters())
    top = max(float(p.grad.abs().max()) for p in params.values())
    held = missed = 0
    for k, v in model.state_dict().items():
        got, want = v.numpy(), kd_run["jstate"][k].numpy()
        if k not in params:  # running statistics
            _close(got, want, 1e-4, k)
            continue
        # Adam's first step moves a weight by ~lr * sign(grad), so the sign
        # of a gradient decides it (its magnitude is held by
        # test_kd_step_gradients_match_jax); where a gradient is above 5e-2
        # of its tensor's largest entry, 99.9% of the updates are held
        # within 1e-5, everywhere within 2 lr
        g = params[k].grad.numpy()
        if np.abs(g).max() > 1e-4 * top:
            settled = np.abs(g) > 5e-2 * np.abs(g).max()
            held += int(settled.sum())
            missed += int((np.abs(got - want)[settled] > 1e-5).sum())
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 * lr + 1e-6,
                                   err_msg=k)
    assert held > 0.2 * sum(p.numel() for p in params.values()), held
    assert missed <= 1e-3 * held, (missed, held)


# ---------------------------------------------------------------- faults
def test_fault_i_v2xvit_reads_neither_heads_nor_window_size():
    """Suspected reference fault i (ROADMAP section 3): stage1/m1_v2xvit.yaml
    asks for ``heads: 4`` and ``window_size: 4``; ``build_fusion`` reads
    neither, in both packages, so V2X-ViT runs with 8 HMSA heads and
    windows of 4, 8 and 16 -- the same parameter shapes in both."""
    hypes = yaml_utils.load_yaml(f"{REPO}/{M1_V2XVIT}")
    args = hypes["model"]["args"]
    assert args["v2xvit"]["heads"] == 4 and args["v2xvit"]["window_size"] == 4
    jm = jax_fusion.build_fusion("v2xvit", args)
    x = jnp.zeros((1, 2, 16, 32, 128), jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x,
                            jnp.zeros((1, 2, 2, 2, 3)), jnp.ones((1, 2), bool))
    port = fusion.build_fusion("v2xvit", args, in_ch=128)
    sd = flax_to_state_dict(port, jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    assert {k: v.shape for k, v in sd.items()} == {
        k: v.shape for k, v in port.state_dict().items()}
    for d in range(2):  # depth 2 is read
        assert sd[f"d{d}b0_hmsa.relation_att"].shape == (4, 8, 32, 32)
        assert [sd[f"d{d}b0_mswin.wmsa{i}.rel_pos"].shape[0]
                for i in range(3)] == [7, 15, 31]
    assert "d2_ff1.weight" not in sd


def test_fault_j_cobevt_table_is_sized_by_the_initialising_batch():
    """Suspected reference fault j (ROADMAP section 3): CoBEVT's
    ``agent_size`` is never read; ``rel_pos_bias`` is sized by the L of the
    batch that initialises the model, so the JAX model refuses a batch of
    another L. The port, built for an L, refuses it too."""
    jm = jax_cobevt.CoBEVTFusion(input_dim=16, mlp_dim=32, dim_head=8,
                                 window_size=8, agent_size=5)

    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 3, 16, 32, 16)),
                            jnp.zeros((1, 3, 3, 2, 3)), jnp.ones((1, 3), bool))
    variables = _random_variables(shapes, 0)
    table = variables["params"]["block0"]["window"]["rel_pos_bias"]
    assert table.shape == (5 * 15 * 15, 2)  # (2L - 1)(2ws - 1)^2 at L = 3
    x2 = np.random.RandomState(0).randn(1, 2, 16, 32, 16).astype(np.float32)
    affine2 = np.tile(np.eye(2, 3, dtype=np.float32), (1, 2, 2, 1, 1))
    with pytest.raises(Exception, match="rel_pos_bias"):
        jax.eval_shape(jm.apply, variables, jnp.asarray(x2),
                       jnp.asarray(affine2), jnp.ones((1, 2), bool))
    port = cobevt.CoBEVTFusion(16, 3, mlp_dim=32, dim_head=8, window_size=8,
                               agent_size=5)
    port.load_state_dict(flax_to_state_dict(port, variables))
    with pytest.raises(ValueError, match="agent count"):
        port(torch.from_numpy(x2), torch.from_numpy(affine2),
             torch.ones((1, 2), dtype=torch.bool))
    assert port.fixed_agent_slots == 3


def test_models_name_the_agent_buckets_the_clis_trim_to():
    """A CoBEVT model keeps the untrimmed agent-slot count of its config
    (``train_params.max_cav``, as the JAX CLI initialises from), so the
    train and inference CLIs trim its batches to that count alone; the
    other fusions take the buckets (2, 3, 5)."""
    for method, want in (("cobevt", (4,)), ("v2xvit", (2, 3, 5))):
        raw = narrowed16(fusion_method=method, cobevt={
            "input_dim": 32, "mlp_dim": 32, "dim_head": 8, "window_size": 8})
        raw["train_params"]["max_cav"] = 4
        model = create_model(_hypes(raw)[1], device="cpu")
        assert model.agent_buckets == want, method


def test_fault_k_dairv2x_v2xvit_map_is_not_divided_by_its_windows():
    """Suspected reference fault k (ROADMAP section 3): DAIR-V2X's
    stage1/m1_v2xvit.yaml gives a 50 x 126 fused map (a 201.6 x 80 m range
    at 0.4 m, stride 4), which V2X-ViT's windows of 4, 8 and 16 do not
    divide: the JAX fusion fails in its window partition, and the port
    refuses the map with the reason."""
    hypes = yaml_utils.load_yaml(f"{REPO}/configs/dairv2x/gencomm/stage1/"
                                 "m1_v2xvit.yaml")
    lr = hypes["model"]["args"]["lidar_range"]
    vs = hypes["model"]["args"]["m1"]["encoder_args"]["voxel_size"]
    h, w = (round((lr[4] - lr[1]) / vs[1]) // 4,
            round((lr[3] - lr[0]) / vs[0]) // 4)
    assert (h, w) == (50, 126)
    args = hypes["model"]["args"]
    jm = jax_fusion.build_fusion("v2xvit", args)
    x = jnp.zeros((1, 2, h, w, 128), jnp.float32)
    affine = np.tile(np.eye(2, 3, dtype=np.float32), (1, 2, 2, 1, 1))
    with pytest.raises(TypeError, match="reshape"):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), x,
                       jnp.asarray(affine), jnp.ones((1, 2), bool))
    port = fusion.build_fusion("v2xvit", args, in_ch=128)
    with pytest.raises(ValueError, match="divide the fused map, 50 x 126"):
        port(torch.zeros(1, 2, h, w, 128), torch.from_numpy(affine),
             torch.ones((1, 2), dtype=torch.bool))


def test_train_cli_trains_v2xvit_and_distils(tmp_path, capsys):
    """``tools.train`` on a narrowed stage1/m1_v2xvit.yaml, and the same
    yaml with DiscoNet fusion as a teacher run, then ``--trainer kd
    --teacher_ckpt`` from it: the plain GenComm criterion is upgraded to
    ``PointPillarDiscoNetLoss``, whose KD term is logged."""
    base = ["--dataset", "synthetic", "--steps_per_epoch", "1",
            "--val_steps", "0", "--epochs", "1", "--device", "cpu"]
    runs = {}
    for name, raw in (("v2xvit", narrowed16()), ("disconet", narrowed16(
            fusion_method="disconet", disconet={"feat_dim": 32}))):
        y = tmp_path / f"{name}.yaml"
        y.write_text(yaml.safe_dump(raw))
        runs[name] = (str(y), str(tmp_path / name))
        train_cli.main(["-y", str(y), "--model_dir", runs[name][1]] + base)
        out = capsys.readouterr().out
        assert "[epoch 0][0]" in out and "training done" in out
        assert checkpoint.load_checkpoint(
            f"{runs[name][1]}/step_1")["step"] == 1
    y, teacher = runs["disconet"]
    student = str(tmp_path / "kd")
    train_cli.main(["-y", y, "--model_dir", student, "--trainer", "kd",
                    "--teacher_ckpt", teacher] + base)
    out = capsys.readouterr().out
    assert "upgraded criterion to PointPillarDiscoNetLoss" in out
    assert f"teacher from {teacher}" in out and "kd_loss=" in out
