"""bf16 eval (``half=True``) of the port against the JAX package, on the CPU.

The same numpy inputs, made from a seed, and the same weights (carried by
``weights.py``) go through the JAX package with ``dtype=jnp.bfloat16`` /
``half=True`` and through the port. First the plain versions of the two
kernels that take bf16 maps under ``half`` (K1, the deformable conv, and
K3, the BEV warp) against the Pallas kernels in interpret mode, as
``tests/test_deform_pallas.py`` and ``tests/test_warp_pallas.py`` run them;
then each module; then the lidar slice (the tiny config of
``tests/test_half_inference.py``) and a small ``m2_att``-shaped camera
slice as a whole. The kernels' CUDA halves are in ``test_torch_kernels.py``.

Tolerances are stated in bf16 units: ``EPS = 2**-7`` is the spacing of bf16
values in [1, 2), so one rounding moves a value by at most EPS / 2 of its
magnitude. The port rounds where flax and JAX round (a bf16 product before
its bias, a norm once, GELU and sigmoid as JAX composes them, Python
constants rounded to bf16), so most modules agree bit for bit; a sum taken
in another order may still land on the other side of a rounding midpoint,
one bf16 step of the output's largest value, which later layers carry
along. Where the contracts differ (the JAX gather warp's bf16 lerp, the JAX
CPU path's fp32 deformable conv) the tests say by how much. Each test
states its tolerance and what was observed.
"""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import pytest
import torch

from gencomm_tpu.models import layers as jax_layers
from gencomm_tpu.models.backbones.bev_backbone import BEVBackbone as JBackbone
from gencomm_tpu.models.encoders.point_pillar import (
    PointPillarEncoder as JEncoder,
)
from gencomm_tpu.models.fuse import fusion as jax_fusion
from gencomm_tpu.models.gencomm import message_extractor as jax_extractor
from gencomm_tpu.models.gencomm.diffusion import (
    GenCommDiffusion as JDiffusion,
)
from gencomm_tpu.models.gencomm.enhancer import Enhancer as JEnhancer
from gencomm_tpu.models.gencomm.unet import DiffusionUNet as JUNet
from gencomm_tpu.models.heter_baseline import HeterModel as JaxHeterModel
from gencomm_tpu.ops.deform_pallas import MAX_OFFSET, deform_conv3x3_mxu
from gencomm_tpu.ops.warp import warp_affine_nhwc
from gencomm_tpu.ops.warp_pallas import warp_affine_mxu

from gencomm_tpu_torch.data.bucketing import trim_agent_slots
from gencomm_tpu_torch.data.decorate import decorate_modality
from gencomm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from gencomm_tpu_torch.models import layers
from gencomm_tpu_torch.models.backbones.bev_backbone import BEVBackbone
from gencomm_tpu_torch.models.encoders.point_pillar import PointPillarEncoder
from gencomm_tpu_torch.models.fuse.fusion import AttFusion
from gencomm_tpu_torch.models.gencomm.diffusion import GenCommDiffusion
from gencomm_tpu_torch.models.gencomm.enhancer import Enhancer
from gencomm_tpu_torch.models.gencomm.message_extractor import MessageExtractor
from gencomm_tpu_torch.models.gencomm.unet import DiffusionUNet
from gencomm_tpu_torch.models.heter_baseline import HeterModel
from gencomm_tpu_torch.native import PillarVoxelizer
from gencomm_tpu_torch.ops.deform_conv import (
    clamp_offsets, deform_conv3x3, deform_conv3x3_plain,
)
from gencomm_tpu_torch.ops.warp import warp_affine, warp_affine_plain
from gencomm_tpu_torch.pipeline import InferencePipeline, batch_to_device
from gencomm_tpu_torch.weights import flax_to_state_dict

from tests import test_torch_camera as camera
from tests.test_torch_kernels import _t
from tests.test_torch_modules import _carry, _perturb
from tests.test_torch_train import _random_variables

EPS = 2.0 ** -7  # bf16's step in [1, 2)
BF16 = jnp.bfloat16


def _bf16(a):
    """numpy fp32 -> the same bf16 values in both frameworks."""
    return jnp.asarray(a, BF16), _t(np.asarray(a, np.float32)).to(torch.bfloat16)


def _f32(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _err(got, want):
    """(max |got - want|, max |want|) in fp32."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()), float(np.abs(want).max())


def _hold(got, want, steps, what=""):
    """|got - want| <= steps bf16 steps of max(1, max|want|)."""
    err, scale = _err(got, want)
    assert err <= steps * EPS * max(1.0, scale), (what, err, scale)


def _perturbed(variables, seed):
    """Variables with biases, scales and statistics off their init values."""
    return _perturb(variables, np.random.RandomState(seed))


# ------------------------------------------------------- K1 and K3, bf16
def _deform_case(seed, b, h, w, cin, cout, spread):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    off = (spread * rng.randn(b, h, w, 18)).astype(np.float32)
    wt = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    return x, off, wt


@pytest.mark.parametrize("shape,spread", [
    ((2, 6, 12, 8, 16), 1.5),
    ((1, 11, 9, 32, 64), 3.0),   # the kernel's tensor-core channel counts
    ((1, 13, 10, 16, 8), 6.0),   # most offsets beyond the +-4 clamp
])
def test_deform_plain_bf16_matches_pallas(shape, spread):
    x, off, wt = _deform_case(3, *shape, spread)
    jx, tx = _bf16(x)
    want = deform_conv3x3_mxu(jx, jnp.clip(jnp.asarray(off), -MAX_OFFSET,
                                           MAX_OFFSET), jnp.asarray(wt))
    got = deform_conv3x3_plain(tx, clamp_offsets(_t(off)), _t(wt))
    assert want.dtype == BF16 and got.dtype == torch.bfloat16
    # both sample and contract in fp32 (interpret mode runs the Pallas dots
    # in fp32) and round once: the sums' orders differ, so an output next
    # to a rounding midpoint may land one bf16 step apart
    _hold(got, want, 1.0)
    # and the CPU wrapper takes the plain version for a bf16 map
    np.testing.assert_array_equal(
        _f32(deform_conv3x3(tx, clamp_offsets(_t(off)), _t(wt))), _f32(got))


def _thetas(n, seed):
    """n affines of the kind poses give (rotations and shifts), plus a zoom
    and a shear."""
    rng = np.random.RandomState(seed)
    ang = rng.uniform(-np.pi, np.pi, n)
    th = np.zeros((n, 2, 3), np.float32)
    th[:, 0, 0], th[:, 0, 1] = np.cos(ang), -np.sin(ang)
    th[:, 1, 0], th[:, 1, 1] = np.sin(ang), np.cos(ang)
    th[:, :, 2] = rng.uniform(-0.7, 0.7, (n, 2))
    th[0, :, :2] = [[0.5, 0.0], [0.0, 0.5]]
    th[1, :, :2] = [[1.0, 0.4], [0.2, 1.1]]
    return th


WARP_SHAPES = [(10, 8, 12, 8), (10, 16, 12, 16), (10, 9, 20, 24)]


@pytest.mark.parametrize("shape", WARP_SHAPES)
def test_warp_plain_bf16_matches_pallas(shape):
    rng = np.random.RandomState(4)
    src = rng.randn(*shape).astype(np.float32)
    theta = _thetas(shape[0], 5)
    jsrc, tsrc = _bf16(src)
    want = warp_affine_mxu(jsrc, jnp.asarray(theta))
    got = warp_affine_plain(tsrc, _t(theta))
    assert want.dtype == BF16 and got.dtype == torch.bfloat16
    # one fp32 lerp (interpret mode runs the kernel's HIGHEST dot in fp32,
    # one block of source rows at these sizes) and one rounding on both
    # sides: at most one bf16 step apart
    _hold(got, want, 1.0)
    np.testing.assert_array_equal(_f32(warp_affine(tsrc, _t(theta))),
                                  _f32(got))


@pytest.mark.parametrize("shape", WARP_SHAPES)
def test_warp_plain_bf16_against_the_jax_gather(shape):
    rng = np.random.RandomState(6)
    src = rng.randn(*shape).astype(np.float32)
    theta = _thetas(shape[0], 7)
    jsrc, tsrc = _bf16(src)
    want = warp_affine_nhwc(jsrc, jnp.asarray(theta))
    got = warp_affine_plain(tsrc, _t(theta))
    assert want.dtype == BF16
    # the JAX main path's gather rounds each lerp weight, each of the four
    # products and each partial sum to bf16 (seven roundings of values up
    # to max|src|, mostly smaller), where the port rounds once: held to 2
    # bf16 steps (observed 0.53-0.57)
    _hold(got, want, 2.0)


# ---------------------------------------------------------------- layers
def _layer_case(name):
    """(flax module, port module, input shape, input scale)."""
    bf = torch.bfloat16
    return {
        "conv": (fnn.Conv(12, (3, 3), padding="SAME", dtype=BF16),
                 layers.Conv(8, 12, 3, dtype=bf), (2, 7, 9, 8)),
        "conv_stride2": (fnn.Conv(6, (3, 3), strides=(2, 2), padding="SAME",
                                  dtype=BF16),
                         layers.Conv(8, 6, 3, 2, dtype=bf), (2, 8, 10, 8)),
        "dense": (fnn.Dense(10, dtype=BF16), layers.Dense(6, 10, dtype=bf),
                  (3, 5, 6)),
        "batchnorm": (fnn.BatchNorm(use_running_average=True, momentum=0.99,
                                    epsilon=1e-3, dtype=BF16),
                      layers.BatchNorm(8, dtype=bf), (2, 5, 6, 8)),
        "groupnorm": (fnn.GroupNorm(num_groups=4, epsilon=1e-6, dtype=BF16),
                      layers.GroupNorm(4, 8, dtype=bf), (2, 5, 6, 8)),
        "layernorm": (fnn.LayerNorm(dtype=BF16),
                      layers.LayerNorm(8, dtype=bf), (2, 5, 6, 8)),
        "convbnrelu": (jax_layers.ConvBNReLU(12, 3, 2, torch_pad=True,
                                             dtype=BF16),
                       layers.ConvBNReLU(8, 12, 3, 2, torch_pad=True,
                                         dtype=bf), (2, 8, 10, 8)),
        "deconvbnrelu": (jax_layers.DeconvBNReLU(6, 2, dtype=BF16),
                         layers.DeconvBNReLU(8, 6, 2, dtype=bf),
                         (2, 4, 5, 8)),
        "downsample": (jax_layers.DownsampleConv((8, 6), (3, 3), (2, 1),
                                                 dtype=BF16),
                       layers.DownsampleConv(8, (8, 6), (3, 3), (2, 1),
                                             dtype=bf), (2, 8, 10, 8)),
    }[name]


@pytest.mark.parametrize("name", ["conv", "conv_stride2", "dense",
                                  "batchnorm", "groupnorm", "layernorm",
                                  "convbnrelu", "deconvbnrelu", "downsample"])
def test_layer_bf16_matches_flax(name):
    jmod, tmod, shape = _layer_case(name)
    rng = np.random.RandomState(8)
    x = (1.5 * rng.randn(*shape) + 0.3).astype(np.float32)
    jx, tx = _bf16(x)
    variables = _perturbed(jmod.init(jax.random.PRNGKey(0), jx), 9)
    want = jmod.apply(variables, jx)
    with torch.inference_mode():
        got = _carry(variables, tmod)(tx)
    assert want.dtype == BF16 and got.dtype == torch.bfloat16
    # both compute each layer in fp32 from the same bf16 values and round
    # where flax rounds (a product, then its bias; a norm once), so they
    # agree bit for bit unless a sum taken in another order lands on the
    # other side of a rounding midpoint: one bf16 step (observed 0)
    _hold(got, want, 1.0, name)


def test_bf16_input_promotes_in_an_fp32_layer():
    # flax's promote_dtype: a layer without dtype computes in fp32 on a bf16
    # input (the message extractor's convs under half); PyTorch's conv2d
    # would refuse the mix, the port's Conv promotes
    rng = np.random.RandomState(10)
    x = rng.randn(2, 6, 7, 8).astype(np.float32)
    jx, tx = _bf16(x)
    for jmod, tmod in ((fnn.Conv(5, (3, 3), padding="SAME"),
                        layers.Conv(8, 5, 3)),
                       (fnn.Dense(5), layers.Dense(8, 5)),
                       (fnn.LayerNorm(), layers.LayerNorm(8))):
        variables = _perturbed(jmod.init(jax.random.PRNGKey(1), jx), 11)
        want = jmod.apply(variables, jx)
        with torch.inference_mode():
            got = _carry(variables, tmod)(tx)
        assert want.dtype == jnp.float32 and got.dtype == torch.float32
        # fp32 on both sides from the same bf16 values
        _hold(got, want, 1e-3, type(tmod).__name__)


# ---------------------------------------------------- encoder and neck
LR = (-16.0, -8.0, -3.0, 16.0, 8.0, 1.0)
VOXEL = (0.4, 0.4, 4.0)


def test_point_pillar_encoder_bf16_matches_jax():
    rng = np.random.RandomState(12)
    b, l, p = 1, 2, 1500
    pts = np.stack([rng.uniform(-17, 17, (b * l, p)),
                    rng.uniform(-9, 9, (b * l, p)),
                    rng.uniform(-3.5, 1.5, (b * l, p)),
                    rng.rand(b * l, p)], -1).astype(np.float32)
    f, g, v = PillarVoxelizer(LR, VOXEL).decorate_batch(pts)
    f, g, v = (a.reshape((b, l) + a.shape[1:]) for a in (f, g, v))
    jenc = JEncoder(voxel_size=VOXEL, lidar_range=LR, num_filters=(16,),
                    dtype=BF16)
    kw = dict(decorated=jnp.asarray(f), gids=jnp.asarray(g),
              dvalid=jnp.asarray(v))
    variables = _perturbed(jenc.init(jax.random.PRNGKey(0), None, None,
                                     False, **kw), 13)
    want = jenc.apply(variables, None, None, False, **kw)
    enc = _carry(variables, PointPillarEncoder(VOXEL, LR, (16,),
                                               dtype=torch.bfloat16))
    assert enc.PFNLayer_0.Dense_0.dtype == torch.bfloat16
    with torch.inference_mode():
        got = enc(_t(f), _t(g), _t(v))
    assert want.dtype == BF16 and got.dtype == torch.bfloat16
    # the PFN's bf16 Linear (10 products in fp32, rounded), the fp32 norm
    # rounded back to bf16, ReLU, the max: the same roundings on both
    # sides, one step where a sum order crosses a midpoint (observed 0.10)
    _hold(got, want, 1.0)
    assert (got.float() > 0).any()


def test_neck_and_shrinker_bf16_match_jax():
    rng = np.random.RandomState(14)
    # a bf16 canvas, as the lidar encoder gives it
    x = np.abs(rng.randn(2, 16, 32, 8)).astype(np.float32)
    jx, tx = _bf16(x)
    bargs = dict(layer_nums=(1, 1), layer_strides=(2, 2), num_filters=(8, 16),
                 upsample_strides=(1, 2), num_upsample_filters=(8, 8))
    jb = JBackbone(**bargs, dtype=BF16)
    bvars = _perturbed(jb.init(jax.random.PRNGKey(1), jx), 15)
    jfeat = jb.apply(bvars, jx)
    js = jax_layers.DownsampleConv(dims=(16,), kernels=(3,), strides=(2,),
                                   dtype=BF16)
    svars = _perturbed(js.init(jax.random.PRNGKey(2), jfeat), 16)
    want = js.apply(svars, jfeat)
    bb = _carry(bvars, BEVBackbone(8, **bargs, dtype=torch.bfloat16))
    sh = _carry(svars, layers.DownsampleConv(16, (16,), (3,), (2,),
                                             dtype=torch.bfloat16))
    with torch.inference_mode():
        feat = bb(tx)
        got = sh(feat)
    assert jfeat.dtype == BF16 and feat.dtype == torch.bfloat16
    assert want.dtype == BF16 and got.dtype == torch.bfloat16
    # six bf16 layers (with a deconvolution and a concatenation), then two
    # more, rounded where flax rounds: a step taken at one layer where a
    # sum order crosses a midpoint is carried through the next ones, so 2
    # steps (observed 0, bit for bit)
    _hold(feat, jfeat, 2.0, "backbone")
    _hold(got, want, 2.0, "shrinker")


# ------------------------------------------------------- message extractor
def _pallas_auto(x, offsets, weight, bias=None):
    """The TPU branch of ``deform_conv3x3_auto`` (``ops/deform_pallas.py``):
    the Pallas kernel, here in interpret mode."""
    out = deform_conv3x3_mxu(x, jnp.clip(offsets, -MAX_OFFSET, MAX_OFFSET),
                             weight)
    return out + bias if bias is not None else out


@pytest.mark.parametrize("jax_path", ["kernel", "cpu_gather"])
def test_message_extractor_bf16_matches_jax(jax_path, monkeypatch):
    rng = np.random.RandomState(17)
    x = rng.randn(2, 10, 20, 32).astype(np.float32)
    jx, tx = _bf16(x)
    jm = jax_extractor.MessageExtractor(in_ch=32, out_ch=2)
    variables = _perturbed(jm.init(jax.random.PRNGKey(3), jx), 18)
    # offsets of several pixels, many beyond the +-4 px clamp
    variables["params"]["offset"]["bias"] = (
        6.0 * rng.randn(18).astype(np.float32))
    if jax_path == "kernel":
        monkeypatch.setattr(jax_extractor, "deform_conv3x3_auto",
                            _pallas_auto)
    want = jm.apply(variables, jx)
    m = _carry(variables, MessageExtractor(32, 2))
    with torch.inference_mode():
        got = m(tx)
    # on a bf16 feature the offset conv promotes to fp32, the deformable
    # conv returns bf16 (the kernel's contract) and its bias and the SE and
    # fuse convs promote again: the message is fp32
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    # the same contract ("kernel"): the deformable conv's bf16 output may
    # differ by one step where the sums' orders round differently, which
    # the 1x1 convs (64 channels) carry to the message (observed 0.02);
    # the JAX CPU path (the gather, ops/deform.py) keeps the deformable
    # conv's output in fp32 where the port rounds it to bf16 (half a step
    # of each of 64 values), carried through the SE gate and two 1x1 convs
    # (observed 0.19): one step either way
    _hold(got, want, 1.0)


# ---------------------------------------------------------- generation
def test_diffusion_unet_bf16_matches_jax():
    rng = np.random.RandomState(19)
    x = rng.randn(2, 10, 20, 18).astype(np.float32)
    t = np.array([2, 0], np.int32)
    jx, tx = _bf16(x)
    ju = JUNet(out_ch=16, ch=8, ch_mult=(1, 1), num_res_blocks=2, dtype=BF16)
    variables = _perturbed(ju.init(jax.random.PRNGKey(4), jx,
                                   jnp.asarray(t)), 20)
    want = ju.apply(variables, jx, jnp.asarray(t))
    u = _carry(variables, DiffusionUNet(18, 16, ch=8, dtype=torch.bfloat16))
    with torch.inference_mode():
        got = u(tx, _t(t))
    assert want.dtype == BF16 and got.dtype == torch.bfloat16
    # ~25 bf16 layers (GroupNorms, convs, the timestep MLP, skips), each
    # rounded where flax rounds (swish's sigmoid as XLA expands it); a step
    # where a sum order or a GroupNorm statistic crosses a midpoint is
    # carried through the later layers: 2 steps (observed 0.42)
    _hold(got, want, 2.0)


def test_gencomm_diffusion_bf16_with_the_same_noises(monkeypatch):
    rng = np.random.RandomState(21)
    n, h, w, c = 2, 8, 12, 16
    ego = rng.randn(n, h, w, c).astype(np.float32)
    cond = rng.randn(n, h, w, 2).astype(np.float32)
    noises = [rng.randn(n, h, w, c).astype(np.float32) for _ in range(3)]
    jd = JDiffusion(feat_ch=c, msg_ch=2, num_timesteps=3, unet_ch=8,
                    dtype=BF16)
    jego, tego = _bf16(ego)
    variables = _perturbed(jd.init(
        {"params": jax.random.PRNGKey(5), "diffusion": jax.random.PRNGKey(6)},
        jego, jnp.asarray(cond)), 22)
    monkeypatch.setattr(jax.random, "normal", camera._replayed_normal(noises))
    want = jd.apply(variables, jego, jnp.asarray(cond),
                    rngs={"diffusion": jax.random.PRNGKey(7)})
    gd = _carry(variables, GenCommDiffusion(feat_ch=c, msg_ch=2, unet_ch=8,
                                            dtype=torch.bfloat16))
    with torch.inference_mode():
        got = gd(tego, _t(cond), noises=[_t(z) for z in noises])
    assert want.dtype == BF16 and got.dtype == torch.bfloat16
    # three UNet passes and the bf16 chain between them (fp32 noise cast,
    # the schedule's coefficients rounded to bf16 on both sides, as JAX's
    # weakly typed scalars are): bit for bit on these inputs; a step where
    # a sum order crosses a midpoint would be carried by the chain
    # (test_bf16_generation_amplifies_a_one_step_change), so 4 steps
    _hold(got, want, 4.0)


def test_enhancer_bf16_matches_jax():
    rng = np.random.RandomState(23)
    x = (2.0 * rng.randn(2, 10, 20, 32)).astype(np.float32)
    jx, tx = _bf16(x)
    je = JEnhancer(dim=32, dtype=BF16)
    variables = _perturbed(je.init(jax.random.PRNGKey(5), jx), 24)
    want = je.apply(variables, jx)
    e = _carry(variables, Enhancer(32, dtype=torch.bfloat16))
    with torch.inference_mode():
        got = e(tx)
    assert want.dtype == BF16 and got.dtype == torch.bfloat16
    # two LayerNorms, the FRFN's two Dense, two convs and two tanh-GELUs
    # (composed of bf16 operations as jax.nn.gelu is; the tanh itself may
    # differ in its last fp32 bit), the residuals and the gate: 2 steps
    # (observed 0)
    _hold(got, want, 2.0)


# -------------------------------------------------------------- fusion
def _fusion_case():
    rng = np.random.RandomState(25)
    b, l, h, w, c = 2, 3, 12, 16, 8
    x = rng.randn(b, l, h, w, c).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (b, l, l))
    affine = np.zeros((b, l, l, 2, 3), np.float32)
    affine[..., 0, 0], affine[..., 0, 1] = np.cos(ang), -np.sin(ang)
    affine[..., 1, 0], affine[..., 1, 1] = np.sin(ang), np.cos(ang)
    affine[..., :, 2] = rng.uniform(-0.6, 0.6, (b, l, l, 2))
    mask = np.array([[True, True, False], [True, False, True]])
    return x, affine, mask


def _kernel_warp_to_ego(x, affine):
    """``warp_to_ego`` through the Pallas kernel (interpret mode) instead of
    the JAX main path's gather."""
    b, l, h, w, c = x.shape
    out = warp_affine_mxu(x.reshape(b * l, h, w, c),
                          affine[:, 0].reshape(b * l, 2, 3))
    return out.reshape(x.shape)


@pytest.mark.parametrize("jax_warp", ["kernel", "gather"])
def test_att_fusion_bf16_matches_jax(jax_warp, monkeypatch):
    x, affine, mask = _fusion_case()
    jx, tx = _bf16(x)
    if jax_warp == "kernel":
        monkeypatch.setattr(jax_fusion, "warp_to_ego", _kernel_warp_to_ego)
    want = jax_fusion.AttFusion(feat_dim=8).apply(
        {}, jx, jnp.asarray(affine), jnp.asarray(mask))
    with torch.inference_mode():
        got = AttFusion()(tx, _t(affine), _t(mask))
    # bf16 warp and scores, then (np.sqrt(c) is a float32 numpy scalar) the
    # scaling, the softmax over agents and the weighted sum in fp32
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    # with the kernel's warp: the same bf16 warp up to one step, the
    # scores' 8-term sums rounded to bf16 on both sides (observed 0); with
    # the JAX gather's bf16 lerp (test_warp_plain_bf16_against_the_jax_
    # gather) carried through the weights and the sum (observed 0.96)
    _hold(got, want, 1.0 if jax_warp == "kernel" else 2.0)


# ---------------------------------------------------------------- slices
def _closeness(half, ref):
    """(max |sigmoid(cls) - sigmoid(cls_ref)|, overlap of the top-50 cells)
    of two runs' class logits."""
    p = 1.0 / (1.0 + np.exp(-_f32(half).ravel()))
    q = 1.0 / (1.0 + np.exp(-_f32(ref).ravel()))
    top = len(set(np.argsort(-p)[:50]) & set(np.argsort(-q)[:50]))
    return float(np.abs(p - q).max()), top


def _run_both(jmodel_kw, port_kw, batch, variables, noises):
    """JAX fp32, JAX half and the port's half run of one frame with the
    same weights and noise; returns them and the port's model."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        for half in (False, True):
            mp.setattr(jax.random, "normal", camera._replayed_normal(noises))
            outs["jax_half" if half else "jax_fp32"] = JaxHeterModel(
                **jmodel_kw, half=half).apply(
                variables, jbatch, train=False,
                rngs={"diffusion": jax.random.PRNGKey(7)})
    model = HeterModel(**port_kw, half=True, device="cpu")
    model.load_state_dict(flax_to_state_dict(model, variables))
    tnoises = [_t(z) for z in noises]
    with torch.inference_mode():
        outs["port_half"] = model(batch_to_device(batch, "cpu"),
                                  noises=tnoises)
    return outs, model, tnoises


def _lidar_model_kw():
    from tests.test_half_inference import MODALITY_ARGS

    return dict(modality_args=MODALITY_ARGS, fusion_method="att",
                lidar_range=LR, anchor_number=2, use_gencomm=True,
                use_enhancer=True)


@pytest.fixture(scope="module")
def lidar_slice():
    """The tiny config of tests/test_half_inference.py on one decorated
    frame (the port's entry point takes host-decorated points; the JAX
    model takes the same fields)."""
    from tests.test_half_inference import TINY

    scenes = SyntheticScenes(SyntheticConfig(
        lidar_range=TINY.lidar_range, max_cav=TINY.max_cav,
        num_agents=TINY.num_agents, points_per_agent=TINY.points_per_agent,
        num_vehicles=TINY.num_vehicles,
        points_per_vehicle=TINY.points_per_vehicle,
        comm_range=TINY.comm_range))
    batch = decorate_modality(trim_agent_slots(scenes.sample(seed=0,
                                                             batch_size=1)),
                              PillarVoxelizer(LR, VOXEL))
    kw = _lidar_model_kw()
    jkw = dict(kw, fusion_args={"att": {"feat_dim": 64}}, in_head=64)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(lambda b: JaxHeterModel(**jkw).init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        b, train=False), jbatch)
    variables = _random_variables(shapes, seed=0)
    l = batch["agent_mask"].shape[1]
    rng = np.random.RandomState(7)
    noises = [rng.randn(l, 10, 20, 64).astype(np.float32) for _ in range(3)]
    outs, model, tnoises = _run_both(jkw, kw, batch, variables, noises)
    return SimpleNamespace(scenes=scenes, batch=batch, outs=outs,
                           model=model, noises=tnoises, variables=variables)


@pytest.fixture(scope="module")
def camera_slice():
    """The small camera model of tests/test_torch_camera.py (an m2_att
    shape: LSS, top-K splat, the same neck, generation and fusion), with
    the JAX side splatting through its kernel (``splat_impl: pallas``),
    whose contract the port's K4 follows for bf16 rows."""
    scenes, batch = camera._scene(1)
    kw = camera.MODEL_KW
    jargs = dict(kw["modality_args"]["m1"],
                 encoder_args=dict(camera.ENCODER_ARGS, splat_impl="pallas"))
    jkw = dict(kw, modality_args={"m1": jargs},
               fusion_args={"att": {"feat_dim": 32}}, in_head=32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(lambda b: JaxHeterModel(**jkw).init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        b, train=False), jbatch)
    variables = _random_variables(shapes, seed=0)
    rng = np.random.RandomState(7)
    noises = [rng.randn(2, 8, 8, 32).astype(np.float32) for _ in range(3)]
    outs, model, tnoises = _run_both(jkw, kw, batch, variables, noises)
    return SimpleNamespace(scenes=scenes, batch=batch, outs=outs,
                           model=model, noises=tnoises, variables=variables)


SLICES = ["lidar_slice", "camera_slice"]


@pytest.mark.parametrize("slice_name", SLICES)
def test_half_slice_output_dtypes(slice_name, request):
    run = request.getfixturevalue(slice_name)
    for name in ("jax_half", "port_half"):
        out = run.outs[name]
        to_np = _f32
        # heads in fp32, the generated features in bf16
        for key in ("cls_preds", "reg_preds", "dir_preds"):
            assert str(out[key].dtype).endswith("float32"), (name, key)
            assert np.isfinite(to_np(out[key])).all()
        assert str(out["pred_feature"].dtype).endswith("bfloat16"), name
        assert str(out["gt_feature"].dtype).endswith("bfloat16"), name
        # the message leaves the extractor in fp32
        assert str(out["message"].dtype).endswith("float32"), name
    for key in ("cls_preds", "reg_preds", "dir_preds", "pred_feature"):
        assert run.outs["port_half"][key].shape == run.outs["jax_half"][key].shape


def _rel_mean(a, b):
    a, b = _f32(a), _f32(b)
    return float(np.abs(a - b).mean() / np.abs(b).mean())


@pytest.mark.parametrize("slice_name,key", [
    ("lidar_slice", "cls_preds"), ("lidar_slice", "gt_feature"),
    ("lidar_slice", "message"), ("camera_slice", "gt_feature"),
    ("camera_slice", "message")])
def test_half_slice_is_closer_to_jax_half_than_half_is_to_fp32(
        slice_name, key, request):
    """The port's half run against JAX's, measured against JAX's half run
    against its fp32 run on the same frame. At the heads: max |sigmoid(cls)
    difference| and the top-50 overlap; at a branch's feature and message:
    the mean difference (and, for the lidar slice, the max).

    The camera slice is held at its branch outputs and not at its heads:
    its bf16 trunk's convolutions are summed by oneDNN and by XLA in other
    orders (one-step differences in ~10% of the trunk's outputs), and the
    3-pass bf16 diffusion takes any one-step difference of its inputs to
    its own rounding noise (``test_bf16_generation_amplifies_a_one_step_
    change``), as large as the whole bf16 effect. Its heads are held to
    ``tests/test_half_inference.py``'s bounds
    (``test_camera_half_heads_within_the_jax_half_bounds``)."""
    run = request.getfixturevalue(slice_name)
    port, half, fp32 = (run.outs[k][key] for k in ("port_half", "jax_half",
                                                   "jax_fp32"))
    if key == "cls_preds":
        port_d, port_top = _closeness(port, half)
        bf16_d, bf16_top = _closeness(half, fp32)
        assert port_d < bf16_d, (port_d, bf16_d)
        assert port_top >= bf16_top, (port_top, bf16_top)
        # and within tests/test_half_inference.py's own bounds for JAX's
        # half run against fp32
        assert port_d < 0.12 and port_top >= 35
    else:
        assert _rel_mean(port, half) < _rel_mean(half, fp32)
        if slice_name == "lidar_slice":
            # the camera branch's largest difference is one element's one
            # or two steps in both comparisons (0.0142 against 0.0138 of
            # 1.58 for the feature): only the mean tells them apart there
            assert _err(port, half)[0] <= _err(half, fp32)[0]


def test_camera_half_heads_within_the_jax_half_bounds(camera_slice):
    # tests/test_half_inference.py holds JAX's half run to its fp32 run
    # within 0.12 of sigmoid(cls) and 35 of the top-50 cells; the port's
    # half run is held to JAX's half run by the same bounds
    port_d, port_top = _closeness(camera_slice.outs["port_half"]["cls_preds"],
                                  camera_slice.outs["jax_half"]["cls_preds"])
    assert port_d < 0.12 and port_top >= 35, (port_d, port_top)


def test_bf16_generation_amplifies_a_one_step_change():
    # why a head-level comparison of two bf16 runs measures rounding noise:
    # in JAX alone, moving 10 of the condition's 400 values by one bf16 step
    # moves the generated feature by about as much as bf16 moves it from
    # fp32 (the chain's own rounding noise, re-drawn)
    rng = np.random.RandomState(26)
    n, h, w, c = 2, 10, 20, 64
    ego = rng.randn(n, h, w, c).astype(np.float32)
    cond = (0.1 * rng.randn(n, h, w, 2)).astype(np.float32)
    noises = [rng.randn(n, h, w, c).astype(np.float32) for _ in range(3)]
    moved = cond.copy()
    moved.flat[rng.choice(cond.size, 10, replace=False)] *= 1.0 + EPS
    kw = dict(feat_ch=c, msg_ch=2, num_timesteps=3, unet_ch=8)
    shapes = jax.eval_shape(lambda: JDiffusion(**kw, dtype=BF16).init(
        {"params": jax.random.PRNGKey(5), "diffusion": jax.random.PRNGKey(6)},
        jnp.asarray(ego, BF16), jnp.asarray(cond)))
    variables = _random_variables(shapes, seed=0)

    def generate(cnd, dtype):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "normal", camera._replayed_normal(noises))
            return JDiffusion(**kw, dtype=dtype).apply(
                variables, jnp.asarray(ego, dtype or jnp.float32),
                jnp.asarray(cnd), rngs={"diffusion": jax.random.PRNGKey(7)})

    half = generate(cond, BF16)
    one_step = _rel_mean(generate(moved, BF16), half)
    bf16_effect = _rel_mean(half, generate(cond, None))
    assert one_step > 0.5 * bf16_effect, (one_step, bf16_effect)


@pytest.mark.parametrize("slice_name", SLICES)
def test_half_slice_detections(slice_name, request):
    run = request.getfixturevalue(slice_name)
    post = (camera.POSTPROCESS if slice_name == "camera_slice"
            else dict(camera.POSTPROCESS, gt_range=list(LR)))
    pipe = InferencePipeline(run.model, run.scenes.anchors, post,
                             device="cpu")
    dets = pipe.run(run.batch, noises=run.noises)
    topk = post["nms_topk"]
    assert dets.corners3d.shape == (1, topk, 8, 3)
    assert dets.scores.dtype == torch.float32
    assert torch.isfinite(dets.corners3d[dets.valid]).all()
    assert torch.isfinite(dets.scores).all()


@pytest.mark.parametrize("slice_name", SLICES)
def test_one_state_dict_serves_both_graphs(slice_name, request):
    run = request.getfixturevalue(slice_name)
    kw = (camera.MODEL_KW if slice_name == "camera_slice"
          else _lidar_model_kw())
    fp32 = HeterModel(**kw, device="cpu")
    sd32 = flax_to_state_dict(fp32, run.variables)
    sd16 = run.model.state_dict()
    # the same keys, shapes and fp32 values: weights.py carries one flax
    # tree into both graphs
    assert sorted(sd32) == sorted(sd16)
    for k, v in sd16.items():
        assert v.dtype == torch.float32, k
        assert torch.equal(v, sd32[k]), k


@pytest.mark.parametrize("slice_name", SLICES)
def test_half_backward_raises(slice_name, request):
    run = request.getfixturevalue(slice_name)
    with pytest.raises(NotImplementedError, match="bf16 training"):
        run.model.train()
    # a backward through the bf16 graph reaches the kernels' autograd
    # functions, which take fp32 only
    out = run.model(batch_to_device(run.batch, "cpu"), noises=run.noises)
    with pytest.raises(NotImplementedError, match="bf16 training"):
        out["cls_preds"].sum().backward()


@pytest.mark.parametrize("config", ["m1_att", "m2_att"])
def test_full_width_models_build_at_half(config):
    # the lidar flagship's and the camera path's configs at full width
    # (configs/opv2v/gencomm/stage1/*.yaml) build with half=True: fp32
    # parameters (one state_dict for both graphs), bf16 layers through the
    # neck, generation and the Enhancer, fp32 heads; built, not run (the
    # full-width forwards run in chip_smoke.py)
    import os
    import yaml

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(
            repo, f"configs/opv2v/gencomm/stage1/{config}.yaml")) as fh:
        args = yaml.safe_load(fh)["model"]["args"]
    kw = dict(modality_args={"m1": args["m1"]},
              fusion_method=args["fusion_method"],
              lidar_range=tuple(args["lidar_range"]),
              anchor_number=args["anchor_number"], use_gencomm=True,
              use_enhancer=True, device="cpu")
    half = HeterModel(**kw, half=True)
    assert all(p.dtype == torch.float32 for p in half.parameters())
    assert half.state_dict().keys() == HeterModel(**kw).state_dict().keys()
    branch = half.branch_m1
    assert branch.backbone.block0_0.Conv_0.dtype == torch.bfloat16
    assert branch.shrinker.DoubleConv_0.Conv_1.dtype == torch.bfloat16
    assert half.gencomm.denoiser.conv_out.dtype == torch.bfloat16
    assert half.enhancer.block_1.mlp.linear2.dtype == torch.bfloat16
    assert half.heads.cls_head.dtype is None
    if config == "m2_att":
        assert branch.encoder.cam_encode.dtype == torch.bfloat16
        assert branch.encoder.splat_bf16
    else:
        assert branch.encoder.PFNLayer_0.Dense_0.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="bf16 training"):
        half.train()
