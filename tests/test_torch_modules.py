"""Each ported module against its JAX counterpart, on the CPU.

Flax modules are initialised on the CPU, their variables perturbed (so
biases and batch-norm statistics are not at their identity values) and
carried into the port by ``weights.flax_to_state_dict``; the same numpy
inputs then go through both.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gencomm_tpu.data.postprocessor import decode_and_nms as jax_decode
from gencomm_tpu.models.backbones.bev_backbone import BEVBackbone as JBackbone
from gencomm_tpu.models.encoders.point_pillar import (
    PointPillarEncoder as JEncoder,
)
from gencomm_tpu.models.fuse.fusion import AttFusion as JAttFusion
from gencomm_tpu.models.gencomm.enhancer import Enhancer as JEnhancer
from gencomm_tpu.models.gencomm.message_extractor import (
    MessageExtractor as JExtractor,
)
from gencomm_tpu.models.gencomm.unet import DiffusionUNet as JUNet
from gencomm_tpu.models.heads import DetectionHeads as JHeads
from gencomm_tpu.models.layers import DownsampleConv as JShrink

from gencomm_tpu_torch.data.postprocessor import (
    decode_and_nms, generate_anchor_box,
)
from gencomm_tpu_torch.models.backbones.bev_backbone import BEVBackbone
from gencomm_tpu_torch.models.encoders.point_pillar import PointPillarEncoder
from gencomm_tpu_torch.models.fuse.fusion import AttFusion
from gencomm_tpu_torch.models.gencomm.enhancer import Enhancer
from gencomm_tpu_torch.models.gencomm.message_extractor import MessageExtractor
from gencomm_tpu_torch.models.gencomm.unet import DiffusionUNet
from gencomm_tpu_torch.models.heads import DetectionHeads
from gencomm_tpu_torch.models.layers import DownsampleConv
from gencomm_tpu_torch.native import PillarVoxelizer
from gencomm_tpu_torch.weights import flax_to_state_dict

LR = (-16.0, -8.0, -3.0, 16.0, 8.0, 1.0)
VOXEL = (0.4, 0.4, 4.0)


def _perturb(tree, rng):
    """Copy of a variables tree with biases, scales and BN statistics moved
    off their init values."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
            continue
        v = np.array(v, np.float32)
        n = rng.randn(*v.shape).astype(np.float32)
        out[k] = {"bias": v + 0.1 * n, "mean": v + 0.1 * n,
                  "scale": v + 0.1 * n,
                  "var": v + 0.2 * np.abs(n)}.get(k, v)
    return out


def _carry(variables, port_module):
    port_module.load_state_dict(flax_to_state_dict(port_module, variables),
                                strict=True)
    return port_module


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def test_point_pillar_encoder_decorated():
    rng = np.random.RandomState(0)
    b, l, p = 1, 2, 1500
    pts = np.stack([rng.uniform(-17, 17, (b * l, p)),
                    rng.uniform(-9, 9, (b * l, p)),
                    rng.uniform(-3.5, 1.5, (b * l, p)),
                    rng.rand(b * l, p)], -1).astype(np.float32)
    f, g, v = PillarVoxelizer(LR, VOXEL).decorate_batch(pts)
    f, g, v = (a.reshape((b, l) + a.shape[1:]) for a in (f, g, v))
    jenc = JEncoder(voxel_size=VOXEL, lidar_range=LR, num_filters=(16,))
    variables = jenc.init(jax.random.PRNGKey(0), None, None, False,
                          decorated=jnp.asarray(f), gids=jnp.asarray(g),
                          dvalid=jnp.asarray(v))
    variables = _perturb(variables, rng)
    want = jenc.apply(variables, None, None, False, decorated=jnp.asarray(f),
                      gids=jnp.asarray(g), dvalid=jnp.asarray(v))
    enc = _carry(variables, PointPillarEncoder(VOXEL, LR, (16,)))
    with torch.inference_mode():
        got = enc(torch.from_numpy(f), torch.from_numpy(g), torch.from_numpy(v))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    # the bf16 canvas may differ by one bf16 ulp (at most 2^-7 relative)
    # where the fp32 PFN values round to either side of a bf16 midpoint
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=0)
    assert (got.float() > 0).any()


def test_backbone_and_shrinker_on_even_grid():
    rng = np.random.RandomState(1)
    # 32 x 64 canvas: every stride-2 conv sees an even axis, where flax
    # "SAME" pads (0, 1) in the shrinker and torch_pad (1, 1) in the stems
    x = np.abs(rng.randn(2, 32, 64, 8)).astype(np.float32)
    bargs = dict(layer_nums=(1, 1, 1), layer_strides=(2, 2, 2),
                 num_filters=(8, 16, 16), upsample_strides=(1, 2, 4),
                 num_upsample_filters=(8, 8, 8))
    jb = JBackbone(**bargs)
    bvars = _perturb(jb.init(jax.random.PRNGKey(1), jnp.asarray(x)), rng)
    jfeat = jb.apply(bvars, jnp.asarray(x))
    js = JShrink(dims=(16,), kernels=(3,), strides=(2,))
    svars = _perturb(js.init(jax.random.PRNGKey(2), jfeat), rng)
    want = js.apply(svars, jfeat)

    bb = _carry(bvars, BEVBackbone(8, **bargs))
    sh = _carry(svars, DownsampleConv(bb.out_channels, (16,), (3,), (2,)))
    with torch.inference_mode():
        feat = bb(torch.from_numpy(x))
        got = sh(feat)
    _close(feat, jfeat, 1e-5)
    _close(got, want, 1e-5)
    assert got.shape == (2, 8, 16, 16)


def test_message_extractor_with_offsets_beyond_clamp():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 10, 20, 16).astype(np.float32)
    jm = JExtractor(in_ch=16, out_ch=2)
    variables = _perturb(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)), rng)
    # offsets of several pixels, many beyond the ±4 px clamp
    variables["params"]["offset"]["bias"] = (
        6.0 * rng.randn(18).astype(np.float32))
    want = jm.apply(variables, jnp.asarray(x))
    m = _carry(variables, MessageExtractor(16, 2))
    with torch.inference_mode():
        got = m(torch.from_numpy(x))
    _close(got, want, 1e-5)


def test_diffusion_unet():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 10, 20, 18).astype(np.float32)
    t = np.array([2, 0], np.int32)
    ju = JUNet(out_ch=16, ch=8, ch_mult=(1, 1), num_res_blocks=2)
    variables = _perturb(ju.init(jax.random.PRNGKey(4), jnp.asarray(x),
                                 jnp.asarray(t)), rng)
    want = ju.apply(variables, jnp.asarray(x), jnp.asarray(t))
    u = _carry(variables, DiffusionUNet(18, 16, ch=8))
    with torch.inference_mode():
        got = u(torch.from_numpy(x), torch.from_numpy(t))
    _close(got, want, 1e-5)


def test_enhancer():
    rng = np.random.RandomState(4)
    x = (2.0 * rng.randn(2, 10, 20, 32)).astype(np.float32)
    je = JEnhancer(dim=32)
    variables = _perturb(je.init(jax.random.PRNGKey(5), jnp.asarray(x)), rng)
    want = je.apply(variables, jnp.asarray(x))
    e = _carry(variables, Enhancer(32))
    with torch.inference_mode():
        got = e(torch.from_numpy(x))
    _close(got, want, 1e-5)


def test_att_fusion_with_masked_agent():
    rng = np.random.RandomState(5)
    b, l, h, w, c = 2, 3, 12, 16, 8
    x = rng.randn(b, l, h, w, c).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (b, l, l))
    affine = np.zeros((b, l, l, 2, 3), np.float32)
    affine[..., 0, 0] = np.cos(ang)
    affine[..., 0, 1] = -np.sin(ang)
    affine[..., 1, 0] = np.sin(ang)
    affine[..., 1, 1] = np.cos(ang)
    affine[..., :, 2] = rng.uniform(-0.6, 0.6, (b, l, l, 2))
    mask = np.array([[True, True, False], [True, False, True]])
    jf = JAttFusion(feat_dim=c)
    want = jf.apply({}, jnp.asarray(x), jnp.asarray(affine), jnp.asarray(mask))
    with torch.inference_mode():
        got = AttFusion()(torch.from_numpy(x), torch.from_numpy(affine),
                          torch.from_numpy(mask))
    _close(got, want, 1e-5)


def test_heads():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 10, 20, 32).astype(np.float32)
    jh = JHeads(2, 2, 1)
    variables = _perturb(jh.init(jax.random.PRNGKey(6), jnp.asarray(x)), rng)
    want = jh.apply(variables, jnp.asarray(x))
    hd = _carry(variables, DetectionHeads(32, 2, 2))
    with torch.inference_mode():
        got = hd(torch.from_numpy(x))
    for g, w_ in zip(got, want):
        _close(g, w_, 1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_and_nms_keeps_the_same_boxes(seed):
    rng = np.random.RandomState(seed)
    anchors = generate_anchor_box({
        "W": 80, "H": 40, "l": 3.9, "w": 1.6, "h": 1.56, "r": [0.0, 90.0],
        "vw": 0.4, "vh": 0.4, "cav_lidar_range": list(LR),
        "feature_stride": 4})
    hp, wp = anchors.shape[:2]
    cls = (1.5 * rng.randn(hp, wp, 2)).astype(np.float32)
    reg = (0.3 * rng.randn(hp, wp, 14)).astype(np.float32)
    dirp = rng.randn(hp, wp, 4).astype(np.float32)
    kw = dict(score_threshold=0.2, nms_thresh=0.15, topk=256,
              dir_offset=0.7853, num_bins=2)
    want = jax_decode(jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(dirp),
                      jnp.asarray(anchors), jnp.eye(4), LR, **kw)
    got = decode_and_nms(torch.from_numpy(cls), torch.from_numpy(reg),
                         torch.from_numpy(dirp), torch.from_numpy(anchors),
                         torch.eye(4), LR, **kw)
    wv = np.asarray(want.valid)
    gv = got.valid.numpy()
    # NMS suppressed some boxes, and kept the same ones in the same order
    assert 0 < wv.sum() < (np.asarray(want.scores) > 0.2).sum()
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_allclose(got.scores.numpy()[gv],
                               np.asarray(want.scores)[wv], rtol=1e-6)
    np.testing.assert_allclose(got.boxes7.numpy()[gv],
                               np.asarray(want.boxes7)[wv], atol=1e-5)
    np.testing.assert_allclose(got.corners3d.numpy()[gv],
                               np.asarray(want.corners3d)[wv], atol=1e-4)


def test_weights_raise_on_missing_or_unused_key():
    x = np.zeros((1, 4, 4, 8), np.float32)
    variables = JHeads(2, 2, 1).init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(np.array, variables)
    extra = {"params": dict(variables["params"],
                            stray_head={"kernel": np.zeros((1, 1, 8, 2))})}
    with pytest.raises(KeyError, match="stray_head"):
        flax_to_state_dict(DetectionHeads(8, 2, 2), extra)
    missing = {"params": {k: v for k, v in variables["params"].items()
                          if k != "dir_head"}}
    with pytest.raises(KeyError, match="dir_head"):
        flax_to_state_dict(DetectionHeads(8, 2, 2), missing)
