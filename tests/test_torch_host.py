"""The port's host-side data path against the JAX package's.

The synthetic scene sampler, the C++ pillar decorator (and its numpy
reference), the anchors and the agent-slot bucketing must give the same
arrays for the same inputs: equality, not closeness.
"""

import numpy as np
import pytest

from gencomm_tpu.data.bucketing import trim_agent_slots as jax_trim
from gencomm_tpu.data.decorate import host_decorate_pillars
from gencomm_tpu.data.synthetic import (
    SyntheticConfig as JConfig, SyntheticScenes as JScenes,
)
from gencomm_tpu.native import PillarVoxelizer as JVoxelizer

from gencomm_tpu_torch.data.bucketing import trim_agent_slots
from gencomm_tpu_torch.data.decorate import decorate_modality
from gencomm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from gencomm_tpu_torch.native import PillarVoxelizer

LR = (-16.0, -8.0, -3.0, 16.0, 8.0, 1.0)
VOXEL = (0.4, 0.4, 4.0)
EVAL_KEYS = ("agent_mask", "pairwise_t_matrix", "gt_boxes", "gt_mask",
             "points_m1", "point_mask_m1", "modality_mask_m1")
CONFIGS = [
    dict(lidar_range=LR, num_agents=2, points_per_agent=2000,
         num_vehicles=5, points_per_vehicle=40),
    dict(lidar_range=LR, max_cav=4, num_agents=3, points_per_agent=2500,
         num_vehicles=6, points_per_vehicle=30, comm_range=20.0),
]


@pytest.mark.parametrize("kw", CONFIGS)
@pytest.mark.parametrize("seed", [0, 2 ** 33 + 5])
def test_synthetic_eval_fields_equal(kw, seed):
    got = SyntheticScenes(SyntheticConfig(**kw)).sample(seed, batch_size=2)
    want = JScenes(JConfig(**kw)).sample(seed, batch_size=2)
    for k in EVAL_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the eval fields and the anchor labels (tests/test_torch_train.py)
    assert set(got) == set(EVAL_KEYS) | {"pos_equal_one", "neg_equal_one",
                                         "targets"}


def test_anchors_equal():
    kw = CONFIGS[0]
    np.testing.assert_array_equal(SyntheticScenes(SyntheticConfig(**kw)).anchors,
                                  JScenes(JConfig(**kw)).anchors)


def _points(seed, a=3, p=3000):
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(-18, 18, (a, p)), rng.uniform(-9, 9, (a, p)),
                     rng.uniform(-3.5, 1.5, (a, p)), rng.rand(a, p)],
                    -1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_decorator_equals_jax_and_numpy_reference(seed):
    pts = _points(seed)
    vz = PillarVoxelizer(LR, VOXEL)
    f, g, v = vz.decorate_batch(pts)
    jf, jg, jv = JVoxelizer(LR, VOXEL).decorate_batch(pts)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_array_equal(v, jv)
    for i in range(len(pts)):
        nf, ng, nv = vz._decorate_numpy(pts[i])
        np.testing.assert_array_equal(ng, g[i])
        np.testing.assert_array_equal(nv, v[i])
        # the C++ path sums pillar means in fp32, numpy in fp64
        np.testing.assert_allclose(nf, f[i], atol=1e-5)
    # sorted within each agent, invalid rows (id nx*ny) last
    assert np.all(np.diff(g, axis=1) >= 0)
    assert v.any() and not v.all()


def test_decorate_modality_equals_jax_with_padding():
    pts = _points(3, a=2, p=500).reshape(1, 2, 500, 4)
    mask = np.ones((1, 2, 500), bool)
    mask[..., 400:] = False
    batch = {"points_m1": pts, "point_mask_m1": mask,
             "agent_mask": np.ones((1, 2), bool)}
    got = decorate_modality(batch, PillarVoxelizer(LR, VOXEL))
    hypes = {"model": {"args": {"m1": {
        "core_method": "point_pillar",
        "encoder_args": {"voxel_size": list(VOXEL), "lidar_range": list(LR)},
    }}}}
    want = host_decorate_pillars(batch, hypes)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("n_agents,buckets", [(2, (2, 3, 5)), (3, (2, 3, 5)),
                                              (4, (2, 3)), (1, (2,))])
def test_bucketing_equal(n_agents, buckets):
    kw = dict(CONFIGS[0], num_agents=n_agents)
    host = SyntheticScenes(SyntheticConfig(**kw)).sample(1)
    got = trim_agent_slots(host, buckets=buckets)
    want = jax_trim(host, buckets=buckets)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
