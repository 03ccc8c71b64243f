"""CoAlign's pose refinement of the port (``models/coalign.py``, plain
PyTorch) and its pose-graph tool against the JAX package's
(``gencomm_tpu/models/coalign.py``, ``tools/pose_graph.py``), on the CPU,
on the cases of ``tests/test_coalign.py``: the refined poses within
COALIGN_TOL (both run 10-20 Gauss-Newton steps in fp32; observed below
2e-6), the clusters equal, and the recovery of an injected pose error held
on the port as the JAX tests hold it on JAX.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gencomm_tpu.models import coalign as jax_coalign
from gencomm_tpu.tools import pose_graph as jax_pose_graph

from gencomm_tpu_torch.models import coalign
from gencomm_tpu_torch.tools import pose_graph

from tests.test_coalign import make_chain_scene, make_scene

# fp32 Gauss-Newton in two frameworks: the normal equations' sums and the
# solves round differently (observed up to 1.1e-6 on these cases)
COALIGN_TOL = 1e-5


def _both(centers, yaws, mask, noisy, unc=None, **kw):
    """(JAX's refined poses, the port's), as numpy."""
    want = np.asarray(jax_coalign.box_align_relative(
        jnp.asarray(centers, jnp.float32), jnp.asarray(yaws, jnp.float32),
        jnp.asarray(mask), jnp.asarray(noisy, jnp.float32),
        None if unc is None else jnp.asarray(unc, jnp.float32), **kw))

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dt)

    got = coalign.box_align_relative(
        t(centers), t(yaws), t(mask, torch.bool), t(noisy),
        None if unc is None else t(unc), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=COALIGN_TOL)
    return want, got


def test_recovers_injected_pose_error():
    centers, yaws, mask, noisy, true_poses = make_scene(
        np.random.RandomState(0))
    _, refined = _both(centers, yaws, mask, noisy, thres=3.0)
    np.testing.assert_allclose(refined[0], noisy[0], atol=1e-6)
    err_before = np.abs(noisy[1] - true_poses[1])
    err_after = np.abs(refined[1] - true_poses[1])
    assert err_after[0] < 0.15 and err_after[1] < 0.15
    assert err_after[2] < 0.03
    assert (err_after < err_before + 1e-6).all()


def test_refine_poses_np_wrapper_matches_jax():
    centers, yaws, mask, noisy, true_poses = make_scene(
        np.random.RandomState(1))
    boxes = np.zeros((2, mask.shape[1], 7), np.float32)
    boxes[:, :, 0:2] = centers
    boxes[:, :, 6] = yaws
    poses6 = np.zeros((2, 6))
    poses6[:, 0], poses6[:, 1] = noisy[:, 0], noisy[:, 1]
    poses6[:, 4] = np.degrees(noisy[:, 2])
    got = coalign.refine_poses_np(boxes, mask, poses6, thres=3.0,
                                  device="cpu")
    want = jax_coalign.refine_poses_np(boxes, mask, poses6, thres=3.0)
    # yaw in degrees: the tolerance in radians times 180 / pi
    np.testing.assert_allclose(got, want, rtol=0, atol=COALIGN_TOL * 60)
    assert abs(got[1, 0] - true_poses[1, 0]) < 0.15
    assert abs(np.radians(got[1, 4]) - true_poses[1, 2]) < 0.03


def test_refine_poses_np_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("the default device is present")
    centers, yaws, mask, noisy, _ = make_scene(np.random.RandomState(1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        coalign.refine_poses_np(np.zeros((2, mask.shape[1], 7)), mask,
                                np.zeros((2, 6)))


def test_no_matches_is_stable():
    centers, yaws, mask, noisy, _ = make_scene(np.random.RandomState(2))
    mask[1] = False
    _, refined = _both(centers, yaws, mask, noisy)
    assert np.isfinite(refined).all()
    np.testing.assert_allclose(refined[1], noisy[1], atol=1e-4)


def test_nonego_landmarks_constrain_third_agent():
    centers, yaws, mask, true_poses = make_chain_scene(
        np.random.RandomState(3))
    noisy = true_poses.copy()
    noisy[2] += [0.9, -0.6, 0.06]
    _, refined = _both(centers, yaws, mask, noisy, thres=3.0)
    err_before = np.abs(noisy[2] - true_poses[2])
    err_after = np.abs(refined[2] - true_poses[2])
    assert err_after[0] < 0.1 and err_after[1] < 0.1 and err_after[2] < 0.02
    assert (err_after < err_before).all()
    np.testing.assert_allclose(refined[0], noisy[0], atol=1e-6)


def test_uncertainty_downweights_bad_boxes():
    K = 8
    world_xy = np.array([[x, y] for x in (-12.0, 0.0, 12.0)
                         for y in (-8.0, 8.0)])
    world_yaw = np.linspace(-2.0, 2.0, 6)
    true_poses = np.array([[0.0, 0.0, 0.0], [10.0, 2.0, 0.3]])
    centers = np.zeros((2, K, 2))
    yaws = np.zeros((2, K))
    mask = np.zeros((2, K), bool)
    for i in range(2):
        c, s = np.cos(true_poses[i, 2]), np.sin(true_poses[i, 2])
        rot = np.array([[c, s], [-s, c]])
        centers[i, :6] = (world_xy - true_poses[i, :2]) @ rot.T
        yaws[i, :6] = world_yaw - true_poses[i, 2]
        mask[i, :6] = True
    noisy = true_poses.copy()
    noisy[1] += [0.5, -0.3, 0.03]
    centers[1, 0, 0] += 1.5
    unc = np.zeros((2, K, 3), np.float32)
    unc[1, 0, :] = 6.0
    _, ref_w = _both(centers, yaws, mask, noisy, unc, thres=3.0)
    _, ref_nw = _both(centers, yaws, mask, noisy, thres=3.0)
    err_w = np.abs(ref_w[1] - true_poses[1])
    err_nw = np.abs(ref_nw[1] - true_poses[1])
    assert err_w[0] < err_nw[0]
    assert err_w[0] < 0.05 and err_w[1] < 0.05


@pytest.mark.parametrize("kw", [dict(iterations=20),
                                dict(landmark_se2=False),
                                dict(adaptive_landmark=True,
                                     yaw_var_thres=0.05)])
def test_chain_options_match_jax(kw):
    centers, yaws, mask, true_poses = make_chain_scene(
        np.random.RandomState(5))
    noisy = true_poses.copy()
    noisy[1] += [0.4, -0.3, 0.03]
    noisy[2] += [-0.5, 0.4, -0.04]
    _both(centers, yaws, mask, noisy, thres=3.0, **kw)


def test_cluster_labels_match_jax():
    centers, yaws, mask, true_poses = make_chain_scene(
        np.random.RandomState(3))
    L, K = mask.shape
    xy = np.concatenate([(centers[i] @ np.array(
        [[np.cos(true_poses[i, 2]), np.sin(true_poses[i, 2])],
         [-np.sin(true_poses[i, 2]), np.cos(true_poses[i, 2])]])
        + true_poses[i, :2]) for i in range(L)]).astype(np.float32)
    agent_of = np.repeat(np.arange(L), K)
    want = np.asarray(jax_coalign._cluster_labels(
        jnp.asarray(xy), jnp.asarray(mask.reshape(-1)),
        jnp.asarray(agent_of), 3.0, L))
    got = coalign.cluster_labels(torch.from_numpy(xy),
                                 torch.from_numpy(mask.reshape(-1)),
                                 torch.from_numpy(agent_of), 3.0, L).numpy()
    assert np.array_equal(got, want)
    assert len(np.unique(got[mask.reshape(-1)])) < mask.sum()


def test_pose_graph_tool_matches_jax(tmp_path, capsys):
    """precalc writes the JAX tool's records; evaluate's errors before and
    after the refinement agree (the refinement within COALIGN_TOL)."""
    from types import SimpleNamespace

    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    pose_graph.main(["precalc", "--out", port_dir, "--frames", "2"])
    jax_pose_graph.precalc(SimpleNamespace(out=jax_dir, frames=2))
    with open(os.path.join(port_dir, "stage1_boxes.json")) as a, \
            open(os.path.join(jax_dir, "stage1_boxes.json")) as b:
        assert a.read() == b.read()
    got = pose_graph.main(["evaluate", "--out", port_dir, "--device", "cpu"])
    want = jax_pose_graph.evaluate(SimpleNamespace(out=jax_dir))
    assert set(got) == set(want) == {"std_0.2", "std_0.4", "std_0.6"}
    for k in want:
        assert got[k]["pos_err_noisy_m"] == want[k]["pos_err_noisy_m"]
        assert abs(got[k]["pos_err_refined_m"]
                   - want[k]["pos_err_refined_m"]) <= COALIGN_TOL
        assert got[k]["pos_err_refined_m"] < got[k]["pos_err_noisy_m"]
