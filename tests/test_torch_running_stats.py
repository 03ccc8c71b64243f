"""The norms' running statistics over several train steps, the port
against the JAX package, on the CPU (ROADMAP section 3, p5).

A narrowed ``stage1/m1_att.yaml`` (the slice of ``test_torch_config.py``)
trains 6 steps in both packages from the same weights, on the same 6
batches (2 samples x 3 agent slots, labels) with the same injected
diffusion noise and the yaml's AdamW. After each step every running mean
and variance (flax's ``batch_stats``, momentum 0.99) is held against JAX's.
A drift here would compound over a workflow run; agreement leaves the far
eval activations of a short run to flax's momentum-0.99 semantics, which
the port copies.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gencomm_tpu.config import yaml_utils as jax_yaml
from gencomm_tpu.data.decorate import host_decorate_pillars
from gencomm_tpu.data.synthetic import SyntheticScenes as JaxScenes
from gencomm_tpu.loss import create_loss as jax_create_loss
from gencomm_tpu.models import create_model as jax_create_model
from gencomm_tpu.train import trainer as jax_trainer

from gencomm_tpu_torch.config import yaml_utils
from gencomm_tpu_torch.data.bucketing import trim_agent_slots
from gencomm_tpu_torch.loss import create_loss
from gencomm_tpu_torch.models import create_model
from gencomm_tpu_torch.pipeline import batch_to_device
from gencomm_tpu_torch.train import trainer
from gencomm_tpu_torch.weights import flax_to_state_dict

from tests.test_torch_config import (
    GENCOMM, _shape_batch, narrowed, small_scenes_config,
)
from tests.test_torch_train import _random_variables

STEPS = 6
# per step, |port - jax| of a running statistic, relative to max(1, its
# largest value): fp32 batch statistics through the same layers summed in
# other orders, and the step's update (Adam's sign of each gradient)
STATS_TOL = 1e-3


@pytest.fixture(scope="module")
def stats_run():
    raw = narrowed(GENCOMM[0])
    jh = jax_yaml.update_yaml(copy.deepcopy(raw))
    ph = yaml_utils.update_yaml(copy.deepcopy(raw))
    scenes = JaxScenes(small_scenes_config(jh, jax_side=True))
    batches = [host_decorate_pillars(trim_agent_slots(
        scenes.sample(20 + i, 2), buckets=(3,)), jh) for i in range(STEPS)]
    jmodel = jax_create_model(jh)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        b, train=False), _shape_batch(jh, points=500))
    variables = _random_variables(shapes, 0)
    tx = jax_trainer.make_optimizer(jh)
    state = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]))
    rng = np.random.RandomState(13)
    noises = [rng.randn(batches[0]["agent_mask"].size, 10, 20, 32).astype(
        np.float32) for _ in range(3)]
    replay = iter(noises)
    jstats = []
    with pytest.MonkeyPatch.context() as mp:
        # traced once: every step draws these three noises
        mp.setattr(jax.random, "normal",
                   lambda key, shape, dtype=jnp.float32: jnp.asarray(
                       next(replay)).reshape(shape).astype(dtype))
        step = jax_trainer.make_train_step(jmodel, jax_create_loss(jh), tx)
        for b in batches:
            state, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                            jax.random.PRNGKey(0))
            jstats.append((jax.tree_util.tree_map(np.asarray, state.params),
                           jax.tree_util.tree_map(np.asarray,
                                                  state.batch_stats)))
    model = create_model(ph, device="cpu")
    model.load_state_dict(flax_to_state_dict(model, variables))
    opt, sched = trainer.make_optimizer(ph, model.named_parameters())
    tstep = trainer.make_train_step(model, create_loss(ph), opt, sched)
    tnoises = [torch.from_numpy(z) for z in noises]
    port, want = [], []
    for b, (jp, js) in zip(batches, jstats):
        tstep(batch_to_device(b, "cpu"), noises=tnoises)
        port.append({k: v.clone() for k, v in model.state_dict().items()})
        want.append(flax_to_state_dict(model, {"params": jp,
                                               "batch_stats": js}))
    lr = float(opt.param_groups[0]["lr"])
    return port, want, {n for n, _ in model.named_parameters()}, lr


def _worst(port, want, keys):
    """(max over ``keys`` of |port - jax| / max(1, max|jax|), its key)."""
    return max((float((port[k] - want[k]).abs().max())
                / max(1.0, float(want[k].abs().max())), k) for k in keys)


@pytest.mark.parametrize("step", range(STEPS))
def test_running_stats_follow_jax_step_by_step(stats_run, step):
    """The first step's running statistics agree to fp32 sum order
    (observed 4.1e-7): flax's momentum-0.99 update, copied. Then the
    parameters part, as Adam takes the sign of gradients at the noise level
    (each step moves such a weight by lr either way), and the statistics
    follow them (observed 1.2e-5, 6.5e-5, 2.0e-4, 3.7e-4, 6.7e-4 at steps
    2-6), under STATS_TOL."""
    port, want, params, lr = stats_run
    stats = [k for k in port[step] if k not in params]
    assert len(stats) >= 14  # 7 batch norms: PFN, backbone, shrinker
    worst = _worst(port[step], want[step], stats)
    assert worst[0] <= (1e-5 if step == 0 else STATS_TOL), worst
    # the parameters' parting, by Adam's sign: at most 2 lr a step
    assert _worst(port[step], want[step], params)[0] <= 2 * lr * (step + 1)
