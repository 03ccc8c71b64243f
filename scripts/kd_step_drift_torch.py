#!/usr/bin/env python3
"""How far the port's DiscoNet distillation step lands from the JAX
package's, and where the distance starts, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/kd_step_drift_torch.py [--kd-weight 1000]

The narrowed DiscoNet GenComm model of ``tests/test_torch_fusion.py``'s
``kd_run`` (the same batch, weights and diffusion noise in both packages;
needs JAX and flax beside the port). Printed, one JSON object each:

- ``losses``: each loss term of one ``make_kd_train_step`` step, port
  against JAX, relative;
- ``gradients``: the worst over the student's tensors of max|port - jax|
  over the tensor's largest entry (taken at no less than 1e-2 of the
  largest of all), and the same for JAX's own gradients with the kd weight
  10% lower, which says how much of the distance a kd weight error makes;
- ``modules``: the student's train-mode forward, every module's output
  (its first call) against flax's ``capture_intermediates``, as max|d| over
  max|jax|, with the port's pillar canvas given JAX's values.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--kd-weight", type=float, default=1000.0)
    args = parser.parse_args(argv)
    import jax
    import jax.numpy as jnp
    import pytest
    import torch
    from gencomm_tpu.loss import create_loss as jax_create_loss
    from gencomm_tpu_torch.loss import create_loss
    from gencomm_tpu_torch.models import create_model
    from gencomm_tpu_torch.models.encoders import point_pillar
    from gencomm_tpu_torch.pipeline import batch_to_device
    from gencomm_tpu_torch.train import trainer
    from gencomm_tpu_torch.weights import flax_grads_to_torch, flax_to_state_dict
    from tests import test_torch_fusion as T

    raw = T.narrowed16(fusion_method="disconet", disconet={"feat_dim": 32})
    raw["model"]["args"]["gencomm"]["model"].update(ch_mult=[1],
                                                    num_res_blocks=1)
    raw["loss"]["core_method"] = "point_pillar_disconet_loss"
    raw["loss"]["args"]["kd"] = {"weight": args.kd_weight}
    jh, ph = T._hypes(raw)
    batch = T._batch(jh, seed=5, batch_size=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel, variables = T._variables(jh, batch, seed=0)
    _, teacher_vars = T._variables(jh, batch, seed=1)
    rng = np.random.RandomState(11)
    noises = [rng.randn(batch["agent_mask"].size, 16, 32, 32).astype(
        np.float32) for _ in range(3)]
    everything = lambda mdl, name: name == "__call__"  # noqa: E731

    def jax_step(kd_weight):
        """JAX's gradients, losses and the student's module outputs."""
        hypes = copy.deepcopy(jh)
        hypes["loss"]["args"]["kd"] = {"weight": kd_weight}
        criterion = jax_create_loss(hypes)

        def grads(params):
            t_out = jmodel.apply(teacher_vars, jb, train=False,
                                 rngs={"diffusion": jax.random.PRNGKey(0)})
            teacher_feature = jax.lax.stop_gradient(t_out["feature"])

            def loss_fn(p):
                out, mutated = jmodel.apply(
                    {"params": p, "batch_stats": variables["batch_stats"]},
                    jb, train=True, mutable=["batch_stats", "intermediates"],
                    capture_intermediates=everything,
                    rngs={"diffusion": jax.random.PRNGKey(0)})
                out = dict(out, teacher_feature=teacher_feature,
                           student_feature=out["feature"])
                losses = criterion(out, jb)
                return losses["total_loss"], (losses,
                                              mutated["intermediates"])

            return jax.grad(loss_fn, has_aux=True)(params)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "normal", T._replayed_normal(noises * 2))
            g, (losses, inter) = jax.jit(grads)(variables["params"])
        return (jax.tree_util.tree_map(np.asarray, g),
                {k: float(v) for k, v in losses.items()}, inter)

    jgrads, jlosses, inter = jax_step(args.kd_weight)
    model, teacher = (create_model(ph, device="cpu") for _ in range(2))
    model.load_state_dict(flax_to_state_dict(model, variables))
    teacher.load_state_dict(flax_to_state_dict(teacher, teacher_vars))
    opt, sched = trainer.make_optimizer(ph, model.named_parameters())
    step = trainer.make_kd_train_step(model, teacher, create_loss(ph), opt,
                                      sched)
    losses = step(batch_to_device(batch, "cpu"),
                  noises=[torch.from_numpy(z) for z in noises])
    print(json.dumps({"losses": {k: abs(float(losses[k]) - v) / abs(v)
                                 for k, v in jlosses.items()}}), flush=True)

    def to_torch(g):
        return {k: v.numpy() for k, v in flax_grads_to_torch(model, g).items()}

    want = to_torch(jgrads)
    top = max(float(np.abs(v).max()) for v in want.values())

    def worst(got):
        return max((float(np.abs(got[k] - w).max())
                    / max(float(np.abs(w).max()), 1e-2 * top), k)
                   for k, w in want.items())

    port = {k: p.grad.numpy() for k, p in model.named_parameters()}
    lower = to_torch(jax_step(0.9 * args.kd_weight)[0])
    print(json.dumps({"gradients": {"port": worst(port),
                                    "jax_kd_weight_x0.9": worst(lower)}}),
          flush=True)

    # the student's train-mode forward, module by module
    flat = {}

    def walk(tree, path):
        for k, v in tree.items():
            if k == "__call__":
                if hasattr(v[0], "shape"):
                    flat[".".join(path)] = np.asarray(v[0], np.float32)
            elif isinstance(v, dict):
                walk(v, path + [k])

    walk(inter, [])
    seen = {}

    def hook(name):
        def record(module, inputs, output):
            if torch.is_tensor(output) and name not in seen:
                seen[name] = output.detach().float().numpy()
        return record

    student = create_model(ph, device="cpu")
    student.load_state_dict(flax_to_state_dict(student, variables))
    student.train()
    for name, module in student.named_modules():
        if name:
            module.register_forward_hook(hook(name))
    canvas = flat["branch_m1.encoder"]
    real = point_pillar.pillar_canvas

    def jax_valued(*a):
        out = real(*a)
        j = torch.from_numpy(canvas).to(out.dtype).reshape(out.shape)
        return out + (j - out).detach()

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(point_pillar, "pillar_canvas", jax_valued)
        student(batch_to_device(batch, "cpu"),
                noises=[torch.from_numpy(z) for z in noises])
    rows = {}
    for name, b in flat.items():
        a = seen.get(name)
        if a is not None and a.size == b.size:
            rows[name] = float(np.abs(a.reshape(b.shape) - b).max()
                               / max(float(np.abs(b).max()), 1e-30))
    print(json.dumps({"modules": rows}), flush=True)


if __name__ == "__main__":
    main()
