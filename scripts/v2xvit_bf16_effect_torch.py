#!/usr/bin/env python3
"""How far bf16 (``half=True``) moves V2X-ViT, in the JAX package and in
the port, on the CPU: is the port's bf16 run further from fp32 than the
reference's?

    JAX_PLATFORMS=cpu python3 scripts/v2xvit_bf16_effect_torch.py \
        [--seeds 0-8] [--module-seeds 0-3]

Two measurements, each with the same weights and inputs in both packages
(needs JAX and flax beside the port):

- the fusion module alone (``V2XViTFusion``, dim 64, depth 2, a 32 x 64
  map of 2 agents; the JAX warp through its Pallas kernel in interpret
  mode, whose bf16 contract K3 keeps): the relative L2 of each package's
  bf16 output against JAX's fp32 output;
- the narrowed ``stage1/m1_v2xvit.yaml`` slice of
  ``tests/test_torch_fusion.py`` (dim 32, depth 2, a 16 x 32 map, the same
  frame and diffusion noise in both): ``scripts/bf16_parity.py``'s
  statistics of sigmoid(cls), bf16 against fp32 in each package and the
  port's bf16 against JAX's bf16.

One JSON object per case goes to standard output. With
``XLA_FLAGS=--xla_allow_excess_precision=false`` XLA rounds every step of
a fused bf16 computation to bf16, as the port's eager ops do, where by
default it keeps them in fp32.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def seeds(text):
    lo, _, hi = text.partition("-")
    return range(int(lo), int(hi or lo) + 1)


def closeness(p, q):
    """(max |d|, relative L2, top-100 overlap) of sigmoid(p) against
    sigmoid(q), as scripts/bf16_parity.py computes them."""
    p = 1.0 / (1.0 + np.exp(-p.reshape(-1)))
    q = 1.0 / (1.0 + np.exp(-q.reshape(-1)))
    top = lambda a: set(np.argsort(-a)[:100])  # noqa: E731
    return (float(np.abs(p - q).max()),
            float(np.linalg.norm(p - q) / np.linalg.norm(q)),
            len(top(p) & top(q)) / 100)


def module_case(seed):
    import jax
    import jax.numpy as jnp
    import torch
    from gencomm_tpu.models.fuse import v2xvit as jax_v2xvit
    from gencomm_tpu_torch.models.fuse.v2xvit import V2XViTFusion
    from gencomm_tpu_torch.weights import flax_to_state_dict
    from tests.test_torch_train import _random_variables

    rng = np.random.RandomState(seed)
    x = (2.0 * rng.randn(1, 2, 32, 64, 64)).astype(np.float32)
    affine = np.tile(np.eye(2, 3, dtype=np.float32), (1, 2, 2, 1, 1))
    affine[0, 0, 1, 0, 2] = 0.1
    mask = np.ones((1, 2), bool)
    args = (jnp.asarray(affine), jnp.asarray(mask))
    j32 = jax_v2xvit.V2XViTFusion(dim=64, depth=2)
    j16 = jax_v2xvit.V2XViTFusion(dim=64, depth=2, half=True)
    v = _random_variables(jax.eval_shape(
        j32.init, jax.random.PRNGKey(0), jnp.asarray(x), *args), seed)
    o32 = np.asarray(jax.jit(j32.apply)(v, jnp.asarray(x), *args))
    o16 = np.asarray(jax.jit(j16.apply)(
        v, jnp.asarray(x, jnp.bfloat16), *args).astype(jnp.float32))
    port = V2XViTFusion(64, depth=2, half=True)
    port.load_state_dict(flax_to_state_dict(port, v))
    with torch.inference_mode():
        p16 = port(torch.from_numpy(x).to(torch.bfloat16),
                   torch.from_numpy(affine),
                   torch.from_numpy(mask)).float().numpy()
    rel = lambda a: float(np.linalg.norm(a - o32) / np.linalg.norm(o32))  # noqa
    return {"case": "module", "seed": seed, "jax_bf16_vs_fp32": rel(o16),
            "port_bf16_vs_jax_fp32": rel(p16),
            "port_bf16_vs_jax_bf16": float(np.linalg.norm(p16 - o16)
                                           / np.linalg.norm(o32))}


def slice_case(seed):
    import jax
    import jax.numpy as jnp
    import pytest
    import torch
    from gencomm_tpu_torch.models import create_model
    from gencomm_tpu_torch.pipeline import batch_to_device
    from gencomm_tpu_torch.weights import flax_to_state_dict
    from tests import test_torch_fusion as fusion_tests

    cls = {}
    for half in (False, True):
        raw = fusion_tests.narrowed16(half=half)
        raw["model"]["args"]["v2xvit"] = {"dim": 32, "depth": 2}
        jh, ph = fusion_tests._hypes(raw)
        batch = fusion_tests._batch(jh, seed=3 + seed, batch_size=1)
        jmodel, variables = fusion_tests._variables(jh, batch, seed=seed)
        rng = np.random.RandomState(7)
        noises = [rng.randn(batch["agent_mask"].size, 16, 32, 32).astype(
            np.float32) for _ in range(3)]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "normal",
                       fusion_tests._replayed_normal(noises))
            jout = jax.jit(functools.partial(jmodel.apply, train=False))(
                variables, {k: jnp.asarray(v) for k, v in batch.items()},
                rngs={"diffusion": jax.random.PRNGKey(7)})
        model = create_model(ph, device="cpu")
        model.load_state_dict(flax_to_state_dict(model, variables))
        with torch.inference_mode():
            tout = model(batch_to_device(batch, "cpu"),
                         noises=[torch.from_numpy(z) for z in noises])
        cls[half] = (np.asarray(jout["cls_preds"], np.float32),
                     tout["cls_preds"].float().numpy())
    keys = ("max_abs", "rel_l2", "top100")
    return {"case": "slice", "seed": seed,
            "jax_bf16_vs_fp32": dict(zip(keys, closeness(cls[True][0],
                                                         cls[False][0]))),
            "port_bf16_vs_fp32": dict(zip(keys, closeness(cls[True][1],
                                                          cls[False][1]))),
            "port_bf16_vs_jax_bf16": dict(zip(keys, closeness(
                cls[True][1], cls[True][0])))}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=seeds, default=seeds("0-8"))
    parser.add_argument("--module-seeds", type=seeds, default=seeds("0-3"))
    args = parser.parse_args(argv)
    import pytest
    from gencomm_tpu.models.fuse import fusion as jax_fusion
    from gencomm_tpu.models.fuse import v2xvit as jax_v2xvit
    from tests import test_torch_fusion as fusion_tests

    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_fusion, jax_v2xvit):
            mp.setattr(mod, "warp_to_ego", fusion_tests._kernel_warp_to_ego)
        for seed in args.module_seeds:
            print(json.dumps(module_case(seed)), flush=True)
    for seed in args.seeds:
        print(json.dumps(slice_case(seed)), flush=True)


if __name__ == "__main__":
    main()
