#!/usr/bin/env python3
"""Carry a checkpoint of the JAX package across to the PyTorch port.

    python scripts/jax_checkpoint_to_torch.py --ckpt <JAX run dir or its
        step_N / bestval_at_N dir> --out <port run dir> \
        [--hypes_yaml <yaml>]

Reads the orbax checkpoint with ``gencomm_tpu.train.checkpoint.
load_checkpoint`` (the newest ``step_N`` of a run dir), builds the port's
model from the hypes (default: the run's ``config.yaml``) on the CPU, maps
``params`` and ``batch_stats`` onto its ``state_dict`` with
``gencomm_tpu_torch.weights.flax_to_state_dict`` (which raises on a flax
variable without a counterpart, a missing key or a shape mismatch) and
writes it with the port's ``save_checkpoint`` under the same name
(``step_N``, or the rolling ``bestval_at_N``), with the update count, and the
hypes as ``config.yaml`` where the port run dir has none. Needs JAX, flax
and orbax: it imports both packages, and lives outside the port's.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gencomm_tpu.train import checkpoint as jax_checkpoint  # noqa: E402

from gencomm_tpu_torch.config.yaml_utils import load_yaml, save_yaml  # noqa: E402
from gencomm_tpu_torch.models import create_model  # noqa: E402
from gencomm_tpu_torch.train import checkpoint  # noqa: E402
from gencomm_tpu_torch.weights import flax_to_state_dict  # noqa: E402


def convert(ckpt: str, out: str, hypes_yaml: str | None = None) -> str:
    """Convert one checkpoint; returns the port's checkpoint directory."""
    src = jax_checkpoint.latest_checkpoint(ckpt) or ckpt
    src = os.path.abspath(src)
    run_dir = os.path.dirname(src)
    hypes = load_yaml(hypes_yaml or os.path.join(run_dir, "config.yaml"))
    restored = jax_checkpoint.load_checkpoint(src)
    model = create_model(hypes, device="cpu")
    sd = flax_to_state_dict(model, {
        "params": restored["params"],
        "batch_stats": restored.get("batch_stats", {})})
    step = int(restored.get("step", 0))
    name, _, n = os.path.basename(src).rpartition("_")
    os.makedirs(out, exist_ok=True)
    if not os.path.exists(os.path.join(out, "config.yaml")):
        save_yaml(hypes, os.path.join(out, "config.yaml"))
    if name == "bestval_at":
        return checkpoint.save_bestval(out, sd, step, int(n))
    return checkpoint.save_checkpoint(out, sd, step, epoch=int(n))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--hypes_yaml", "-y", default=None)
    args = parser.parse_args(argv)
    target = convert(args.ckpt, args.out, args.hypes_yaml)
    print("written to", target)
    return target


if __name__ == "__main__":
    main()
