#!/usr/bin/env python3
"""Where the card and the CPU part on the workflow's trained stage-2 model:
runs ``chip_smoke.py``'s workflow phase on one NVIDIA GPU with forward hooks
on the inference models' modules (two levels deep), then compares the
first frame's outputs of the card's ``tools.inference`` model with those of
the CPU's, module by module.

    python3 scripts/workflow_module_diff_torch.py [--root build/workflow]

Prints one line a module output: its shape, max |cpu|, max |card - cpu| and
their ratio, then one JSON object with the same numbers. A failed check of
the phase is printed and does not stop the comparison.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from gencomm_tpu_torch.tools import inference  # noqa: E402


def tensors(out):
    """A module's output as {name: fp32 CPU tensor}."""
    if torch.is_tensor(out):
        return {"": out.detach().float().cpu()}
    items = out.items() if isinstance(out, dict) else (
        enumerate(out) if isinstance(out, (tuple, list)) else ())
    return {str(k): v.detach().float().cpu() for k, v in items
            if torch.is_tensor(v)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(REPO, "build", "workflow"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("workflow_module_diff_torch: no CUDA device", file=sys.stderr)
        return 1

    real_create = inference.create_model
    recorded = []  # (device, {module: {name: tensor}}), first forward only

    def create_model(hypes, device=None):
        model = real_create(hypes, device=device)
        outs = {}
        recorded.append((str(device), outs))

        def hook(name):
            def record(mod, inp, out):
                if name not in outs:
                    outs[name] = tensors(out)
            return record

        for name, mod in model.named_modules():
            if name and name.count(".") <= 1:
                mod.register_forward_hook(hook(name))
        return model

    inference.create_model = create_model
    try:
        chip_smoke.workflow(args.root)
    except Exception:  # the comparison below is what this script is for
        traceback.print_exc()
    card = next(o for d, o in recorded if d.startswith("cuda"))
    cpu = next(o for d, o in recorded if d.startswith("cpu"))
    rows = []
    for name, outs in card.items():
        for key, a in outs.items():
            b = cpu.get(name, {}).get(key)
            if b is None or a.shape != b.shape or not b.numel():
                continue
            scale = float(b.abs().max())
            err = float((a - b).abs().max())
            rows.append({"module": name, "output": key,
                         "shape": list(a.shape), "max_cpu": scale,
                         "max_diff": err, "rel": err / max(scale, 1e-30)})
            print(f"{name:40s} {key:3s} {str(tuple(a.shape)):26s} max|cpu| "
                  f"{scale:10.3e} max|d| {err:10.3e} rel {rows[-1]['rel']:.3e}")
    print(json.dumps({"modules": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
