#!/usr/bin/env python3
"""Where a BackAlign step's camera branch parts, card against CPU.

    python3 scripts/lss_choices_torch.py

Builds configs/opv2v/baselines/stage2/backalign/m1m2_att.yaml's model with
random weights (seed 0) on the card and on the CPU, runs its camera branch
(m2) in training mode on the train CLI's first batch, and prints per agent
slot: the largest difference of the frustum geometry, the cells whose
index differs, the depth probabilities' largest difference, the pixels
whose top-K depth picks differ, and the branch feature's largest
difference. Needs a CUDA card.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gencomm_tpu_torch.config.yaml_utils import load_yaml  # noqa: E402
from gencomm_tpu_torch.models.encoders import lss  # noqa: E402
from gencomm_tpu_torch.models.heter_baseline import (  # noqa: E402
    HeterModel, model_kwargs,
)
from gencomm_tpu_torch.ops import _cuda  # noqa: E402
from gencomm_tpu_torch.pipeline import batch_to_device  # noqa: E402
from gencomm_tpu_torch.tools import train as train_cli  # noqa: E402
from gencomm_tpu_torch.weights import random_state_dict  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    _cuda.build_all()
    hypes = load_yaml(cs.BASELINE_YAMLS["backalign"])
    kw = model_kwargs(hypes)
    ds = train_cli.build_dataset(hypes, True, "synthetic")
    host = train_cli.Adapt(hypes)(next(train_cli.batches(
        ds, hypes["train_params"]["batch_size"], 0, "synthetic")))
    state = random_state_dict(HeterModel(**kw, device="cpu"), seed=0)
    rec, feats = {}, {}
    real_sel, real_cell = lss.LSSEncoder.select_topk, lss.LSSEncoder.cell_ids

    def select_topk(self, depth, cell, inb):
        out = real_sel(self, depth, cell, inb)
        rec.setdefault(depth.device.type, {}).update(
            depth=depth.detach().cpu(), picks=[t.detach().cpu() for t in out])
        return out

    def cell_ids(self, geom):
        out = real_cell(self, geom)
        rec.setdefault(geom.device.type, {}).update(
            geom=geom.detach().cpu(), cell=[t.detach().cpu() for t in out])
        return out

    lss.LSSEncoder.select_topk, lss.LSSEncoder.cell_ids = select_topk, cell_ids
    for dev in ("cuda", "cpu"):
        model = HeterModel(**kw, device=dev)
        model.load_state_dict(state)
        model.train()
        batch = batch_to_device(host, dev)
        inputs = {k[:-3]: v for k, v in batch.items()
                  if k.endswith("_m2") and not k.startswith("modality")}
        feats[dev] = model.branch_m2(inputs)[0].detach().cpu().flatten(0, 1)
    card, cpu = rec["cuda"], rec["cpu"]
    for s in range(feats["cpu"].shape[0]):
        inb = cpu["cell"][1][s]
        print(f"slot {s}: geometry max |d| "
              f"{float((card['geom'][s] - cpu['geom'][s]).abs().max()):.3e}, "
              f"cells differ {int(((card['cell'][0][s] != cpu['cell'][0][s]) & inb).sum())}, "
              f"depth max |d| {float((card['depth'][s] - cpu['depth'][s]).abs().max()):.3e}, "
              f"top-K cells differ {int((card['picks'][1][s] != cpu['picks'][1][s]).sum())}, "
              f"feature max |d| {float((feats['cuda'][s] - feats['cpu'][s]).abs().max()):.3e} "
              f"of {float(feats['cpu'][s].abs().max()):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
