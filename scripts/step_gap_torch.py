#!/usr/bin/env python3
"""Where V2X-Real's training step parts, card against CPU.

    python3 scripts/step_gap_torch.py [--full]

Writes a V2X-Real-layout tree as ``chip_smoke.py``'s phase 18 does, builds
configs/v2xreal/gencomm/stage1/m1_att.yaml's model (random weights, seed 0)
cut to ``chip_smoke.P18_STEP_RANGE`` (``--full``: its whole range) and holds
one training step on the host-decorated path (the pillar rows in bf16 into
K2, K2b in the backward) on the card against the CPU with
``chip_smoke.hold_step``, in four variants, each with the CPU step's ReLU
gates:

    points            the decorated points jittered (1e-7)
    points+rows       and both steps on the CPU step's K2 rows
    canvas            the canvas jittered too, where the backbone takes it
    canvas+rows       both

Logs where the offset gradients part (``chip_smoke.offset_gap``: the
sampling taps whose floor differs). Prints per variant the worst gradient
gap (relative L2) of the card step, the jittered CPU step's (the spread),
the tolerance and the worst five parameters against their own spread, as
a JSON line. Needs a CUDA card
(``--device cpu`` runs the "card" step on the CPU too: a check of the
script, whose gaps are 0).
"""

import argparse
import copy
import json
import os
import sys
import tempfile
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gencomm_tpu_torch.config.yaml_utils import load_yaml  # noqa: E402
from gencomm_tpu_torch.loss import create_loss  # noqa: E402
from gencomm_tpu_torch.models import create_model  # noqa: E402
from gencomm_tpu_torch.ops import _cuda  # noqa: E402
from gencomm_tpu_torch.pipeline import batch_to_device  # noqa: E402
from gencomm_tpu_torch.tools import inference, train  # noqa: E402
from gencomm_tpu_torch.train import trainer  # noqa: E402
from gencomm_tpu_torch.weights import random_state_dict  # noqa: E402

VARIANTS = {"points": (False, None), "points+rows": (True, None),
            "canvas": (False, cs.P18_JITTER_MODULE),
            "canvas+rows": (True, cs.P18_JITTER_MODULE)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="the yaml's whole range, not the cut")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        _cuda.build_all()
    with tempfile.TemporaryDirectory() as root:
        tree = os.path.join(root, "v2xreal_tree")
        cs.write_tree(tree, "v2xreal", seed=18)
        hypes = load_yaml(cs.p18_yaml(root, "v2xreal", tree))
        cut = (copy.deepcopy(hypes) if args.full else inference.override_range(
            copy.deepcopy(hypes), cs.P18_STEP_RANGE))
        cut["train_params"]["batch_size"] = 1
        ds = train.build_dataset(cut, True, "v2xreal")
        host = train.Adapt(cut)(ds.collate([ds[0]]))
    state = random_state_dict(create_model(cut, device="cpu"), seed=0)

    def fresh(device):
        model = create_model(cut, device=device)
        model.load_state_dict(state)
        model.train()
        opt, sched = trainer.make_optimizer(cut, model.named_parameters(), 1)
        return model, trainer.make_train_step(model, create_loss(cut), opt,
                                              sched)

    gen = torch.Generator().manual_seed(3)
    noises = [torch.randn((host["agent_mask"].size,)
                          + cs._heads_grid_shape(cut), generator=gen)
              for _ in range(3)]
    out = {"range": cut["preprocess"]["cav_lidar_range"],
           "rows_m1": list(host["decorated_m1"].shape)}
    for name, (rows, module) in VARIANTS.items():
        cs.log(f"variant {name}")
        cell = SimpleNamespace(
            label="v2xreal", dev=dev, hosts=[host],
            batches=[batch_to_device(host, dev)], jitter_key="decorated_m1",
            jitter_module=module, noises=noises,
            noises_dev=[z.to(dev) for z in noises], fresh=fresh)
        try:
            cs.hold_step(cell, same_choices=True, same_gates=True,
                         same_rows=rows, no_grad=cs.P18_NO_GRAD,
                         explain_offsets=True)
            held = True
        except AssertionError as e:
            cs.log(f"variant {name}: {e}")
            held = False
        out[name] = dict(getattr(cell, "step_gap", {}), held=held)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
