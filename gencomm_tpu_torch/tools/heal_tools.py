"""Checkpoint surgery for the multi-stage protocol, on the port's
checkpoints.

Counterpart of ``gencomm_tpu/tools/heal_tools.py``, with the same
sub-commands and flags:

    python -m gencomm_tpu_torch.tools.heal_tools merge \
        --new_ckpt <stage-1 dir of the new agent type> \
        --base_ckpt <collaboration base dir> --out <stage-2 dir> \
        [--prefer_new_agent]
    python -m gencomm_tpu_torch.tools.heal_tools best --model_dir <dir>
    python -m gencomm_tpu_torch.tools.heal_tools clean --path <dir>
    python -m gencomm_tpu_torch.tools.heal_tools rename --ckpt <dir> \
        --out <dir> --map old=new [old=new ...]
    python -m gencomm_tpu_torch.tools.heal_tools remove --ckpt <dir> \
        --out <dir> --prefix <module prefix> [...]

``merge`` writes the union of the two ``state_dict``s as ``<out>/step_0``;
on a conflict the collaboration base's tensor wins unless
``--prefer_new_agent``. A module is a key's first component (flax's
top-level module). The tensors are loaded onto ``--device`` (default
``cuda``; ``cpu`` on a machine without a card), where ``merge`` compares
the overlapping ones; the checkpoints written hold CPU tensors.
"""

from __future__ import annotations

import argparse
import os
import shutil

from gencomm_tpu_torch import resolve_device
from gencomm_tpu_torch.train import checkpoint


def _load(path: str, device):
    """A checkpoint directory, or the newest ``step_N`` of a model dir, its
    tensors on ``device``."""
    ck = checkpoint.load_checkpoint(checkpoint.latest_checkpoint(path) or path)
    ck["state_dict"] = {k: v.to(device)
                        for k, v in ck["state_dict"].items()}
    return ck


def merge(args):
    new = _load(args.new_ckpt, args.device)
    base = _load(args.base_ckpt, args.device)
    # merge_params(a, b, prefer="new") lets b win the conflicts: the base by
    # default (its fusion, heads and generator stay authoritative)
    first, second = (base, new) if args.prefer_new_agent else (new, base)
    merged = checkpoint.merge_params(first["state_dict"], second["state_dict"],
                                     prefer="new")
    target = checkpoint.save_checkpoint(args.out, merged, 0)
    print("merged checkpoint written to", target)
    return target


def best(args):
    """The rolling bestval checkpoint, else the latest."""
    path = (checkpoint.bestval_checkpoint(args.model_dir)
            or checkpoint.latest_checkpoint(args.model_dir))
    print(path or "no checkpoints found")
    return path


def clean(args):
    """Remove the intermediate epoch checkpoints of a run dir (and of each
    run dir inside it), keeping the first, the latest and bestval."""

    def clean_one(d):
        steps = sorted(
            (int(name.split("_")[1]), name)
            for name in os.listdir(d)
            if name.startswith("step_") and name.split("_")[1].isdigit())
        for _, name in steps[1:-1]:
            shutil.rmtree(os.path.join(d, name), ignore_errors=True)
            print("removed", os.path.join(d, name))

    root = args.path
    clean_one(root)
    for sub in os.listdir(root):
        p = os.path.join(root, sub)
        if os.path.isdir(p) and not sub.startswith(("step_", "bestval_")):
            clean_one(p)


def _map_modules(state_dict, fn):
    """Apply ``fn(module) -> new module name or None`` to every key's first
    component; None drops the key."""
    out = {}
    for k, v in state_dict.items():
        module, _, rest = k.partition(".")
        new = fn(module)
        if new is not None:
            out[f"{new}.{rest}" if rest else new] = v
    return out


def rename(args):
    """Rename modules by old=new pairs."""
    ck = _load(args.ckpt, args.device)
    mapping = dict(pair.split("=", 1) for pair in args.map)
    sd = _map_modules(ck["state_dict"], lambda m: mapping.get(m, m))
    print("renamed:", mapping)
    print("written to", checkpoint.save_checkpoint(args.out, sd, 0))


def remove(args):
    """Drop the modules whose name starts with any ``--prefix``."""
    ck = _load(args.ckpt, args.device)
    sd = _map_modules(ck["state_dict"], lambda m: None if any(
        m.startswith(p) for p in args.prefix) else m)
    modules = lambda d: {k.partition(".")[0] for k in d}  # noqa: E731
    print("dropped modules:", sorted(modules(ck["state_dict"]) - modules(sd)))
    print("written to", checkpoint.save_checkpoint(args.out, sd, 0))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    sub = parser.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("merge")
    m.add_argument("--new_ckpt", required=True,
                   help="stage-1 checkpoint of the NEW agent type")
    m.add_argument("--base_ckpt", required=True,
                   help="checkpoint of the collaboration base")
    m.add_argument("--out", required=True)
    m.add_argument("--prefer_new_agent", action="store_true",
                   help="on conflicts keep the new agent's weights instead "
                        "of the collab base's")
    b = sub.add_parser("best")
    b.add_argument("--model_dir", required=True)
    r = sub.add_parser("rename")
    r.add_argument("--ckpt", required=True)
    r.add_argument("--out", required=True)
    r.add_argument("--map", nargs="+", required=True,
                   help="old=new module-name pairs")
    rm = sub.add_parser("remove")
    rm.add_argument("--ckpt", required=True)
    rm.add_argument("--out", required=True)
    rm.add_argument("--prefix", nargs="+", required=True)
    mf = sub.add_parser("merge-final")
    mf.add_argument("--ckpts", nargs="+", required=True)
    mf.add_argument("--out", required=True)
    cl = sub.add_parser("clean", help="remove the intermediate epoch "
                                      "checkpoints except the first, the "
                                      "latest and bestval")
    cl.add_argument("--path", required=True)
    args = parser.parse_args(argv)
    args.device = resolve_device(args.device)
    if args.cmd == "merge-final":
        raise NotImplementedError(
            "merge-final (STAMP) is not ported yet (ROADMAP item 16)")
    return {"merge": merge, "best": best, "rename": rename, "remove": remove,
            "clean": clean}[args.cmd](args)


if __name__ == "__main__":
    main()
