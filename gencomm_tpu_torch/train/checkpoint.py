"""Checkpoints and the merging of stage-1 checkpoints for stage 2.

Counterpart of ``gencomm_tpu/train/checkpoint.py`` on ``state_dict``s. The
directory layout is the JAX package's, so the same tools find a run's
checkpoints: ``<model_dir>/step_N/`` (one a saved epoch) and one rolling
``<model_dir>/bestval_at_N/``. Inside, the port writes its own file,
``checkpoint.pt``: one ``torch.save`` of ``{"state_dict", "step"}``, where
the ``state_dict`` holds the parameters and the batch norms' running
statistics (flax's ``params`` and ``batch_stats``). The port does not read
the JAX package's orbax checkpoints: ``scripts/jax_checkpoint_to_torch.py``
carries one across where JAX is installed.

Merging and restoring work on flat ``state_dict``s, key by key, where the
JAX package works on flattened flax trees, leaf by leaf.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Mapping, Tuple

import torch

FILE = "checkpoint.pt"


def _write(target: str, state_dict: Mapping[str, torch.Tensor],
           step: int) -> str:
    os.makedirs(target, exist_ok=True)
    sd = {k: v.detach().to("cpu", copy=True) for k, v in state_dict.items()}
    tmp = os.path.join(target, FILE + ".tmp")
    torch.save({"state_dict": sd, "step": int(step)}, tmp)
    os.replace(tmp, os.path.join(target, FILE))
    return target


def save_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor],
                    step: int, epoch: int | None = None) -> str:
    """Write ``<path>/step_<N>/`` holding ``state_dict`` and the update count
    ``step``; N is ``epoch`` where given (the train CLI names a checkpoint
    by its epoch), else ``step``. Returns the directory."""
    n = int(step if epoch is None else epoch)
    return _write(os.path.join(os.path.abspath(path), f"step_{n}"),
                  state_dict, step)


def load_checkpoint(path: str) -> Dict:
    """``{"state_dict": {key: CPU tensor}, "step": int}`` of a checkpoint
    directory."""
    return torch.load(os.path.join(os.path.abspath(path), FILE),
                      map_location="cpu", weights_only=True)


def latest_checkpoint(model_dir: str) -> str | None:
    if not os.path.isdir(model_dir):
        return None
    steps = [
        (int(d.split("_")[1]), d)
        for d in os.listdir(model_dir)
        if d.startswith("step_") and d.split("_")[1].isdigit()
    ]
    if not steps:
        return None
    return os.path.join(model_dir, max(steps)[1])


def save_bestval(path: str, state_dict: Mapping[str, torch.Tensor],
                 step: int, epoch: int) -> str:
    """The single rolling bestval checkpoint ``<path>/bestval_at_<epoch>/``:
    the new one is written first and the stale ones removed after, so a
    crash in between never leaves the run without a bestval."""
    path = os.path.abspath(path)
    target = _write(os.path.join(path, f"bestval_at_{epoch}"), state_dict,
                    step)
    for d in os.listdir(path):
        if d.startswith("bestval_at_") and os.path.join(path, d) != target:
            shutil.rmtree(os.path.join(path, d), ignore_errors=True)
    return target


def bestval_checkpoint(model_dir: str) -> str | None:
    """The rolling bestval checkpoint of a run, if it has one."""
    if not os.path.isdir(model_dir):
        return None
    cands = [
        (int(d.rsplit("_", 1)[1]), d)
        for d in os.listdir(model_dir)
        if d.startswith("bestval_at_") and d.rsplit("_", 1)[1].isdigit()
    ]
    if not cands:
        return None
    return os.path.join(model_dir, max(cands)[1])


def diff_keys(reference: Mapping, incoming: Mapping) -> Tuple[set, set]:
    """(missing in ``incoming``, unexpected in ``incoming``)."""
    ref, inc = set(reference), set(incoming)
    return ref - inc, inc - ref


def merge_params(base: Mapping[str, torch.Tensor],
                 new: Mapping[str, torch.Tensor], prefer: str = "new",
                 verbose: bool = True) -> Dict[str, torch.Tensor]:
    """Union of two ``state_dict``s. Overlapping keys are reported (how
    many, and how many of them differ in shape or value); on an overlap
    ``prefer="new"`` keeps ``new``'s tensor, anything else ``base``'s."""
    overlap = sorted(set(base) & set(new))
    if verbose and overlap:
        n_diff = sum(1 for k in overlap
                     if base[k].shape != new[k].shape
                     or not torch.allclose(base[k], new[k]))
        print(f"[merge_params] {len(overlap)} overlapping leaves, "
              f"{n_diff} with differing values (prefer={prefer})")
    out = dict(base)
    for k, v in new.items():
        if k not in out or prefer == "new":
            out[k] = v
    return out


def load_into(template: Mapping[str, torch.Tensor],
              restored: Mapping[str, torch.Tensor],
              verbose: bool = True) -> Dict[str, torch.Tensor]:
    """Non-strict restore: each key of ``template`` takes ``restored``'s
    tensor where it has one of the same shape and keeps its own otherwise;
    the keys kept (missing) and the keys of ``restored`` not in the
    template (unexpected) are counted in a report."""
    out, missing = {}, []
    for k, v in template.items():
        if k in restored and tuple(restored[k].shape) == tuple(v.shape):
            out[k] = restored[k]
        else:
            out[k] = v
            missing.append(k)
    unexpected = [k for k in restored if k not in template]
    if verbose and (missing or unexpected):
        print(f"[load_into] missing {len(missing)} leaves, "
              f"unexpected {len(unexpected)} leaves")
    return out
