"""Parameters for the port's models.

``flax_to_state_dict`` carries the JAX package's ``variables`` (``params``
and ``batch_stats``, as numpy arrays) into a ``state_dict``, and
``flax_grads_to_torch`` a flax gradient tree onto the parameters; the module
names follow flax's auto-names, so the flax path ``a/b/Conv_0/kernel`` is
the torch key ``a.b.Conv_0.weight``. Layouts:

  Conv           (kh, kw, I, O)  -> (O, I, kh, kw)   (depthwise: (3,3,1,C) -> (C,1,3,3))
  ConvTranspose  (kh, kw, I, O)  -> (I, O, kh, kw), flipped spatially
  Dense          (I, O)          -> (O, I)
  norm layers    scale, bias     -> weight, bias; batch_stats mean, var ->
                                    running_mean, running_var (the masked
                                    norms of PFN and SECOND too)
  raw parameters keep their layout: dcn_kernel, dcn_bias; SECOND's sparse
                 conv kernels (kz, ky, kx, I, O); the fusions' flax
                 layouts, TypedDense / DenseGeneral kernel and bias,
                 relation_att / relation_msg, rel_pos, rel_pos_bias.

``random_state_dict`` makes seeded random weights for runs without a
trained checkpoint.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from gencomm_tpu_torch.models.encoders.point_pillar import MaskedBatchNorm
from gencomm_tpu_torch.models.layers import (
    BatchNorm, Conv, ConvTranspose, Dense, GroupNorm, LayerNorm,
)

_NORMS = (BatchNorm, MaskedBatchNorm, GroupNorm, LayerNorm)


def _flatten(tree: Dict[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def _convert(mod: nn.Module, col: str, leaf: str, v: np.ndarray):
    """(torch parameter name, array) of one flax leaf on module ``mod``."""
    if col == "batch_stats":
        if isinstance(mod, (BatchNorm, MaskedBatchNorm)) and leaf in ("mean", "var"):
            return f"running_{leaf}", v
    elif isinstance(mod, Conv):
        if leaf == "kernel":
            return "weight", v.transpose(3, 2, 0, 1)
        if leaf == "bias":
            return "bias", v
    elif isinstance(mod, ConvTranspose):
        if leaf == "kernel":
            return "weight", v.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    elif isinstance(mod, Dense):
        if leaf == "kernel":
            return "weight", v.T
        if leaf == "bias":
            return "bias", v
    elif isinstance(mod, _NORMS):
        if leaf in ("scale", "bias"):
            return ("weight" if leaf == "scale" else "bias"), v
    elif leaf in dict(mod.named_parameters(recurse=False)):
        return leaf, v
    raise KeyError(f"flax variable {col}:{leaf} has no counterpart on "
                   f"{type(mod).__name__}")


def _carry(model: nn.Module, variables: Dict[str, Any], cols, expected
           ) -> Dict[str, torch.Tensor]:
    """Map the flax collections ``cols`` of ``variables`` onto the torch
    keys of ``expected`` (name -> tensor of the port's shape). Raises on a
    flax variable with no counterpart, a missing key or a shape mismatch."""
    modules = dict(model.named_modules())
    sd: Dict[str, torch.Tensor] = {}
    for col in cols:
        for path, value in _flatten(variables.get(col, {})):
            mod_path = ".".join(path[:-1])
            mod = modules.get(mod_path)
            if mod is None:
                raise KeyError(f"flax variable {col}/{'/'.join(path)} has no "
                               "module in the port")
            name, arr = _convert(mod, col, path[-1], value)
            key = f"{mod_path}.{name}" if mod_path else name
            if key not in expected:
                raise KeyError(f"flax variable {col}/{'/'.join(path)} maps to "
                               f"unknown key {key}")
            t = torch.from_numpy(arr.copy(order="C"))
            if tuple(t.shape) != tuple(expected[key].shape):
                raise ValueError(f"{key}: flax shape {value.shape} -> "
                                 f"{tuple(t.shape)}, port expects "
                                 f"{tuple(expected[key].shape)}")
            sd[key] = t
    missing = sorted(set(expected) - set(sd))
    if missing:
        raise KeyError(f"no flax variable for {missing}")
    return sd


def flax_to_state_dict(model: nn.Module, variables: Dict[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """The port's state_dict from JAX ``variables``. Raises on a flax
    variable with no counterpart, a missing key or a shape mismatch."""
    return _carry(model, variables, ("params", "batch_stats"),
                  model.state_dict())


def flax_grads_to_torch(model: nn.Module, grads: Dict[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """A flax gradient tree (the ``params`` tree's structure, no
    ``batch_stats``) as the port's parameter names and layouts, e.g. to
    compare with ``p.grad`` after a backward. Raises like
    ``flax_to_state_dict``."""
    return _carry(model, {"params": grads}, ("params",),
                  dict(model.named_parameters()))


def load_flax_variables(model: nn.Module, variables: Dict[str, Any]) -> nn.Module:
    model.load_state_dict(flax_to_state_dict(model, variables), strict=True)
    return model


def random_state_dict(model: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Seeded random weights (drawn on the CPU, so every device gets the
    same values): He-scaled conv/linear weights (a raw parameter in flax's
    layout over the axes its module's ``FAN_IN_AXES`` names, a table at its
    module's ``PARAM_STD``), norm scales near 1, small biases and running
    statistics near (0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    modules = dict(model.named_modules())
    sd = {}
    for key, ref in model.state_dict().items():
        mod_path, _, name = key.rpartition(".")
        mod = modules[mod_path]
        n = torch.randn(ref.shape, generator=gen, dtype=torch.float32)
        if isinstance(mod, _NORMS):
            sd[key] = {"weight": 1.0 + 0.1 * n, "bias": 0.1 * n,
                       "running_mean": 0.1 * n,
                       "running_var": 1.0 + 0.1 * n.abs()}[name]
        elif name == "bias" or name == "dcn_bias":
            sd[key] = 0.01 * n
        elif name in getattr(mod, "PARAM_STD", {}):
            sd[key] = mod.PARAM_STD[name] * n
        else:
            axes = getattr(mod, "FAN_IN_AXES", {}).get(name)
            if axes is not None:
                # a raw parameter in flax's layout: its contracted axes
                fan_in = int(np.prod([ref.shape[a] for a in axes]))
            elif isinstance(mod, ConvTranspose):
                fan_in = ref.shape[0]
            elif name == "dcn_kernel":
                fan_in = ref.shape[0] * ref.shape[1] * ref.shape[2]
            else:
                fan_in = int(np.prod(ref.shape[1:]))
            sd[key] = n * (2.0 / fan_in) ** 0.5
    return sd
