"""Hypes-YAML loading with geometry derivation.

The port's copy of ``gencomm_tpu/config/yaml_utils.py``: the same keys, the
same ``yaml_parser`` dispatch through the ``YAML_PARSERS`` registry and the
same derivations, so that one yaml gives the same dict in both packages.
Parsers:
  load_general_params           anchor grid from the range and voxel size
  load_point_pillar_params      + the pillar grid size
  load_second_params            + the voxel grid size (int rounding)
  load_bev_params               the BEV geometry block
  load_lift_splat_shoot_params  anchor grid (as load_general_params)

The JAX package's stripe-padded pillar switch (``GENCOMM_STRIPED``, off by
default) is not ported: the port accepts the ``striped_scatter`` key and
ignores it, so with the switch unset both loaders give the same dict.
"""

from __future__ import annotations

import math
import os
import re

import numpy as np
import yaml

from gencomm_tpu_torch.registry import YAML_PARSERS


class _Loader(yaml.SafeLoader):
    """SafeLoader that also reads scientific notation without a dot (1e-4)
    as a float, as yaml 1.2 does; a subclass, so PyYAML's own SafeLoader
    is left as it was."""


_Loader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        """^(?:[-+]?(?:[0-9][0-9_]*)\\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\\.[0-9_]+(?:[eE][-+][0-9]+)?
        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\\.[0-9_]*
        |[-+]?\\.(?:inf|Inf|INF)
        |\\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def load_yaml(file: str | None, model_dir: str | None = None) -> dict:
    """Load a hypes yaml file into a dict and run its geometry parser.

    If ``model_dir`` is given and holds ``config.yaml``, that file is
    authoritative (a trained run's own copy of its hypes)."""
    if model_dir is not None:
        candidate = os.path.join(model_dir, "config.yaml")
        if os.path.exists(candidate):
            file = candidate
    with open(file, "r") as f:
        param = yaml.load(f, Loader=_Loader)
    return update_yaml(param)


def update_yaml(param: dict) -> dict:
    """Re-run the derivation parsers on a loaded (or changed at run time)
    hypes dict, e.g. after a range override."""
    if "yaml_parser" in param:
        parsers = param["yaml_parser"]
        if isinstance(parsers, str):
            parsers = [parsers]
        for p in parsers:
            param = YAML_PARSERS.get(p)(param)
    elif "yaml_parsers" in param:
        # STAMP layout: each modality_setting carries its own range and
        # preprocess block and is derived by its own named parsers
        for mname, parser_names in param["yaml_parsers"].items():
            if isinstance(parser_names, str):
                parser_names = [parser_names]
            setting = param["heter"]["modality_setting"][mname]
            for p in parser_names:
                setting = YAML_PARSERS.get(p)(setting)
            param["heter"]["modality_setting"][mname] = setting
    return param


def save_yaml(data: dict, path: str) -> None:
    with open(path, "w") as f:
        yaml.dump(data, f, default_flow_style=False)


def _derive_anchor_args(param: dict, rounding) -> dict:
    cav_lidar_range = param["preprocess"]["cav_lidar_range"]
    voxel_size = param["preprocess"]["args"]["voxel_size"]
    anchor_args = param["postprocess"]["anchor_args"]
    vw, vh, vd = voxel_size
    anchor_args["vw"], anchor_args["vh"], anchor_args["vd"] = vw, vh, vd
    # W along lidar x (image width), H along y (image height)
    anchor_args["W"] = rounding((cav_lidar_range[3] - cav_lidar_range[0]) / vw)
    anchor_args["H"] = rounding((cav_lidar_range[4] - cav_lidar_range[1]) / vh)
    anchor_args["D"] = rounding((cav_lidar_range[5] - cav_lidar_range[2]) / vd)
    param["postprocess"]["anchor_args"] = anchor_args
    return param


def _grid_size(param: dict) -> np.ndarray:
    cav_lidar_range = param["preprocess"]["cav_lidar_range"]
    voxel_size = param["preprocess"]["args"]["voxel_size"]
    grid = ((np.array(cav_lidar_range[3:6]) - np.array(cav_lidar_range[0:3]))
            / np.array(voxel_size))
    return np.round(grid).astype(np.int64)


@YAML_PARSERS.register("load_general_params")
def load_general_params(param: dict) -> dict:
    return _derive_anchor_args(param, math.ceil)


@YAML_PARSERS.register("load_point_pillar_params")
def load_point_pillar_params(param: dict) -> dict:
    grid_size = _grid_size(param)
    param["model"]["args"].setdefault("point_pillar_scatter", {})
    param["model"]["args"]["point_pillar_scatter"]["grid_size"] = grid_size
    return _derive_anchor_args(param, math.ceil)


@YAML_PARSERS.register("load_second_params")
def load_second_params(param: dict) -> dict:
    param["model"]["args"]["grid_size"] = _grid_size(param)
    return _derive_anchor_args(param, int)


@YAML_PARSERS.register("load_bev_params")
def load_bev_params(param: dict) -> dict:
    res = param["preprocess"]["args"]["res"]
    l1, w1, h1, l2, w2, h2 = param["preprocess"]["cav_lidar_range"]
    downsample_rate = param["preprocess"]["args"]["downsample_rate"]
    input_shape = (
        int((l2 - l1) / res),
        int((w2 - w1) / res),
        int((h2 - h1) / res) + 1,
    )
    label_shape = (
        int(input_shape[0] / downsample_rate),
        int(input_shape[1] / downsample_rate),
        7,
    )
    geometry_param = {
        "L1": l1, "L2": l2, "W1": w1, "W2": w2, "H1": h1, "H2": h2,
        "downsample_rate": downsample_rate,
        "input_shape": input_shape,
        "label_shape": label_shape,
        "res": res,
    }
    param["preprocess"]["geometry_param"] = geometry_param
    param["postprocess"]["geometry_param"] = geometry_param
    param["model"]["args"]["geometry_param"] = geometry_param
    return param


@YAML_PARSERS.register("load_lift_splat_shoot_params")
def load_lift_splat_shoot_params(param: dict) -> dict:
    return _derive_anchor_args(param, math.ceil)


def update_dict(base: dict, override: dict) -> dict:
    """Recursive config override: nested dicts merge, other values replace."""
    for key, val in override.items():
        if isinstance(val, dict) and isinstance(base.get(key), dict):
            update_dict(base[key], val)
        else:
            base[key] = val
    return base
