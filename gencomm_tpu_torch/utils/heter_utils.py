"""The heterogeneity controller: which modality each agent of a frame
carries (numpy, host side).

Counterpart of ``gencomm_tpu/utils/heter_utils.py``: the ``Adaptor``
(eval-time reordering of the CAV list so that an agent of the ego
modality comes first, the train-time random reassignment by
``cav_preference`` and the eval-time ``mapping_dict``, OPV2V-H's 32 / 16
channel lidar swap, ``from_hypes``) and ``assign_modality``, the offline
fixed assignment per scenario and CAV. The same seed gives the same draws
as the JAX package.
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict

import numpy as np


class Adaptor:
    def __init__(self, ego_modality: str, model_modality_list: list[str],
                 modality_assignment: dict | None,
                 lidar_channels_dict: dict | None,
                 mapping_dict: dict, cav_preference: dict | None,
                 train: bool, seed: int = 303):
        self.ego_modality = ego_modality
        self.model_modality_list = model_modality_list
        self.modality_assignment = modality_assignment or {}
        self.lidar_channels_dict = lidar_channels_dict or {}
        self.mapping_dict = mapping_dict
        if cav_preference is None:
            cav_preference = dict.fromkeys(model_modality_list,
                                           1.0 / len(model_modality_list))
        self.cav_preference = cav_preference
        self.train = train
        self.rng = np.random.RandomState(seed)

    def reorder_cav_list(self, cav_list: list, scenario_name: str) -> list:
        """Train: the list shuffled. Eval: a CAV whose mapped modality is the
        ego modality first, the others sorted after it."""
        if self.train:
            cav_list = list(cav_list)
            self.rng.shuffle(cav_list)
            return cav_list
        assignment = self.modality_assignment.get(scenario_name)
        if not assignment or not cav_list:
            return cav_list
        first = assignment.get(cav_list[0])
        if first is not None and self.mapping_dict.get(first, first) in \
                self.ego_modality:
            return cav_list
        ego_cav = None
        for cav_id, modality in assignment.items():
            if self.mapping_dict.get(modality, modality) in self.ego_modality:
                ego_cav = cav_id
                break
        if ego_cav is None or ego_cav not in cav_list:
            return cav_list
        return [ego_cav] + sorted(c for c in cav_list if c != ego_cav)

    def reassign_cav_modality(self, modality_name: str,
                              idx_in_cav_list: int) -> str:
        """Train: a draw by ``cav_preference`` (the ego slot one of the ego
        modalities); eval: ``mapping_dict``."""
        if self.train:
            if idx_in_cav_list == 0:
                return str(self.rng.choice(self.ego_modality.split("&")))
            keys = list(self.cav_preference.keys())
            w = np.array([self.cav_preference[k] for k in keys], np.float64)
            return str(self.rng.choice(keys, p=w / w.sum()))
        return self.mapping_dict.get(modality_name, modality_name)

    def unmatched_modality(self, cav_modality: str) -> bool:
        return cav_modality not in self.model_modality_list

    def switch_lidar_channels(self, cav_modality: str,
                              lidar_file_path: str) -> str:
        """OPV2V-H's 32 / 16-beam cloud of a modality whose
        ``lidar_channels_dict`` names one, else the path unchanged."""
        ch = self.lidar_channels_dict.get(cav_modality)
        if ch in (32, 16):
            return lidar_file_path.replace("OPV2V", "OPV2V_Hetero").replace(
                ".pcd", f"_{int(ch)}.pcd")
        return lidar_file_path

    @staticmethod
    def from_hypes(hypes: dict, train: bool) -> "Adaptor | None":
        """The hypes' ``heter`` block as an ``Adaptor``; None without one."""
        heter = hypes.get("heter")
        if not heter:
            return None
        assignment = None
        path = heter.get("assignment_path")
        if path and os.path.exists(path):
            with open(path) as f:
                assignment = json.load(f)
        return Adaptor(
            ego_modality=str(heter.get("ego_modality", "m1")),
            model_modality_list=list(heter.get("modality_setting", {})),
            modality_assignment=assignment,
            lidar_channels_dict=heter.get("lidar_channels_dict"),
            mapping_dict=heter.get("mapping_dict", {}),
            cav_preference=heter.get("cav_preference"),
            train=train)


def assign_modality(root_dir: str, output_path: str,
                    modalities=("m1", "m2", "m3", "m4"), seed: int = 303):
    """A fixed modality for every CAV of every scenario under
    ``root_dir/{train,test,validate}/<scenario>/<cav>/``, drawn uniformly
    from ``modalities``, written as JSON to ``output_path`` and returned."""
    rng = np.random.RandomState(seed)
    out: "OrderedDict[str, dict]" = OrderedDict()
    for split in ("train", "test", "validate"):
        split_dir = os.path.join(root_dir, split)
        if not os.path.isdir(split_dir):
            continue
        for sc in sorted(os.listdir(split_dir)):
            sc_path = os.path.join(split_dir, sc)
            if not os.path.isdir(sc_path):
                continue
            cavs = sorted(d for d in os.listdir(sc_path)
                          if os.path.isdir(os.path.join(sc_path, d)))
            out[sc] = {cav: str(rng.choice(modalities)) for cav in cavs}
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "w") as f:
        json.dump(out, f, indent=1)
    return out
