"""V2X-Real dataset: real-world multi-class collaborative detection (numpy,
host side).

Counterpart of ``gencomm_tpu/data/v2xreal.py``, giving its samples bit for
bit. The OPV2V directory layout, but the lidar is KITTI ``.bin``, CAV ids
are signed integers (roadside units below 0), objects carry class names
mapped onto three super classes (unknown names dropped), and
``dataset_mode`` picks the eval topology (``vc``: vehicles first, then the
roadside units; ``ic``: roadside units first; ``v2v``: vehicles only;
``i2i``: roadside units only). At eval, but in ``v2v``, the scenarios of
2023-04-07 are left out. A sample adds ``gt_classes`` (max_num,), the
1-indexed class of each GT box, aligned with ``gt_boxes`` through the
kept-ids list of the projection; with ``anchor_generator_config`` its
labels are the multi-class ones (``generate_label_multiclass``).
"""

from __future__ import annotations

import os

import numpy as np

from gencomm_tpu_torch.data.opv2v import OPV2VDataset
from gencomm_tpu_torch.data.postprocessor import (
    generate_anchor_box_multiclass, generate_label_multiclass,
)
from gencomm_tpu_torch.utils import pcd_utils

# the dataset's class vocabulary: raw names by super class
SUPER_CLASS_MAP = {
    "vehicle": ["LongVehicle", "Car", "PoliceCar"],
    "pedestrian": ["Child", "RoadWorker", "Pedestrian", "Scooter",
                   "ScooterRider", "Motorcycle", "MotorcyleRider",
                   "BicycleRider"],
    "truck": ["Truck", "Van", "TrashCan", "ConcreteTruck", "Bus"],
}
CLASS_NAMES = list(SUPER_CLASS_MAP)
INVERSE_SUPER_CLASS_MAP = {
    cls: sup for sup, classes in SUPER_CLASS_MAP.items() for cls in classes
}
# scenarios left out at eval but in v2v mode
_UNRELEASED_TAG = "2023-04-07"


def class_id(obj: dict):
    """An object's raw class name (or an already mapped super-class name)
    -> its 1-indexed super-class id; None outside the vocabulary."""
    name = str(obj.get("obj_type", obj.get("class", "")))
    sup = INVERSE_SUPER_CLASS_MAP.get(name)
    if sup is None:
        sup = name.lower() if name.lower() in SUPER_CLASS_MAP else None
    return None if sup is None else CLASS_NAMES.index(sup) + 1


class V2XRealDataset(OPV2VDataset):
    """Multi-class V2X-Real loader. With ``anchor_generator_config`` the
    sample's ``pos_equal_one`` (H', W', C*A) holds -1 / 0 / the class id of
    each anchor-class slot and ``targets`` is (H', W', C*A*7); there is no
    ``neg_equal_one``. The hypes' ``anchor_args`` gain ``vw``, ``vh``,
    ``W`` and ``H`` where they lack them, as in the JAX package."""

    def __init__(self, params: dict, train: bool = True,
                 max_points: int = 40000):
        self.dataset_mode = params.get("dataset_mode", "vc")
        if self.dataset_mode not in ("vc", "ic", "v2v", "i2i"):
            raise ValueError(f"unknown dataset_mode {self.dataset_mode!r}")
        aa = params["postprocess"]["anchor_args"]
        rng_ = aa["cav_lidar_range"]
        vw = aa.get("vw", aa.get("voxel_size", [0.4])[0]
                    if "voxel_size" in aa else 0.4)
        aa.setdefault("vw", vw)
        aa.setdefault("vh", aa.get("vh", vw))
        aa.setdefault("W", int(round((rng_[3] - rng_[0]) / aa["vw"])))
        aa.setdefault("H", int(round((rng_[4] - rng_[1]) / aa["vh"])))
        self.anchor_cfgs = aa.get("anchor_generator_config")
        super().__init__(params, train, max_points)
        self.class_names = CLASS_NAMES
        if self.anchor_cfgs:
            (self.anchors_mc, self.matched_thr, self.unmatched_thr,
             self.anchor_class_names) = generate_anchor_box_multiclass(
                aa, params["postprocess"].get("order", "hwl"))
            self.num_class = self.anchors_mc.shape[0]
        else:
            self.num_class = 1

    def _keep_scenario(self, scenario_name: str) -> bool:
        if not self.train and self.dataset_mode != "v2v":
            return _UNRELEASED_TAG not in scenario_name
        return True

    def _order_cavs(self, cavs: list) -> list:
        """Train: shuffled. Eval: by ``dataset_mode``, vehicles having ids
        of 0 and above, roadside units negative ones."""
        if self.train:
            return list(self.rng.permutation(cavs))

        def _i(c):
            try:
                return int(c)
            except ValueError:
                return 0

        veh = [c for c in cavs if _i(c) >= 0]
        infra = [c for c in cavs if _i(c) < 0]
        return {"vc": veh + infra, "v2v": veh, "ic": infra + veh,
                "i2i": infra}[self.dataset_mode]

    def _read_lidar(self, entry: dict, ts: str, modality: str) -> np.ndarray:
        pts = pcd_utils.load_lidar_bin(os.path.join(entry["path"],
                                                    f"{ts}.bin"))
        if self.train:
            pts = pcd_utils.shuffle_points(pts, self.rng)
        return pts

    def _filter_vehicles(self, vehicles: dict) -> dict:
        """The objects of a known class, each with its id as
        ``class_int``."""
        out = {}
        for oid, obj in vehicles.items():
            cid = class_id(obj)
            if cid is not None:
                out[oid] = dict(obj, class_int=cid)
        return out

    def _labels_for(self, gt_boxes, gt_mask, gt_ids, vehicles_union) -> dict:
        gt_classes = np.zeros(self.max_num, np.int32)
        for i, oid in enumerate(gt_ids):
            gt_classes[i] = vehicles_union[oid].get("class_int", 1)
        if not self.anchor_cfgs:
            out = super()._labels_for(gt_boxes, gt_mask, gt_ids,
                                      vehicles_union)
            out["gt_classes"] = gt_classes
            return out
        label = generate_label_multiclass(
            gt_boxes, gt_classes, gt_mask, self.anchors_mc, self.matched_thr,
            self.unmatched_thr, self.params["postprocess"].get("order", "hwl"))
        return {"pos_equal_one": label["pos_equal_one"],
                "targets": label["targets"], "gt_classes": gt_classes}
