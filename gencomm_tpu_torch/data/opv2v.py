"""OPV2V / OPV2V-H / V2XSet directory-format dataset (numpy, host side).

Counterpart of ``gencomm_tpu/data/opv2v.py``, giving its samples bit for
bit. On-disk layout::

    root/<scenario>/<cav_id>/<timestamp>.yaml   (lidar pose + vehicles GT)
    root/<scenario>/<cav_id>/<timestamp>.pcd    (lidar)

A sample is the model's padded batch format for one frame: per lidar
modality the points (L, P, 4) with their mask, the agent and modality
masks, the pairwise transforms (L, L, 4, 4), the GT boxes (max_num, 7) in
the ego frame and the anchor labels; ``collate`` stacks samples on a
leading batch axis. The robustness settings are the hypes': pose noise
from ``noise_setting``, communication delay from ``wild_setting`` or
``noise_setting.async_args`` ('sim' and 'real' modes, 100 ms frames; a
delayed agent replays an earlier frame's points and pose, the GT stays
current). ``data_augment`` augments early and late fusion training.
With ``supervise_single`` (and the per-slot legacy cores) every agent
also gets labels in its own frame, and a modality whose
``modality_setting`` carries its own ``postprocess`` block (STAMP) gets
labels at its own range.

Camera modalities and ``label_type: camera`` need the camera loader
(``data/camera.py``), which is not ported: they raise.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import yaml

from gencomm_tpu_torch.data.augmentor import DataAugmentor
from gencomm_tpu_torch.data.postprocessor import (
    generate_anchor_box, generate_label,
)
from gencomm_tpu_torch.utils import box_utils, pcd_utils
from gencomm_tpu_torch.utils.heter_utils import Adaptor
from gencomm_tpu_torch.utils.pose_utils import add_noise_to_poses
from gencomm_tpu_torch.utils.transformation_utils import (
    get_pairwise_transformation, x1_to_x2, x_to_world_batch,
)


def load_cav_yaml(path: str) -> dict:
    with open(path, "r") as f:
        return yaml.safe_load(f)


def project_world_objects(vehicles: dict, lidar_pose, lidar_range,
                          max_num: int, order: str = "hwl"):
    """Vehicle dicts (world frame) -> padded (max_num, 7) boxes in the
    lidar frame, their mask and the kept object ids. An object is kept
    when one of its four bottom corners lies in the xy range; the box is
    re-fitted from its corners in the lidar frame."""
    boxes = np.zeros((max_num, 7), np.float32)
    mask = np.zeros(max_num, np.float32)
    ids = []
    n = 0
    for oid, content in vehicles.items():
        if n >= max_num:
            break
        loc = content["location"]
        ang = content["angle"]  # roll, yaw, pitch
        center = content.get("center", [0, 0, 0])
        obj_pose = [loc[0] + center[0], loc[1] + center[1], loc[2] + center[2],
                    ang[0], ang[1], ang[2]]
        obj2lidar = x1_to_x2(obj_pose, list(lidar_pose))
        corners = box_utils.create_bbx(content["extent"])  # half l, w, h
        hom = np.concatenate([corners, np.ones((8, 1))], axis=1)
        corners_lidar = (hom @ obj2lidar.T)[:, :3][None]
        box7 = box_utils.corner_to_center(corners_lidar, order=order)[0]
        xy = corners_lidar[0, :4, :2]
        inside = ((xy[:, 0] >= lidar_range[0]) & (xy[:, 0] <= lidar_range[3])
                  & (xy[:, 1] >= lidar_range[1])
                  & (xy[:, 1] <= lidar_range[4]))
        if not inside.any():
            continue
        boxes[n] = box7
        mask[n] = 1.0
        ids.append(oid)
        n += 1
    return boxes, mask, ids


def project_world_objects_multi(vehicles: dict, poses: np.ndarray,
                                lidar_range, max_num: int,
                                order: str = "hwl"):
    """``project_world_objects`` into each of L agent frames at once:
    (boxes (L, max_num, 7), masks (L, max_num), the kept ids per agent),
    with the single-agent function's keep rule, order and cap."""
    L = len(poses)
    boxes = np.zeros((L, max_num, 7), np.float32)
    masks = np.zeros((L, max_num), np.float32)
    ids: list[list] = [[] for _ in range(L)]
    if not vehicles or L == 0:
        return boxes, masks, ids
    oids = list(vehicles)
    obj_poses = np.array(
        [[v["location"][0] + v.get("center", (0, 0, 0))[0],
          v["location"][1] + v.get("center", (0, 0, 0))[1],
          v["location"][2] + v.get("center", (0, 0, 0))[2],
          v["angle"][0], v["angle"][1], v["angle"][2]]
         for v in vehicles.values()], np.float64)
    extents = np.array([v["extent"] for v in vehicles.values()], np.float64)
    corners = box_utils.create_bbx_batch(extents)  # (K, 8, 3)
    hom = np.concatenate([corners, np.ones_like(corners[..., :1])], -1)
    world_c = np.einsum("kij,kpj->kpi", x_to_world_batch(obj_poses), hom)
    agent2world = x_to_world_batch(np.asarray(poses))  # (L, 4, 4)
    agent_c = np.linalg.solve(agent2world[:, None],
                              np.swapaxes(world_c, -1, -2)[None])
    agent_c = np.swapaxes(agent_c, -1, -2)[..., :3]  # (L, K, 8, 3)
    K = len(oids)
    box7 = box_utils.corner_to_center(agent_c.reshape(L * K, 8, 3),
                                      order=order).reshape(L, K, 7)
    xy = agent_c[:, :, :4, :2]
    inside = ((xy[..., 0] >= lidar_range[0]) & (xy[..., 0] <= lidar_range[3])
              & (xy[..., 1] >= lidar_range[1])
              & (xy[..., 1] <= lidar_range[4])).any(axis=2)  # (L, K)
    for i in range(L):
        kept = np.nonzero(inside[i])[0][:max_num]
        n = len(kept)
        boxes[i, :n] = box7[i, kept]
        masks[i, :n] = 1.0
        ids[i] = [oids[k] for k in kept]
    return boxes, masks, ids


class OPV2VDataset:
    """Directory-scan dataset producing padded model batches."""

    def __init__(self, params: dict, train: bool = True,
                 max_points: int = 40000):
        self.params = params
        self.train = train
        self.max_points = max_points
        self.root = params["root_dir"] if train else params["validate_dir"]
        self.max_cav = params.get("train_params", {}).get("max_cav", 5)
        self.comm_range = params.get("comm_range", 70.0)
        self.max_num = params["postprocess"]["max_num"]
        self.lidar_range = params["preprocess"]["cav_lidar_range"]
        self.anchors = generate_anchor_box(
            params["postprocess"]["anchor_args"],
            params["postprocess"].get("order", "hwl"))
        tgt = params["postprocess"]["target_args"]
        self.pos_threshold = tgt["pos_threshold"]
        self.neg_threshold = tgt["neg_threshold"]
        self.noise_setting = params.get("noise_setting")
        margs = params.get("model", {}).get("args", {})
        core = params.get("model", {}).get("core_method", "").lower()
        self.per_agent_labels = bool(margs.get("supervise_single")) or any(
            core.startswith(c) for c in
            ("ciassd", "second", "fpvrcnn", "point_pillar_uncertainty"))
        # the delay: wild_setting, or noise_setting's async_args where both
        # add_noise and add_async_noise are set; 'sim' or 'real' mode,
        # drawn per agent in _delay_frames
        wild = dict(params.get("wild_setting", {}))
        ns = params.get("noise_setting") or {}
        if ns.get("add_noise") and ns.get("add_async_noise"):
            aa = ns.get("async_args", {})
            wild = {"async": True,
                    "async_mode": aa.get("async_mode", "sim"),
                    "async_overhead": aa.get("async_overhead", 0),
                    "async_method": aa.get("async_method", ""),
                    "backbone_delay": aa.get("backbone_delay", 0),
                    "data_size": aa.get("data_size", 0),
                    "transmission_speed": aa.get("transmission_speed", 27)}
        self.async_flag = bool(wild.get("async", False))
        self.async_mode = wild.get("async_mode", "sim")
        self.async_method = wild.get("async_method", "")
        self.async_overhead = float(wild.get("async_overhead", 0))
        self.backbone_delay = float(wild.get("backbone_delay", 0))
        self.data_size = float(wild.get("data_size", 0))
        self.transmission_speed = float(wild.get("transmission_speed", 27))

        self.adaptor = Adaptor.from_hypes(params, train)
        self.model_modalities = (self.adaptor.model_modality_list
                                 if self.adaptor else ["m1"])
        hset = params.get("heter", {}).get("modality_setting", {})
        self.lidar_modalities = [
            m for m in self.model_modalities
            if hset.get(m, {"sensor_type": "lidar"}).get(
                "sensor_type", "lidar") == "lidar"]
        cameras = [m for m in self.model_modalities
                   if hset.get(m, {}).get("sensor_type") == "camera"]
        self.label_type = params.get("label_type", "lidar")
        if cameras or self.label_type == "camera":
            raise NotImplementedError(
                f"camera modalities {cameras} and label_type "
                f"{self.label_type!r} need the camera loader data/camera.py, "
                "which is not ported yet (ROADMAP item 20)")
        if not self.lidar_modalities:
            self.lidar_modalities = ["m1"]
        # STAMP: a modality_setting with its own postprocess block gets its
        # per-agent labels at its own range and anchors
        self.modality_post = {}
        for m in self.model_modalities:
            mpost = hset.get(m, {}).get("postprocess")
            if not mpost or "anchor_args" not in mpost:
                continue
            m_order = mpost.get("order",
                                params["postprocess"].get("order", "hwl"))
            mtgt = mpost.get("target_args", tgt)
            aa = mpost["anchor_args"]
            self.modality_post[m] = {
                "anchors": generate_anchor_box(aa, m_order),
                "range": list(hset[m].get("preprocess", {}).get(
                    "cav_lidar_range", aa["cav_lidar_range"])),
                "pos": mtgt["pos_threshold"],
                "neg": mtgt["neg_threshold"],
            }
        self.rng = np.random.RandomState(params.get("seed", 303))
        # world augmentation, which only early and late fusion configs name
        self.fusion_mode = params.get("fusion", {}).get(
            "core_method", "").lower()
        self.augmentor = None
        if "data_augment" in params:
            self.augmentor = DataAugmentor(params["data_augment"], train,
                                           params.get("seed", 303))
        self.reinitialize()

    # ------------------------------------------------------------------
    # the hooks V2X-Real overrides (data/v2xreal.py)
    def _keep_scenario(self, scenario_name: str) -> bool:
        return True

    def _order_cavs(self, cavs: list) -> list:
        """The CAVs of a scenario in their sample order; shuffled in
        training."""
        if self.train:
            return list(self.rng.permutation(cavs))
        return cavs

    def _filter_vehicles(self, vehicles: dict) -> dict:
        """A yaml's GT objects as the labels take them (all, for OPV2V)."""
        return vehicles

    def _read_lidar(self, entry: dict, ts: str, modality: str) -> np.ndarray:
        """One CAV's cloud: the ``.pcd`` (OPV2V-H's 32 / 16-channel copy
        where the modality names one and it exists) without the ego body's
        returns, shuffled in training."""
        pcd_path = os.path.join(entry["path"], f"{ts}.pcd")
        if self.adaptor is not None:
            switched = self.adaptor.switch_lidar_channels(modality, pcd_path)
            if os.path.exists(switched):
                pcd_path = switched
        pts = pcd_utils.mask_ego_points(pcd_utils.read_pcd(pcd_path))
        if self.train:
            pts = pcd_utils.shuffle_points(pts, self.rng)
        return pts

    def _labels_for(self, gt_boxes, gt_mask, gt_ids, vehicles_union) -> dict:
        """The GT's anchor labels (and any other GT key)."""
        label = generate_label(gt_boxes, gt_mask, self.anchors,
                               self.pos_threshold, self.neg_threshold)
        return {k: label[k]
                for k in ("pos_equal_one", "neg_equal_one", "targets")}

    # ------------------------------------------------------------------
    def reinitialize(self):
        """Scan the scenarios again (their CAVs shuffled in training)."""
        self.scenario_database = OrderedDict()
        self.index_map = []  # flat index -> (scenario, timestamp)
        scenarios = sorted(d for d in os.listdir(self.root)
                           if os.path.isdir(os.path.join(self.root, d)))
        for sc in scenarios:
            if not self._keep_scenario(sc):
                continue
            sc_path = os.path.join(self.root, sc)
            cavs = sorted(d for d in os.listdir(sc_path)
                          if os.path.isdir(os.path.join(sc_path, d)))
            cavs = self._order_cavs(cavs)
            if not cavs:
                continue
            db = OrderedDict()
            timestamps = None
            for cav in cavs[: self.max_cav]:
                cav_path = os.path.join(sc_path, cav)
                ts = sorted(f[:-5] for f in os.listdir(cav_path)
                            if f.endswith(".yaml") and "additional" not in f)
                db[cav] = {"path": cav_path, "timestamps": ts}
                if timestamps is None or len(ts) < len(timestamps):
                    timestamps = ts
            self.scenario_database[sc] = db
            for t in timestamps or []:
                self.index_map.append((sc, t))

    def __len__(self):
        return len(self.index_map)

    def _delay_frames(self) -> int:
        """One agent's delay in 100 ms frames: 'real' mode draws
        uniform(0, overhead) and adds the transmission (data_size / speed)
        and backbone terms; 'sim' mode is the fixed overhead, or
        randint(0, overhead) + 100 ms with async_method 'random'."""
        if not self.async_flag:
            return 0
        if self.async_mode == "real":
            overhead_noise = self.rng.uniform(0, self.async_overhead)
            tc = self.data_size / self.transmission_speed * 1000.0
            delay_ms = overhead_noise + tc + self.backbone_delay
        elif self.async_overhead > 0:
            if self.async_method == "random":
                delay_ms = self.rng.randint(0, int(self.async_overhead)) + 100
            else:
                delay_ms = self.async_overhead
        else:
            delay_ms = 0
        return int(delay_ms) // 100

    # ------------------------------------------------------------------
    def __getitem__(self, idx: int) -> dict:
        sc, timestamp = self.index_map[idx]
        db = self.scenario_database[sc]
        L, P = self.max_cav, self.max_points

        cav_list = list(db.keys())  # the ego is the first
        if self.adaptor is not None and not self.train:
            cav_list = self.adaptor.reorder_cav_list(cav_list, sc)
        ego_path = db[cav_list[0]]["path"]
        ego_yaml = load_cav_yaml(os.path.join(ego_path, f"{timestamp}.yaml"))
        ego_pose = np.array(ego_yaml["lidar_pose"], np.float64)

        agents, poses, vehicles_union = [], [], OrderedDict()
        agent_modalities = []
        for ci, cav in enumerate(cav_list):
            entry = db[cav]
            ts = timestamp
            delay_frames = self._delay_frames() if ci > 0 else 0
            if delay_frames > 0:
                tlist = entry["timestamps"]
                ti = (max(tlist.index(timestamp) - delay_frames, 0)
                      if timestamp in tlist else 0)
                ts = tlist[ti]
            ypath = os.path.join(entry["path"], f"{ts}.yaml")
            if not os.path.exists(ypath):
                continue
            cyaml = load_cav_yaml(ypath)
            pose = np.array(cyaml["lidar_pose"], np.float64)
            dist = np.hypot(pose[0] - ego_pose[0], pose[1] - ego_pose[1])
            if ci > 0 and dist > self.comm_range:
                continue
            modality = "m1"
            if self.adaptor is not None:
                assigned = (self.adaptor.modality_assignment or {}).get(
                    sc, {}).get(cav, "m1")
                modality = self.adaptor.reassign_cav_modality(assigned,
                                                              len(agents))
                if self.adaptor.unmatched_modality(modality):
                    if ci == 0:
                        modality = self.adaptor.ego_modality.split("&")[0]
                    else:
                        continue
            agent_modalities.append(modality)
            agents.append(self._read_lidar(entry, ts, modality))
            poses.append(pose)
            # the GT is the union over agents by object id, from the
            # current frame's yaml: a delayed agent's stale features meet
            # live GT
            cur_yaml = cyaml
            if ts != timestamp:
                cur = os.path.join(entry["path"], f"{timestamp}.yaml")
                if os.path.exists(cur):
                    cur_yaml = load_cav_yaml(cur)
            for oid, o in self._filter_vehicles(
                    cur_yaml.get("vehicles", {})).items():
                vehicles_union.setdefault(oid, o)
            if len(agents) == L:
                break

        na = len(agents)
        poses_arr = np.stack(poses) if na else np.zeros((0, 6))
        noisy_poses = add_noise_to_poses(poses_arr, self.noise_setting,
                                         self.rng)

        points = np.zeros((L, P, 4), np.float32)
        point_mask = np.zeros((L, P), bool)
        for i, pts in enumerate(agents):
            k = min(len(pts), P)
            points[i, :k] = pts[:k]
            point_mask[i, :k] = True

        pairwise = get_pairwise_transformation(noisy_poses, L, na).astype(
            np.float32)
        agent_mask = np.zeros(L, bool)
        agent_mask[:na] = True

        gt_boxes, gt_mask, gt_ids = project_world_objects(
            vehicles_union, ego_pose, self.lidar_range, self.max_num)
        early = self.fusion_mode.startswith("early")
        aug_on = self.augmentor is not None and self.train
        if aug_on:
            ngt = int(gt_mask.sum())
            if early:
                # one world transform in the ego frame: the ego GT
                # augmented, the 4 x 4 folded into every agent -> ego
                # matrix, so the merged clouds land in augmented coordinates
                _, boxes0, A = self.augmentor.transform(
                    np.zeros((0, 4), np.float32), gt_boxes[:ngt])
                gt_boxes[:ngt] = boxes0
                pairwise[:, 0] = (A[None] @ pairwise[:, 0]).astype(np.float32)
            else:
                # late and no fusion: the ego's cloud and GT together
                k0 = int(point_mask[0].sum())
                pts0, boxes0, _ = self.augmentor.transform(points[0, :k0],
                                                           gt_boxes[:ngt])
                points[0, :k0] = pts0
                gt_boxes[:ngt] = boxes0
        sample = {"agent_mask": agent_mask, "pairwise_t_matrix": pairwise,
                  "gt_boxes": gt_boxes, "gt_mask": gt_mask}
        sample.update(self._labels_for(gt_boxes, gt_mask, gt_ids,
                                       vehicles_union))
        if self.per_agent_labels:
            # every agent's labels in its own frame
            ps = np.zeros((L,) + sample["pos_equal_one"].shape, np.float32)
            ns = np.zeros_like(ps)
            ts_ = np.zeros((L,) + sample["targets"].shape, np.float32)
            gtb_all, gtm_all, _ = project_world_objects_multi(
                vehicles_union, noisy_poses[:na], self.lidar_range,
                self.max_num)
            for i in range(na):
                if i == 0 and aug_on and not early:
                    # the ego slot: the jointly augmented cloud and GT above
                    gtb_i, gtm_i = gt_boxes.copy(), gt_mask.copy()
                else:
                    gtb_i, gtm_i = gtb_all[i], gtm_all[i]
                    if i > 0 and aug_on and not early:
                        # a draw of its own, as each CAV is its own
                        # late-fusion training sample
                        ki = int(point_mask[i].sum())
                        n_i = int(gtm_i.sum())
                        pts_i, boxes_i, _ = self.augmentor.transform(
                            points[i, :ki], gtb_i[:n_i])
                        points[i, :ki] = pts_i
                        gtb_i[:n_i] = boxes_i
                lab_i = generate_label(gtb_i, gtm_i, self.anchors,
                                       self.pos_threshold, self.neg_threshold)
                ps[i] = lab_i["pos_equal_one"]
                ns[i] = lab_i["neg_equal_one"]
                ts_[i] = lab_i["targets"]
            sample["pos_equal_one_single"] = ps
            sample["neg_equal_one_single"] = ns
            sample["targets_single"] = ts_
        # STAMP: an agent of modality m gets labels at m's own range and
        # anchors; the slots of other modalities stay zero
        for m, mp in self.modality_post.items():
            shape = mp["anchors"].shape[:3]
            ps_m = np.zeros((L,) + shape, np.float32)
            ns_m = np.zeros_like(ps_m)
            ts_m = np.zeros((L,) + shape[:2] + (shape[2] * 7,), np.float32)
            slots = [i for i in range(na) if agent_modalities[i] == m]
            if slots:
                gtb_m, gtm_m, _ = project_world_objects_multi(
                    vehicles_union, noisy_poses[slots], mp["range"],
                    self.max_num)
            for si, i in enumerate(slots):
                lab_i = generate_label(gtb_m[si], gtm_m[si], mp["anchors"],
                                       mp["pos"], mp["neg"])
                ps_m[i] = lab_i["pos_equal_one"]
                ns_m[i] = lab_i["neg_equal_one"]
                ts_m[i] = lab_i["targets"]
            sample[f"pos_equal_one_single_{m}"] = ps_m
            sample[f"neg_equal_one_single_{m}"] = ns_m
            sample[f"targets_single_{m}"] = ts_m
        # per lidar modality its slot mask and the shared point buffers (the
        # model runs each branch over all slots and combines by the masks)
        for m in self.lidar_modalities:
            mmask = np.zeros(L, bool)
            for i, am in enumerate(agent_modalities):
                mmask[i] = am == m
            sample[f"points_{m}"] = points
            sample[f"point_mask_{m}"] = point_mask
            sample[f"modality_mask_{m}"] = mmask
        if not any(agent_modalities):
            sample["modality_mask_m1"] = agent_mask.copy()
        if self.adaptor is None and "modality_mask_m1" not in sample:
            sample["modality_mask_m1"] = agent_mask.copy()
        return sample

    def collate(self, samples) -> dict:
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
