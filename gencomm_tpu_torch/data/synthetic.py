"""Synthetic multi-agent V2X scenes: eval fields and anchor labels.

Counterpart of ``gencomm_tpu/data/synthetic.py`` (``SyntheticScenes.sample``)
for lidar modalities: points, masks, pairwise transforms and GT boxes, drawn
from the same numpy RNG stream, so the same seed gives the same arrays, and
the ego-frame anchor labels ``pos_equal_one``, ``neg_equal_one`` and
``targets`` (``generate_label``, which draws no random numbers). Per-agent
labels, camera rendering and the robustness knobs (pose noise, delay, spawn
radius) belong to later slices.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from gencomm_tpu_torch.data.postprocessor import (
    generate_anchor_box,
    generate_label,
)
from gencomm_tpu_torch.utils import box_utils
from gencomm_tpu_torch.utils.transformation_utils import (
    get_pairwise_transformation,
    x_to_world,
)


@dataclass
class SyntheticConfig:
    lidar_range: tuple = (-102.4, -51.2, -3.0, 102.4, 51.2, 1.0)
    voxel_size: tuple = (0.4, 0.4, 4.0)
    feature_stride: int = 4
    max_cav: int = 5
    num_agents: int = 2
    points_per_agent: int = 20000
    num_vehicles: int = 12
    points_per_vehicle: int = 300
    max_gt: int = 150
    comm_range: float = 70.0
    anchor_l: float = 3.9
    anchor_w: float = 1.6
    anchor_h: float = 1.56
    anchor_yaw_deg: tuple = (0.0, 90.0)
    pos_threshold: float = 0.6
    neg_threshold: float = 0.45
    # per-agent labels (supervise_single) are not ported: True raises
    per_agent_labels: bool = False
    modalities: dict = field(
        default_factory=lambda: {"m1": {"sensor": "lidar"}}
    )


class SyntheticScenes:
    def __init__(self, cfg: SyntheticConfig | None = None):
        self.cfg = cfg or SyntheticConfig()
        c = self.cfg
        cams = [m for m, mc in c.modalities.items()
                if mc.get("sensor", "lidar") == "camera"]
        if cams:
            raise NotImplementedError(
                f"camera modalities {cams} are not ported yet")
        if c.per_agent_labels:
            raise NotImplementedError(
                "per-agent labels (supervise_single) are not ported yet")
        W = int(round((c.lidar_range[3] - c.lidar_range[0]) / c.voxel_size[0]))
        H = int(round((c.lidar_range[4] - c.lidar_range[1]) / c.voxel_size[1]))
        self.anchor_args = {
            "W": W, "H": H,
            "l": c.anchor_l, "w": c.anchor_w, "h": c.anchor_h,
            "r": list(c.anchor_yaw_deg),
            "vw": c.voxel_size[0], "vh": c.voxel_size[1],
            "cav_lidar_range": list(c.lidar_range),
            "feature_stride": c.feature_stride,
            "num": len(c.anchor_yaw_deg),
        }
        self.anchors = generate_anchor_box(self.anchor_args)

    def _sample_vehicle_points(self, rng, box7):
        """Lidar-like points on the 4 side faces of one (hwl) box."""
        c = self.cfg
        n = c.points_per_vehicle
        x, y, z, h, w, l, yaw = box7
        side = rng.randint(0, 4, n)
        u = rng.uniform(-0.5, 0.5, n)
        v = rng.uniform(-0.5, 0.5, n)
        lx = np.where(side < 2, u * l, np.where(side == 2, l / 2, -l / 2))
        ly = np.where(side >= 2, u * w, np.where(side == 0, w / 2, -w / 2))
        lz = v * h
        cy, sy = np.cos(yaw), np.sin(yaw)
        return np.stack([x + lx * cy - ly * sy, y + lx * sy + ly * cy, z + lz],
                        axis=1)

    def sample(self, seed: int, batch_size: int = 1) -> dict:
        """A batch dict of numpy arrays: model inputs, labels and eval GT."""
        rng = np.random.RandomState(seed % (2 ** 32))
        c = self.cfg
        B, L, P = batch_size, c.max_cav, c.points_per_agent
        mod_names = list(c.modalities)
        points_mod = {m: np.zeros((B, L, P, 4), np.float32) for m in mod_names}
        point_mask_mod = {m: np.zeros((B, L, P), bool) for m in mod_names}
        modality_mask = {m: np.zeros((B, L), bool) for m in mod_names}
        agent_mask = np.zeros((B, L), bool)
        pairwise = np.tile(np.eye(4, dtype=np.float32), (B, L, L, 1, 1))
        pos = np.zeros((B,) + self.anchors.shape[:3], np.float32)
        neg = np.zeros_like(pos)
        targets = np.zeros((B,) + self.anchors.shape[:2]
                           + (self.anchors.shape[2] * 7,), np.float32)
        gt_boxes = np.zeros((B, c.max_gt, 7), np.float32)
        gt_mask = np.zeros((B, c.max_gt), np.float32)

        for b in range(B):
            na = c.num_agents
            agent_mask[b, :na] = True
            poses = np.zeros((na, 6))
            for i in range(1, na):
                poses[i, 0] = rng.uniform(-c.comm_range / 2, c.comm_range / 2)
                poses[i, 1] = rng.uniform(-20, 20)
                poses[i, 4] = rng.uniform(-180, 180)
            pairwise[b, :, :] = get_pairwise_transformation(
                poses, L, na).astype(np.float32)

            nv = c.num_vehicles
            boxes = np.zeros((nv, 7), np.float32)
            boxes[:, 0] = rng.uniform(c.lidar_range[0] * 0.9, c.lidar_range[3] * 0.9, nv)
            boxes[:, 1] = rng.uniform(c.lidar_range[1] * 0.9, c.lidar_range[4] * 0.9, nv)
            boxes[:, 2] = rng.uniform(-1.2, -0.8, nv)
            boxes[:, 3] = rng.uniform(1.4, 1.8, nv)  # h
            boxes[:, 4] = rng.uniform(1.7, 2.1, nv)  # w
            boxes[:, 5] = rng.uniform(3.9, 4.8, nv)  # l
            boxes[:, 6] = rng.uniform(-np.pi, np.pi, nv)
            gt_boxes[b, :nv] = boxes
            gt_mask[b, :nv] = 1.0

            for i in range(na):
                mk = mod_names[i % len(mod_names)]
                modality_mask[mk][b, i] = True
                world_to_agent = np.linalg.inv(x_to_world(poses[i]))
                veh = np.concatenate([
                    self._sample_vehicle_points(rng, boxes[v])
                    for v in range(nv)], 0)
                nground = P - len(veh)
                ground = np.stack([
                    rng.uniform(c.lidar_range[0], c.lidar_range[3], nground),
                    rng.uniform(c.lidar_range[1], c.lidar_range[4], nground),
                    rng.uniform(-2.0, -1.9, nground),
                ], axis=1)
                allpts = np.concatenate([veh, ground], 0)
                hom = np.concatenate([allpts, np.ones((P, 1))], 1)
                points_mod[mk][b, i, :, :3] = (hom @ world_to_agent.T)[:, :3]
                points_mod[mk][b, i, :, 3] = rng.uniform(0, 1, P)
                point_mask_mod[mk][b, i] = True

            label = generate_label(gt_boxes[b], gt_mask[b], self.anchors,
                                   c.pos_threshold, c.neg_threshold)
            pos[b] = label["pos_equal_one"]
            neg[b] = label["neg_equal_one"]
            targets[b] = label["targets"]

        batch = {
            "agent_mask": agent_mask,
            "pairwise_t_matrix": pairwise,
            "pos_equal_one": pos,
            "neg_equal_one": neg,
            "targets": targets,
            "gt_boxes": gt_boxes,
            "gt_mask": gt_mask,
        }
        for m in mod_names:
            batch[f"points_{m}"] = points_mod[m]
            batch[f"point_mask_{m}"] = point_mask_mod[m]
            batch[f"modality_mask_{m}"] = modality_mask[m]
        return batch

    def gt_corners(self, batch: dict, b: int) -> np.ndarray:
        boxes = batch["gt_boxes"][b][batch["gt_mask"][b] == 1]
        return box_utils.boxes_to_corners_3d(boxes, "hwl")
