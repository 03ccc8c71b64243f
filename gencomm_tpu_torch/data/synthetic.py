"""Synthetic multi-agent V2X scenes: eval fields and anchor labels.

Counterpart of ``gencomm_tpu/data/synthetic.py`` (``SyntheticScenes.sample``)
for lidar and camera modalities: points or rendered camera images with
their calibration and GT depth maps, masks, pairwise transforms and GT
boxes, drawn from the same numpy RNG stream, so the same seed gives the
same arrays, and the ego-frame anchor labels ``pos_equal_one``,
``neg_equal_one`` and ``targets`` (``generate_label``, which draws no random
numbers). With ``per_agent_labels`` it also labels each agent slot on the
same anchors in its own frame (``pos_equal_one_single``,
``neg_equal_one_single``, ``targets_single`` of shape (B, L, ...), the GT
projected through world -> agent), which the ``supervise_single`` and HEAL
pyramid losses read; those draw no random numbers, so the other arrays do
not change.

The robustness knobs, as in the JAX package: ``pos_std`` / ``rot_std``
(``laplace_noise`` for Laplace draws) perturb every agent's pose estimate,
from which the pairwise transforms are built, while points, images and GT
stay on the true poses; ``delay_ms`` makes the non-ego agents observe the
vehicles stale, each moved back along its heading by a speed drawn up to
``vehicle_speed_max`` times the delay. Both draw from a stream of their own
(seeded ``((seed * 131 + b) ^ 0x5EED) % 2**32``), so the scenes are the
same bits at every setting.
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
    # per-agent anchor labels in each agent's own frame (supervise_single,
    # the HEAL pyramid's occupancy loss)
    per_agent_labels: bool = False
    # name -> {"sensor": "lidar"} or {"sensor": "camera", "final_dim":
    # (H, W), "ncam": 4, "focal": f}; agent slots take the listed
    # modalities round-robin, the ego the first
    modalities: dict = field(
        default_factory=lambda: {"m1": {"sensor": "lidar"}}
    )
    # the robustness knobs (the hypes' noise_setting and wild_setting): the
    # pose estimates' noise, x and y in m, yaw in degrees, and the
    # communication delay in ms with the vehicles' top speed in m/s
    pos_std: float = 0.0
    rot_std: float = 0.0
    laplace_noise: bool = False
    delay_ms: float = 0.0
    vehicle_speed_max: float = 8.0
    # cap the vehicles' spawn distance from the ego (0 = anywhere in
    # lidar_range); camera-labelled configs set it to the depth
    # discretization's d_max - 2 so that every GT box is visible
    max_spawn_radius: float = 0.0


class SyntheticScenes:
    def __init__(self, cfg: SyntheticConfig | None = None):
        self.cfg = cfg or SyntheticConfig()
        c = self.cfg
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

    def _render_cams(self, rng, veh_world, veh_color, ground_world,
                     world_to_agent, camcfg):
        """Project the scene's points into ``ncam`` pinhole cameras ringed
        around the agent (painter's algorithm, far first): images, camera ->
        agent rotations and translations, intrinsics and dense GT depth
        (1000 m where nothing is seen)."""
        h, w = camcfg.get("final_dim", (384, 512))
        ncam = int(camcfg.get("ncam", 4))
        f = float(camcfg.get("focal", 0.5 * w / np.tan(np.radians(50.0))))
        cam_h = 1.5
        imgs = rng.uniform(0, 0.08, (ncam, h, w, 3)).astype(np.float32)
        depths = np.full((ncam, h, w), 1000.0, np.float32)
        rots = np.zeros((ncam, 3, 3), np.float32)
        trans = np.tile(np.array([0.0, 0.0, cam_h], np.float32), (ncam, 1))
        K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
        intrins = np.tile(K, (ncam, 1, 1))

        def to_agent(pts_world):
            hom = np.concatenate(
                [pts_world, np.ones((len(pts_world), 1))], 1)
            return (hom @ world_to_agent.T)[:, :3].astype(np.float32)

        veh_local = to_agent(veh_world)
        gnd_local = to_agent(ground_world)
        for k in range(ncam):
            yaw = 2 * np.pi * k / ncam
            cy, sy = np.cos(yaw), np.sin(yaw)
            # columns: the camera's x (right), y (down), z (forward) axes in
            # the agent frame
            R = np.array([[sy, 0, cy],
                          [-cy, 0, sy],
                          [0, -1, 0]], np.float32)
            rots[k] = R
            for pts, vals in ((gnd_local, None), (veh_local, veh_color)):
                pc = (pts - trans[k]) @ R
                z = pc[:, 2]
                keep = z > 1.0
                u = (f * pc[:, 0] / np.maximum(z, 1e-3) + w / 2).astype(
                    np.int32)
                v = (f * pc[:, 1] / np.maximum(z, 1e-3) + h / 2).astype(
                    np.int32)
                keep &= (u >= 0) & (u < w) & (v >= 0) & (v < h)
                idx = np.nonzero(keep)[0]
                idx = idx[np.argsort(-z[idx])]
                depth_val = np.exp(-z[idx] / 40.0).astype(np.float32)
                if vals is None:
                    imgs[k, v[idx], u[idx]] = np.stack(
                        [np.full_like(depth_val, 0.15), depth_val,
                         np.full_like(depth_val, 0.1)], axis=1)
                else:
                    imgs[k, v[idx], u[idx]] = np.stack(
                        [np.ones_like(depth_val), depth_val,
                         vals[idx].astype(np.float32)], axis=1)
                depths[k, v[idx], u[idx]] = z[idx].astype(np.float32)
        return imgs, rots, trans, intrins, depths

    def sample(self, seed: int, batch_size: int = 1) -> dict:
        """A batch dict of numpy arrays: model inputs, labels and eval GT."""
        rng = np.random.RandomState(seed % (2 ** 32))
        c = self.cfg
        B, L, P = batch_size, c.max_cav, c.points_per_agent
        mod_names = list(c.modalities)
        cam_mods = {m: mc for m, mc in c.modalities.items()
                    if mc.get("sensor", "lidar") == "camera"}
        lidar_mods = [m for m in mod_names if m not in cam_mods]
        points_mod = {m: np.zeros((B, L, P, 4), np.float32)
                      for m in lidar_mods}
        point_mask_mod = {m: np.zeros((B, L, P), bool) for m in lidar_mods}
        modality_mask = {m: np.zeros((B, L), bool) for m in mod_names}
        cam_arrays = {}
        for m, mc in cam_mods.items():
            h, w = mc.get("final_dim", (384, 512))
            ncam = int(mc.get("ncam", 4))
            eye = np.tile(np.eye(3, dtype=np.float32), (B, L, ncam, 1, 1))
            cam_arrays[m] = {
                "depths": np.zeros((B, L, ncam, h, w), np.float32),
                "imgs": np.zeros((B, L, ncam, h, w, 3), np.float32),
                "rots": eye.copy(),
                "trans": np.zeros((B, L, ncam, 3), np.float32),
                "intrins": eye.copy(),
                "post_rots": eye.copy(),
                "post_trans": np.zeros((B, L, ncam, 3), np.float32),
            }
        agent_mask = np.zeros((B, L), bool)
        pairwise = np.tile(np.eye(4, dtype=np.float32), (B, L, L, 1, 1))
        pos = np.zeros((B,) + self.anchors.shape[:3], np.float32)
        neg = np.zeros_like(pos)
        targets = np.zeros((B,) + self.anchors.shape[:2]
                           + (self.anchors.shape[2] * 7,), np.float32)
        gt_boxes = np.zeros((B, c.max_gt, 7), np.float32)
        gt_mask = np.zeros((B, c.max_gt), np.float32)
        if c.per_agent_labels:
            pos_single = np.zeros((B, L) + pos.shape[1:], np.float32)
            neg_single = np.zeros_like(pos_single)
            tgt_single = np.zeros((B, L) + targets.shape[1:], np.float32)

        for b in range(B):
            na = c.num_agents
            agent_mask[b, :na] = True
            poses = np.zeros((na, 6))
            for i in range(1, na):
                poses[i, 0] = rng.uniform(-c.comm_range / 2, c.comm_range / 2)
                poses[i, 1] = rng.uniform(-20, 20)
                poses[i, 4] = rng.uniform(-180, 180)
            # the pose estimates of the warp: the true poses plus noise drawn
            # from a stream of its own (a seed may exceed 2**32)
            nrng = np.random.RandomState(((seed * 131 + b) ^ 0x5EED)
                                         % (2 ** 32))
            est_poses = poses.copy()
            if c.pos_std > 0 or c.rot_std > 0:
                draw = nrng.laplace if c.laplace_noise else nrng.normal
                for i in range(na):
                    est_poses[i, 0] += draw(0.0, c.pos_std or 1e-12)
                    est_poses[i, 1] += draw(0.0, c.pos_std or 1e-12)
                    est_poses[i, 4] += draw(0.0, c.rot_std or 1e-12)
            pairwise[b, :, :] = get_pairwise_transformation(
                est_poses, L, na).astype(np.float32)

            nv = c.num_vehicles
            boxes = np.zeros((nv, 7), np.float32)
            boxes[:, 0] = rng.uniform(c.lidar_range[0] * 0.9, c.lidar_range[3] * 0.9, nv)
            boxes[:, 1] = rng.uniform(c.lidar_range[1] * 0.9, c.lidar_range[4] * 0.9, nv)
            if c.max_spawn_radius > 0:
                # resample the vehicles beyond the radius in polar form
                far = np.hypot(boxes[:, 0], boxes[:, 1]) > c.max_spawn_radius
                if far.any():
                    nfar = int(far.sum())
                    rr = rng.uniform(8.0, c.max_spawn_radius, nfar)
                    th = rng.uniform(-np.pi, np.pi, nfar)
                    boxes[far, 0] = np.clip(rr * np.cos(th),
                                            c.lidar_range[0] * 0.9,
                                            c.lidar_range[3] * 0.9)
                    boxes[far, 1] = np.clip(rr * np.sin(th),
                                            c.lidar_range[1] * 0.9,
                                            c.lidar_range[4] * 0.9)
            boxes[:, 2] = rng.uniform(-1.2, -0.8, nv)
            boxes[:, 3] = rng.uniform(1.4, 1.8, nv)  # h
            boxes[:, 4] = rng.uniform(1.7, 2.1, nv)  # w
            boxes[:, 5] = rng.uniform(3.9, 4.8, nv)  # l
            boxes[:, 6] = rng.uniform(-np.pi, np.pi, nv)
            gt_boxes[b, :nv] = boxes
            gt_mask[b, :nv] = 1.0
            # the delay: the non-ego agents see the vehicles moved back
            # along their heading
            stale_boxes = boxes
            if c.delay_ms > 0:
                spd = nrng.uniform(0.0, c.vehicle_speed_max, nv)
                dt = c.delay_ms / 1000.0
                stale_boxes = boxes.copy()
                stale_boxes[:, 0] -= spd * np.cos(boxes[:, 6]) * dt
                stale_boxes[:, 1] -= spd * np.sin(boxes[:, 6]) * dt

            for i in range(na):
                mk = mod_names[i % len(mod_names)]
                modality_mask[mk][b, i] = True
                world_to_agent = np.linalg.inv(x_to_world(poses[i]))
                obs_boxes = boxes if i == 0 else stale_boxes
                veh = np.concatenate([
                    self._sample_vehicle_points(rng, obs_boxes[v])
                    for v in range(nv)], 0)
                if mk in cam_mods:
                    veh_color = np.repeat(
                        0.3 + 0.7 * ((np.arange(nv) * 37) % 100) / 100.0,
                        c.points_per_vehicle)
                    ground = np.stack([
                        rng.uniform(c.lidar_range[0], c.lidar_range[3], 2048),
                        rng.uniform(c.lidar_range[1], c.lidar_range[4], 2048),
                        rng.uniform(-2.0, -1.9, 2048),
                    ], axis=1)
                    imgs, rots, trans, intrins, dmaps = self._render_cams(
                        rng, veh, veh_color, ground, world_to_agent,
                        cam_mods[mk])
                    ca = cam_arrays[mk]
                    ca["imgs"][b, i] = imgs
                    ca["rots"][b, i] = rots
                    ca["trans"][b, i] = trans
                    ca["intrins"][b, i] = intrins
                    ca["depths"][b, i] = dmaps
                    continue
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

            if c.per_agent_labels:
                # the GT projected into each agent's frame, labelled on the
                # same anchors
                corners = box_utils.boxes_to_corners_3d(gt_boxes[b, :nv],
                                                        "hwl")
                for i in range(na):
                    world_to_agent = np.linalg.inv(x_to_world(poses[i]))
                    proj = box_utils.project_box3d(
                        corners, world_to_agent.astype(np.float32))
                    padded = np.zeros_like(gt_boxes[b])
                    padded[:nv] = box_utils.corner_to_center(proj, order="hwl")
                    lab_i = generate_label(padded, gt_mask[b], self.anchors,
                                           c.pos_threshold, c.neg_threshold)
                    pos_single[b, i] = lab_i["pos_equal_one"]
                    neg_single[b, i] = lab_i["neg_equal_one"]
                    tgt_single[b, i] = lab_i["targets"]

        batch = {
            "agent_mask": agent_mask,
            "pairwise_t_matrix": pairwise,
            "pos_equal_one": pos,
            "neg_equal_one": neg,
            "targets": targets,
            "gt_boxes": gt_boxes,
            "gt_mask": gt_mask,
        }
        for m in lidar_mods:
            batch[f"points_{m}"] = points_mod[m]
            batch[f"point_mask_{m}"] = point_mask_mod[m]
            batch[f"modality_mask_{m}"] = modality_mask[m]
        for m, ca in cam_arrays.items():
            for k, v in ca.items():
                batch[f"{k}_{m}"] = v
            batch[f"modality_mask_{m}"] = modality_mask[m]
        if c.per_agent_labels:
            batch["pos_equal_one_single"] = pos_single
            batch["neg_equal_one_single"] = neg_single
            batch["targets_single"] = tgt_single
        return batch

    def gt_corners(self, batch: dict, b: int) -> np.ndarray:
        boxes = batch["gt_boxes"][b][batch["gt_mask"][b] == 1]
        return box_utils.boxes_to_corners_3d(boxes, "hwl")
