"""CoAlign's pose-graph tools: stage-1 boxes, then the refinement's error.

Counterpart of ``gencomm_tpu/tools/pose_graph.py``:

    python -m gencomm_tpu_torch.tools.pose_graph precalc --out DIR \
        [--frames N]
    python -m gencomm_tpu_torch.tools.pose_graph evaluate --out DIR \
        [--device cuda|cpu]

``precalc`` writes ``DIR/stage1_boxes.json``: per synthetic frame
(``sample(1000 + f, 1)``) every agent's boxes (the GT with a 0.1 m jitter of
their centers, a stand-in for a stage-1 model's detections, as in the JAX
tool), masks, scores and lidar poses. ``evaluate`` perturbs every non-ego
pose by sigma = 0.2, 0.4 and 0.6 (m for x and y, degrees for yaw), refines
the poses with ``models/coalign.refine_poses_np`` on the device (``cuda``
unless ``--device cpu``) and reports the mean position error before and
after.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from gencomm_tpu_torch.models.coalign import refine_poses_np


def precalc(args):
    """Writes the frames' per-agent boxes to ``stage1_boxes.json``."""
    from gencomm_tpu_torch.data.synthetic import (
        SyntheticConfig, SyntheticScenes,
    )

    scenes = SyntheticScenes(SyntheticConfig())
    os.makedirs(args.out, exist_ok=True)
    records = {}
    for f in range(args.frames):
        batch = scenes.sample(1000 + f, 1)
        gt = batch["gt_boxes"][0]
        gm = batch["gt_mask"][0]
        rng = np.random.default_rng(f)
        l = batch["agent_mask"].shape[1]
        boxes = np.tile(gt[None], (l, 1, 1))
        boxes[..., :2] += rng.normal(0, 0.1, boxes[..., :2].shape)
        masks = np.tile(gm[None], (l, 1))
        records[str(f)] = {
            "boxes": boxes.tolist(),
            "masks": masks.tolist(),
            "scores": np.clip(rng.uniform(0.5, 1.0, masks.shape) * masks,
                              0, 1).tolist(),
            "lidar_poses": batch["lidar_poses"][0].tolist()
            if "lidar_poses" in batch else np.zeros((l, 6)).tolist(),
        }
    path = os.path.join(args.out, "stage1_boxes.json")
    with open(path, "w") as fobj:
        json.dump(records, fobj)
    print("wrote", path)
    return path


def evaluate(args):
    """{"std_<s>": {"pos_err_noisy_m", "pos_err_refined_m"}} over the
    records, the noise drawn from ``default_rng(303)``."""
    with open(os.path.join(args.out, "stage1_boxes.json")) as fobj:
        records = json.load(fobj)
    rng = np.random.default_rng(303)
    report = {}
    for std in (0.2, 0.4, 0.6):
        errs_before, errs_after = [], []
        for rec in records.values():
            boxes = np.asarray(rec["boxes"], np.float32)
            masks = np.asarray(rec["masks"], np.float32)
            poses = np.asarray(rec["lidar_poses"], np.float64)
            noisy = poses.copy()
            noisy[1:, 0] += rng.normal(0, std, len(noisy) - 1)
            noisy[1:, 1] += rng.normal(0, std, len(noisy) - 1)
            noisy[1:, 4] += rng.normal(0, std, len(noisy) - 1)
            refined = refine_poses_np(boxes, masks, noisy, device=args.device)
            errs_before.append(np.abs(noisy[1:, :2] - poses[1:, :2]).mean())
            errs_after.append(np.abs(refined[1:, :2] - poses[1:, :2]).mean())
        report[f"std_{std}"] = {
            "pos_err_noisy_m": float(np.mean(errs_before)),
            "pos_err_refined_m": float(np.mean(errs_after)),
        }
    print(json.dumps(report, indent=2))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("precalc")
    p.add_argument("--out", default="pose_graph_out")
    p.add_argument("--frames", type=int, default=10)
    e = sub.add_parser("evaluate")
    e.add_argument("--out", default="pose_graph_out")
    e.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return {"precalc": precalc, "evaluate": evaluate}[args.cmd](args)


if __name__ == "__main__":
    main()
