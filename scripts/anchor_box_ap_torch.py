#!/usr/bin/env python3
"""AP of the anchor boxes on the frames the port's inference command line
evaluates, on the CPU, with no model: which pre-NMS top-K lets a lattice of
anchors reach the synthetic ground truth at IoU 0.3?

    python3 scripts/anchor_box_ap_torch.py [-y CONFIG] [--frames 4] \
        [--topk 512,4096] [--logits 0,0 1,0] \
        [--range xmin,ymin,zmin,xmax,ymax,zmax]

Heads with their weights zeroed give every anchor its own box (no
regression, the first direction bin) and the score of its type's bias
(``--logits``, one logit per anchor type: yaw 0, yaw 90). The frames are
those of ``gencomm_tpu_torch.tools.inference`` with ``--dataset
synthetic`` (and its ``--range``, which sets the detection range, the
anchor grid and the sampler's range): ``np.random.seed(303)``, then
``sample(1000 + f, 1)``. Each
case decodes with ``decode_and_nms`` (the plain NMS on the CPU) and scores
with ``eval_utils`` at IoU 0.3 / 0.5 / 0.7. It also reports how many ground
truth boxes some anchor reaches at IoU 0.3 at all. One JSON object per case
goes to standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gencomm_tpu_torch.config.yaml_utils import load_yaml  # noqa: E402
from gencomm_tpu_torch.data.postprocessor import (  # noqa: E402
    decode_and_nms, generate_anchor_box,
)
from gencomm_tpu_torch.tools.inference import override_range  # noqa: E402
from gencomm_tpu_torch.tools.train import build_dataset  # noqa: E402
from gencomm_tpu_torch.utils import box_utils, eval_utils  # noqa: E402

DEFAULT_YAML = os.path.join("configs", "opv2v", "gencomm", "stage2",
                            "m1m2_att.yaml")


def gt_corners(host):
    boxes = host["gt_boxes"][0][host["gt_mask"][0] == 1]
    return box_utils.boxes_to_corners_3d(boxes, "hwl")


def reachable(anchors, gt, radius=4.0):
    """How many GT boxes some anchor within ``radius`` m overlaps at IoU
    0.3 or more."""
    flat = anchors.reshape(-1, 7).numpy()
    corners = box_utils.boxes_to_corners_3d(flat, "hwl")
    centres = gt[:, :4, :2].mean(axis=1)
    n = 0
    for g, c in zip(gt, centres):
        near = np.all(np.abs(flat[:, :2] - c) < radius, axis=1)
        stat = eval_utils.new_result_stat()
        eval_utils.calculate_tp_fp(corners[near],
                                   np.ones(int(near.sum()), np.float32),
                                   g[None], stat, 0.3)
        n += int(sum(stat[0.3]["tp"]) > 0)
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-y", "--yaml", default=DEFAULT_YAML)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--topk", default="512,4096")
    ap.add_argument("--logits", nargs="+", default=["0,0", "1,0"])
    ap.add_argument("--range", dest="det_range", default=None)
    args = ap.parse_args(argv)

    hypes = load_yaml(args.yaml)
    if args.det_range:
        hypes = override_range(hypes, args.det_range.split(","))
    pp = hypes["postprocess"]
    np.random.seed(303)
    dataset = build_dataset(hypes, False, "synthetic")
    anchors = torch.as_tensor(np.asarray(generate_anchor_box(
        pp["anchor_args"], pp.get("order", "hwl"))), dtype=torch.float32)
    h, w, a = anchors.shape[:3]
    frames = [dataset.sample(1000 + f, 1) for f in range(args.frames)]
    gts = [gt_corners(host) for host in frames]
    n_gt = sum(len(g) for g in gts)
    n_reach = sum(reachable(anchors, g) for g in gts)
    for topk in (int(k) for k in args.topk.split(",")):
        for logits in args.logits:
            bias = torch.tensor([float(v) for v in logits.split(",")])
            stat = eval_utils.new_result_stat()
            kept = []
            for gt in gts:
                dets = decode_and_nms(
                    bias.expand(h, w, a).contiguous(),
                    torch.zeros(h, w, a * 7),
                    torch.zeros(h, w, a * pp["dir_args"]["num_bins"]),
                    anchors, torch.eye(4), pp["gt_range"],
                    score_threshold=pp["target_args"]["score_threshold"],
                    nms_thresh=pp["nms_thresh"], topk=topk,
                    dir_offset=pp["dir_args"]["dir_offset"],
                    num_bins=pp["dir_args"]["num_bins"],
                    order=pp.get("order", "hwl"))
                valid = dets.valid.numpy()
                kept.append(int(valid.sum()))
                for t in (0.3, 0.5, 0.7):
                    eval_utils.calculate_tp_fp(
                        dets.corners3d.numpy()[valid],
                        dets.scores.numpy()[valid], gt, stat, t)
            print(json.dumps({
                "config": args.yaml, "range": args.det_range,
                "frames": args.frames, "anchors":
                h * w * a, "topk": topk, "logits": logits, "gt": n_gt,
                "gt_reachable_at_0.3": n_reach, "kept_per_frame": kept,
                "tp": {str(t): int(sum(stat[t]["tp"])) for t in stat},
                "ap": eval_utils.eval_final_results(stat)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
