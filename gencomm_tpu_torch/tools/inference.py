"""Evaluation entry point of the port: a trained run over synthetic frames,
VOC AP at IoU 0.3 / 0.5 / 0.7, per-frame and global-sort.

Counterpart of ``gencomm_tpu/tools/inference.py``:

    python -m gencomm_tpu_torch.tools.inference --model_dir <run> \
        --dataset synthetic [--frames N] [--ckpt <dir>] [--use_cav K] \
        [--range xmin,ymin,zmin,xmax,ymax,zmax] [--score_threshold T] \
        [--pos_std S --rot_std S [--laplace]] [--delay MS] \
        [--half] [--report_comm] [--device cuda|cpu]

The run's ``config.yaml`` builds the model; the checkpoint is ``--ckpt``,
else the run's bestval, else its latest. Frame f is
``sample(1000 + f, 1)``, its agents capped at ``--use_cav``, trimmed to the
agent buckets (2, 3, 5) and its pillar modalities decorated on the host (a
SECOND modality's raw points go to the device), then
``InferencePipeline.run`` with diffusion seed f. Writes ``eval.yaml`` and
``eval_global_sort.yaml`` (suffixed ``_<infer_info>``) into the run dir.
``--report_comm`` prints the GenComm message's payload of the last frame.
The robustness flags write the hypes' ``noise_setting`` (``--pos_std`` m,
``--rot_std`` degrees, ``--laplace``) and ``wild_setting`` (``--delay``
ms), which the sampler reads (``tools/train.py:build_dataset``); the
sweeps ``inference_w_noise`` and ``inference_w_delay`` call this tool once
a level. Runs on ``cuda`` unless ``--device cpu``. The BEV snapshots raise
(ROADMAP item 21), as do multi-class configs (item 19).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gencomm_tpu_torch import resolve_device
from gencomm_tpu_torch.config.yaml_utils import load_yaml, save_yaml, update_yaml
from gencomm_tpu_torch.data.bucketing import trim_agent_slots
from gencomm_tpu_torch.data.postprocessor import generate_anchor_box
from gencomm_tpu_torch.models import create_model
from gencomm_tpu_torch.pipeline import InferencePipeline, batch_to_device
from gencomm_tpu_torch.tools.train import DATASETS, build_dataset
from gencomm_tpu_torch.train import checkpoint
from gencomm_tpu_torch.utils import box_utils, eval_utils
from gencomm_tpu_torch.utils.misc_utils import code_stream_bytes, cpm_size_bytes


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--dataset", default="opv2v", choices=DATASETS)
    parser.add_argument("--frames", type=int, default=50)
    parser.add_argument("--pos_std", type=float, default=0.0)
    parser.add_argument("--rot_std", type=float, default=0.0)
    parser.add_argument("--laplace", action="store_true")
    parser.add_argument("--delay", type=int, default=0,
                        help="comm delay in ms (100 ms frames)")
    parser.add_argument("--infer_info", default=None)
    parser.add_argument("--ckpt", default=None,
                        help="evaluate this checkpoint dir instead of "
                             "bestval / latest")
    parser.add_argument("--score_threshold", type=float, default=None)
    parser.add_argument("--use_cav", type=int, default=0,
                        help="cap the number of collaborating agents; 0 = all")
    parser.add_argument("--report_comm", action="store_true",
                        help="report the transmitted payload's size")
    parser.add_argument("--save_vis_interval", type=int, default=0)
    parser.add_argument("--range", dest="det_range", default=None,
                        help="'xmin,ymin,zmin,xmax,ymax,zmax': override the "
                             "detection range and re-derive the anchor grid")
    parser.add_argument("--half", action="store_true",
                        help="bf16 activations (fp32 checkpoints load "
                             "unchanged)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def override_range(hypes: dict, det_range) -> dict:
    """The hypes with every range (data, anchors, model grids) set to
    ``det_range`` and the derivations run again."""
    rng_ = [float(v) for v in det_range]
    if len(rng_) != 6:
        raise ValueError("--range needs 6 comma-separated floats")
    hypes["cav_lidar_range"] = list(rng_)
    hypes["preprocess"]["cav_lidar_range"] = list(rng_)
    hypes["postprocess"]["anchor_args"]["cav_lidar_range"] = list(rng_)
    hypes["postprocess"]["gt_range"] = list(rng_)
    for setting in hypes.get("heter", {}).get("modality_setting", {}).values():
        setting.setdefault("preprocess", {})["cav_lidar_range"] = list(rng_)
    margs = hypes["model"].get("args", {})
    if "lidar_range" in margs:
        margs["lidar_range"] = list(rng_)
    for mcfg in margs.values():
        if isinstance(mcfg, dict) and "encoder_args" in mcfg \
                and "lidar_range" in mcfg["encoder_args"]:
            mcfg["encoder_args"]["lidar_range"] = list(rng_)
    return update_yaml(hypes)


def cap_agents(host: dict, use_cav: int) -> dict:
    """The frame with the agent and modality masks cleared from slot
    ``use_cav`` on."""
    host = dict(host)
    for k in list(host):
        if k == "agent_mask" or k.startswith("modality_mask_"):
            m = host[k].copy()
            m[:, use_cav:] = False
            host[k] = m
    return host


def comm_report(model, batch: dict, hypes: dict | None = None) -> dict:
    """The payload the valid non-ego agents of ``batch`` send: GenComm's
    2-channel message, else the per-agent BEV feature (``gt_feature``);
    fp16 bytes raw and deflated. A model whose output has neither (the HEAL
    pyramid, a model without generation) reports zero-width rows, 0 bytes,
    as the JAX package's report does (ROADMAP fault l).
    With the communication mask the share of cells sent (``comm_rate``).
    A CodeFilling model sends its code indices: the code stream's bytes
    per stage (packed, entropy bound, deflated; ``code_bytes_per_stage``)
    and their sums, with each stage's dictionary size from the hypes'
    ``codebook.dict_size`` (64 where it names none)."""
    with torch.inference_mode():
        out = model(batch, generator=torch.Generator(
            device=model.device).manual_seed(0))
    amask = batch["agent_mask"][0].cpu().numpy() > 0
    senders = np.nonzero(amask[1:])[0] + 1
    report = {}
    if "comm_rate" in out:
        report["comm_rate"] = float(out["comm_rate"])
    if out.get("message") is not None:
        payload = "gencomm_message_2ch"
        per_agent = out["message"][0].float().cpu().numpy()[senders]
    elif out.get("gt_feature") is not None:
        payload = "bev_feature"
        per_agent = out["gt_feature"].float().cpu().numpy().reshape(
            (amask.shape[0], -1))[senders]
    else:
        payload = "bev_feature"
        per_agent = np.zeros((len(senders), 0), np.float16)
    sizes = cpm_size_bytes(per_agent)
    report.update(payload=payload, n_senders=int(len(senders)),
                  cpm_bytes_fp16_raw=sizes["raw_bytes"],
                  cpm_bytes_fp16_deflate=sizes["compressed_bytes"])
    if out.get("codebook_codes") is not None:
        dict_sizes = ((hypes or {}).get("model", {}).get("args", {})
                      .get("codebook", {}).get("dict_size", [64, 64, 64]))
        if not isinstance(dict_sizes, (list, tuple)):
            dict_sizes = [dict_sizes]
        codes = out["codebook_codes"][0].cpu().numpy()[senders]
        per_stage = [code_stream_bytes(
            codes[:, s], int(dict_sizes[min(s, len(dict_sizes) - 1)]))
            for s in range(codes.shape[1])]
        report["payload"] = "codebook_codes"
        report["code_bytes_per_stage"] = per_stage
        for key, part in (("packed", "raw_bytes"),
                          ("entropy", "entropy_bytes"),
                          ("deflate", "compressed_bytes")):
            report[f"cpm_code_bytes_{key}"] = sum(s[part] for s in per_stage)
    return report


def robustness_settings(hypes: dict, args) -> dict:
    """The hypes with the robustness flags written as the JAX tool writes
    them: ``noise_setting`` where ``--pos_std`` or ``--rot_std`` is set,
    ``wild_setting`` where ``--delay`` is."""
    if args.pos_std or args.rot_std:
        hypes["noise_setting"] = {
            "add_noise": True, "add_pose_noise": True,
            "args": {"pos_std": args.pos_std, "rot_std": args.rot_std,
                     "laplace": args.laplace}}
    if args.delay:
        hypes["wild_setting"] = {"async": True, "async_overhead": args.delay}
    return hypes


def main(argv=None):
    args = parse_args(argv)
    if args.save_vis_interval:
        raise NotImplementedError(
            "--save_vis_interval is not ported yet (ROADMAP item 21)")
    device = resolve_device(args.device)

    hypes = load_yaml(None, args.model_dir)
    if args.half:
        hypes["model"]["args"]["half"] = True
    if args.det_range:
        hypes = override_range(hypes, args.det_range.split(","))
    hypes = robustness_settings(hypes, args)
    if args.score_threshold is not None:
        hypes["postprocess"]["target_args"]["score_threshold"] = \
            args.score_threshold
    if int(hypes["postprocess"].get("num_class", 1)) > 1:
        raise NotImplementedError(
            "multi-class evaluation is not ported yet (ROADMAP item 19)")

    np.random.seed(303)
    dataset = build_dataset(hypes, False, args.dataset)
    model = create_model(hypes, device=device)
    ckpt_path = args.ckpt or (checkpoint.bestval_checkpoint(args.model_dir)
                              or checkpoint.latest_checkpoint(args.model_dir))
    if not ckpt_path:
        raise FileNotFoundError(f"no checkpoint in {args.model_dir}")
    restored = checkpoint.load_checkpoint(ckpt_path)
    model.load_state_dict(checkpoint.load_into(model.state_dict(),
                                               restored["state_dict"]))
    print(f"loaded {ckpt_path}")
    anchors = generate_anchor_box(hypes["postprocess"]["anchor_args"],
                                  hypes["postprocess"].get("order", "hwl"))
    pipe = InferencePipeline(model, anchors, hypes["postprocess"],
                             device=device)

    stat = eval_utils.new_result_stat()
    host = None
    for f in range(args.frames):
        host = dataset.sample(1000 + f, 1)
        if args.use_cav:
            host = cap_agents(host, args.use_cav)
        host = pipe.decorate(trim_agent_slots(host,
                                              buckets=model.agent_buckets))
        dets = pipe.run(host, seed=f)
        valid = dets.valid[0].cpu().numpy()
        corners = dets.corners3d[0].cpu().numpy()[valid]
        scores = dets.scores[0].cpu().numpy()[valid]
        gt_boxes = host["gt_boxes"][0][host["gt_mask"][0] == 1]
        gt = box_utils.boxes_to_corners_3d(gt_boxes, "hwl")
        for t in (0.3, 0.5, 0.7):
            eval_utils.calculate_tp_fp(corners, scores, gt, stat, t)

    if args.report_comm and host is not None:
        print("comm report:", comm_report(model, batch_to_device(host, device),
                                          hypes))

    for global_sort in (False, True):
        res = eval_utils.eval_final_results(stat, global_sort)
        tag = "eval_global_sort" if global_sort else "eval"
        if args.infer_info:
            tag += f"_{args.infer_info}"
        save_yaml(res, os.path.join(args.model_dir, f"{tag}.yaml"))
        print(tag, {k: round(v, 4) for k, v in res.items()})
    return res


if __name__ == "__main__":
    main()
