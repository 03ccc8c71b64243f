"""Evaluation entry point of the port: a trained run over a dataset's
frames, VOC AP at IoU 0.3 / 0.5 / 0.7, per-frame and global-sort.

Counterpart of ``gencomm_tpu/tools/inference.py``:

    python -m gencomm_tpu_torch.tools.inference --model_dir <run> \
        --dataset opv2v|v2xset|v2xreal|synthetic [--frames N] [--ckpt <dir>] \
        [--use_cav K] \
        [--range xmin,ymin,zmin,xmax,ymax,zmax] [--score_threshold T] \
        [--pos_std S --rot_std S [--laplace]] [--delay MS] \
        [--half] [--report_comm] [--save_vis_interval N] \
        [--device cuda|cpu]

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
a level. ``--save_vis_interval N`` writes every N-th frame's BEV snapshot
(``visualization/simple_vis.py``, matplotlib) into ``<run>/vis``. Runs on
``cuda`` unless ``--device cpu``. A multi-class config (V2X-Real,
``postprocess.num_class`` > 1) is evaluated per class (``multiclass_eval``):
the pipeline's multi-class decode, VOC AP of each class at 0.3 / 0.5 / 0.7
and their means (``map30`` ...), written to ``eval_multiclass.yaml``.
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


def n_frames(args, dataset) -> int:
    """``--frames``, at most the real dataset's length."""
    if args.dataset == "synthetic":
        return args.frames
    return min(args.frames, len(dataset))


def frame(args, dataset, f: int, pipe, model) -> dict:
    """Frame f on the host: the loader's sample f (synthetic: ``sample(1000
    + f, 1)``), its agents capped at ``--use_cav``, trimmed to the model's
    agent buckets and its pillar modalities decorated."""
    if args.dataset == "synthetic":
        host = dataset.sample(1000 + f, 1)
    else:
        host = dataset.collate([dataset[f]])
    if args.use_cav:
        host = cap_agents(host, args.use_cav)
    return pipe.decorate(trim_agent_slots(host, buckets=model.agent_buckets))


def multiclass_eval(args, hypes, dataset, model, num_class: int,
                    device) -> dict:
    """Multi-class evaluation (the JAX tool's ``_multiclass_eval``): each
    frame through the pipeline's multi-class decode (diffusion seed f),
    each class's detections against its GT boxes at IoU 0.3 / 0.5 / 0.7;
    per-class VOC AP and the means, flattened (``<class>_ap30``, ...,
    ``map30``, ...), written to ``eval_multiclass[_<infer_info>].yaml`` and
    returned."""
    from gencomm_tpu_torch.data.postprocessor import (
        generate_anchor_box_multiclass,
    )
    from gencomm_tpu_torch.data.v2xreal import CLASS_NAMES

    pp = hypes["postprocess"]
    order = pp.get("order", "hwl")
    anchors_mc, _, _, class_names = generate_anchor_box_multiclass(
        pp["anchor_args"], order)
    if len(class_names) != num_class:
        class_names = list(CLASS_NAMES)[:num_class]
    pipe = InferencePipeline(model, anchors_mc, pp, device=device)
    stats = eval_utils.new_multiclass_stat(class_names)
    for f in range(n_frames(args, dataset)):
        host = frame(args, dataset, f, pipe, model)
        dets = pipe.run(host, seed=f)
        valid = dets.valid[0].cpu().numpy()
        corners = dets.corners3d[0].cpu().numpy()[valid]
        scores = dets.scores[0].cpu().numpy()[valid]
        labels = dets.labels[0].cpu().numpy()[valid]
        gmask = host["gt_mask"][0] == 1
        gt_cls = (np.asarray(host["gt_classes"][0])[gmask]
                  if "gt_classes" in host
                  else np.ones(int(gmask.sum()), np.int32))
        gtc = box_utils.boxes_to_corners_3d(host["gt_boxes"][0][gmask], order)
        for ci, cname in enumerate(class_names):
            csel, gsel = labels == ci + 1, gt_cls == ci + 1
            for t in (0.3, 0.5, 0.7):
                eval_utils.calculate_tp_fp(corners[csel], scores[csel],
                                           gtc[gsel], stats[cname], t)
    flat = {}
    for k, v in eval_utils.eval_multiclass_results(stats).items():
        if isinstance(v, dict):
            flat.update({f"{k}_{kk}": float(vv) for kk, vv in v.items()})
        else:
            flat[k] = float(v)
    tag = "eval_multiclass"
    if args.infer_info:
        tag += f"_{args.infer_info}"
    save_yaml(flat, os.path.join(args.model_dir, f"{tag}.yaml"))
    print(tag, {k: round(v, 4) for k, v in flat.items()})
    return flat


def main(argv=None):
    args = parse_args(argv)
    if args.save_vis_interval:
        # the snapshots draw with matplotlib: fail before any frame runs
        # where it is missing
        import matplotlib  # noqa: F401
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
    num_class = int(hypes["postprocess"].get("num_class", 1))
    if num_class > 1:
        return multiclass_eval(args, hypes, dataset, model, num_class,
                               device)
    anchors = generate_anchor_box(hypes["postprocess"]["anchor_args"],
                                  hypes["postprocess"].get("order", "hwl"))
    pipe = InferencePipeline(model, anchors, hypes["postprocess"],
                             device=device)

    stat = eval_utils.new_result_stat()
    host = None
    for f in range(n_frames(args, dataset)):
        host = frame(args, dataset, f, pipe, model)
        dets = pipe.run(host, seed=f)
        valid = dets.valid[0].cpu().numpy()
        corners = dets.corners3d[0].cpu().numpy()[valid]
        scores = dets.scores[0].cpu().numpy()[valid]
        gt_boxes = host["gt_boxes"][0][host["gt_mask"][0] == 1]
        gt = box_utils.boxes_to_corners_3d(gt_boxes, "hwl")
        for t in (0.3, 0.5, 0.7):
            eval_utils.calculate_tp_fp(corners, scores, gt, stat, t)
        if args.save_vis_interval and f % args.save_vis_interval == 0:
            from gencomm_tpu_torch.visualization import simple_vis

            vis_dir = os.path.join(args.model_dir, "vis")
            os.makedirs(vis_dir, exist_ok=True)
            # a decorated pillar modality has no raw points left
            pts_key = next((k for k in host if k.startswith("points_")),
                           None)
            pts = (host[pts_key][0].reshape(-1, host[pts_key].shape[-1])
                   if pts_key else None)
            simple_vis.visualize(corners, gt, pts,
                                 hypes["postprocess"]["gt_range"],
                                 os.path.join(vis_dir, f"bev_{f:05d}.png"))

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
