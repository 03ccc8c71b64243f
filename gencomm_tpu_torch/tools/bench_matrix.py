"""Frames a second of the repo's benchmark configs through the port.

Counterpart of ``gencomm_tpu/tools/bench_matrix.py``:

    python -m gencomm_tpu_torch.tools.bench_matrix [--iters N] \
        [--only a,b] [--added_cost] [--half] [--device cuda|cpu]

Each row builds a shipped yaml (``create_model``, seeded random weights),
synthesizes a batch of the config's layout (``synthetic_batch_for_hypes``:
the sampler's scene points for lidar modalities, random camera stacks at
the config's ``final_dim`` for camera ones, trimmed to the agent buckets,
pillar modalities decorated on the host) and runs the whole
``InferencePipeline`` (model, decode, rotated NMS): ms a frame looped
(``run``) and streamed (``run_stream``), by CUDA events on a card (by the
host clock on the CPU, which is not a device time), the first frame's
seconds, and parameters in M, one JSON line a row. ``DEFAULT_CONFIGS`` are
the JAX tool's five; ``--added_cost`` times the five heterogeneous methods
on the same m1 + m2 agents against the plain multi-modality model and
prints what each adds. A row the port cannot build or run prints
``{"config", "error"}``, as the JAX tool does, and the matrix goes on. Runs
on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from gencomm_tpu_torch import resolve_device

DEFAULT_CONFIGS = [
    ("pp_late_opv2v", "configs/opv2v/point_pillar_late_fusion.yaml", "late"),
    ("pp_att_opv2v", "configs/opv2v/point_pillar_att.yaml", "intermediate"),
    ("lss_v2xvit_opv2v", "configs/opv2v/camera_only/camera_v2xvit.yaml",
     "intermediate"),
    ("backalign_m1m2_opv2v", "configs/opv2v/backalign_m1m2.yaml",
     "intermediate"),
    ("gencomm_s2_dairv2x", "configs/dairv2x/gencomm_stage2_m1m2.yaml",
     "intermediate"),
]

# the five heterogeneous methods on the same m1 + m2 (PointPillars lidar +
# LSS camera) agents, and the plain multi-modality model they add to
HETERO_BASE = ("base_m1m2",
               "configs/opv2v/more_modality/2_modality_end2end/m1m2_att.yaml")
HETERO_METHODS = [
    ("gencomm_m1m2", "configs/opv2v/gencomm_stage2_m1m2.yaml"),
    ("backalign_m1m2", "configs/opv2v/backalign_m1m2.yaml"),
    ("codefilling_m1m2", "configs/opv2v/codefilling_m1m2.yaml"),
    ("mpda_m1m2", "configs/opv2v/mpda_m1m2.yaml"),
    ("stamp_m1m2", "configs/opv2v/stamp_m1m2.yaml"),
]


def synthetic_batch_for_hypes(hypes: dict, num_agents: int = 2,
                              seed: int = 0, points_per_agent: int = 20000,
                              host_decorate: bool = True):
    """(scenes, batch): a (B=1, L) batch of the hypes' modality layout,
    scene points of the sampler at the config's range for a lidar modality
    and uniform random images, identity rotations and a 400-pixel focal
    length at the config's ``final_dim`` for a camera one; trimmed to the
    agent buckets (2, 3, 5) and, with ``host_decorate``, its pillar
    modalities decorated on the host."""
    from gencomm_tpu_torch.data.bucketing import trim_agent_slots
    from gencomm_tpu_torch.data.decorate import HostDecoration
    from gencomm_tpu_torch.data.synthetic import (
        SyntheticConfig, SyntheticScenes,
    )

    lidar_range = tuple(hypes["preprocess"]["cav_lidar_range"])
    max_cav = hypes["train_params"]["max_cav"]
    scenes = SyntheticScenes(SyntheticConfig(
        lidar_range=lidar_range, max_cav=max_cav, num_agents=num_agents,
        points_per_agent=points_per_agent))
    base = scenes.sample(seed, 1)
    rng = np.random.default_rng(seed)
    margs = hypes["model"]["args"]
    modalities = [k for k in margs
                  if isinstance(margs[k], dict) and "encoder_args" in margs[k]]
    batch = {k: v for k, v in base.items()
             if not (k.endswith("_m1") and k.startswith(
                 ("points", "point_mask", "modality_mask")))}
    for m in modalities:
        mcfg = margs[m]
        batch[f"modality_mask_{m}"] = base["modality_mask_m1"].copy()
        if mcfg.get("sensor_type", "lidar") == "camera":
            dac = mcfg["encoder_args"]["data_aug_conf"]
            h, w = dac["final_dim"]
            ncam = dac.get("Ncams", 4)
            lead = (1, max_cav, ncam)
            batch[f"imgs_{m}"] = rng.uniform(
                0, 1, lead + (h, w, 3)).astype(np.float32)
            eye = np.tile(np.eye(3, dtype=np.float32), lead + (1, 1))
            batch[f"rots_{m}"] = eye
            batch[f"trans_{m}"] = np.zeros(lead + (3,), np.float32)
            intr = np.array([[400.0, 0, w / 2], [0, 400.0, h / 2],
                             [0, 0, 1]], np.float32)
            batch[f"intrins_{m}"] = np.tile(intr, lead + (1, 1))
            batch[f"post_rots_{m}"] = eye.copy()
            batch[f"post_trans_{m}"] = np.zeros(lead + (3,), np.float32)
        else:
            batch[f"points_{m}"] = base["points_m1"].copy()
            batch[f"point_mask_{m}"] = base["point_mask_m1"].copy()
    batch = trim_agent_slots(batch, buckets=(2, 3, 5))
    if host_decorate:
        batch = HostDecoration(hypes)(batch)
    return scenes, batch


def bench_config(name: str, path: str, mode: str, iters: int = 20,
                 quiet: bool = False, half: bool = False, device=None,
                 hypes: dict | None = None) -> dict:
    """One row: the yaml at ``path`` (or ``hypes``) through the pipeline in
    ``mode``, timed looped and streamed."""
    from gencomm_tpu_torch.config.yaml_utils import load_yaml
    from gencomm_tpu_torch.data.postprocessor import generate_anchor_box
    from gencomm_tpu_torch.models import create_model
    from gencomm_tpu_torch.pipeline import InferencePipeline, batch_to_device
    from gencomm_tpu_torch.tools.profiler import latency, param_count
    from gencomm_tpu_torch.weights import random_state_dict

    device = resolve_device(device)
    hypes = hypes if hypes is not None else load_yaml(path)
    if half:
        hypes["model"]["args"]["half"] = True
    if mode in ("late", "no"):
        hypes["model"]["args"]["supervise_single"] = True
    model = create_model(hypes, device=device)
    model.load_state_dict(random_state_dict(model, 0))
    _, host = synthetic_batch_for_hypes(hypes)
    anchors = generate_anchor_box(hypes["postprocess"]["anchor_args"],
                                  hypes["postprocess"].get("order", "hwl"))
    pipe = InferencePipeline(model, anchors, hypes["postprocess"], mode=mode,
                             device=device)
    batch = batch_to_device(host, device)
    seeds = iter(range(10 ** 9))
    looped = latency(lambda: pipe.run(batch, seed=next(seeds)), iters=iters,
                     device=device)
    frames = {k: v[None].expand((iters,) + tuple(v.shape))
              for k, v in batch.items()}
    streamed = latency(lambda: pipe.run_stream(frames, list(range(iters))),
                       iters=1, device=device)
    row = {"config": name, "yaml": path, "mode": mode,
           "dtype": "bf16" if half else "fp32",
           "fps": round(looped["throughput_fps"], 2),
           "ms_per_frame": round(looped["latency_ms"], 3),
           "streamed_ms_per_frame": round(streamed["latency_ms"] / iters, 3),
           "first_s": round(looped["first_s"], 2),
           "params_M": round(param_count(model) / 1e6, 3),
           "device": looped["device"]}
    if not quiet:
        print(json.dumps(row), flush=True)
    return row


def _error_row(name: str, exc: Exception) -> dict:
    row = {"config": name, "error": repr(exc)[:300]}
    print(json.dumps(row), flush=True)
    return row


def added_cost_matrix(iters: int = 20, only=None, half: bool = False,
                      device=None) -> list:
    """Rows of the five methods and the plain base, each method's
    ``added_ms`` and ``added_params_M`` over the base's."""
    rows, base_row = [], None
    for name, path in [HETERO_BASE] + HETERO_METHODS:
        if only and name != HETERO_BASE[0] and name not in only:
            continue
        try:
            row = bench_config(name, path, "intermediate", iters, quiet=True,
                               half=half, device=device)
        except Exception as exc:  # the matrix goes on past a row that fails
            rows.append(_error_row(name, exc))
            continue
        if base_row is None:
            base_row = row
        else:
            row["added_ms"] = round(row["ms_per_frame"]
                                    - base_row["ms_per_frame"], 3)
            row["added_params_M"] = round(row["params_M"]
                                          - base_row["params_M"], 3)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of config names")
    ap.add_argument("--added_cost", action="store_true",
                    help="the five methods' added-cost rows instead of the "
                         "default config list")
    ap.add_argument("--half", action="store_true",
                    help="bf16 activations")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    only = args.only.split(",") if args.only else None
    if args.added_cost:
        return added_cost_matrix(args.iters, only, args.half, args.device)
    rows = []
    for name, path, mode in DEFAULT_CONFIGS:
        if only and name not in only:
            continue
        try:
            rows.append(bench_config(name, path, mode, args.iters,
                                     half=args.half, device=args.device))
        except Exception as exc:  # the matrix goes on past a row that fails
            rows.append(_error_row(name, exc))
    return rows


if __name__ == "__main__":
    main()
