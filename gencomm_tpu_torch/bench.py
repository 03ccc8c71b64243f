"""End-to-end inference benchmark of the port on the flagship GenComm
stage-1 config, on one CUDA device.

    python -m gencomm_tpu_torch.bench [--fp32]

Counterpart of ``bench.py`` (which drives the JAX package): the flagship as
``bench.py:37-85`` builds it -- PointPillars on a 512 x 256 grid, 2 agents
trimmed from 5 slots, the message extractor, 3-step diffusion, Enhancer,
attentive fusion, heads, decode and rotated NMS, batch 1 -- at bf16
(``half=True``) unless ``--fp32``, without the stripe-padded row layout
(the port has none). Random weights from seed 0; fp32 convolutions and
matmuls with TF32 off. One frame is sampled, trimmed and decorated on the
host once; after one warm-up frame, with the inputs on the card:

- ``fps_dispatch_loop``: ``InferencePipeline.run`` per frame, N_FRAMES
  frames (seeds 1..N), host clock around the loop, synchronised at its end;
- ``fps_streamed``: one ``InferencePipeline.run_stream`` over the same
  frames and seeds (CUDA-graph replays), after a first call that captures
  the frame; ``streamed_equals_looped`` says whether its detections equal
  the looped run's bit for bit, and the program exits non-zero, after its
  line, when they do not.

Then, in a profiler session that begins after both timings, the device busy
time and the kernels and copies launched per frame, looped and streamed.
Prints one JSON line with ``bench.py``'s keys and those, and the card's
``nvidia-smi`` name and power limit. Raises without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

from gencomm_tpu_torch import resolve_device
from gencomm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes

PYTORCH_GPU_BASELINE_FPS = 10.0  # bench.py's yardstick
N_FRAMES = 30  # bench.py's n_iters
LIDAR_RANGE = (-102.4, -51.2, -3.0, 102.4, 51.2, 1.0)
VOXEL = (0.4, 0.4, 4.0)
POSTPROCESS = {"gt_range": list(LIDAR_RANGE),
               "target_args": {"score_threshold": 0.2}, "nms_thresh": 0.15,
               "dir_args": {"dir_offset": 0.7853, "num_bins": 2},
               "nms_topk": 512}


def flagship_kwargs(half: bool = True) -> dict:
    """``HeterModel`` arguments of ``bench.py:47-84``'s flagship."""
    return dict(
        modality_args={"m1": {
            "encoder_args": {"voxel_size": list(VOXEL),
                             "lidar_range": list(LIDAR_RANGE),
                             "pillar_vfe": {"use_norm": True,
                                            "num_filters": [64]}},
            "backbone_args": {"layer_nums": [3, 5, 8],
                              "layer_strides": [2, 2, 2],
                              "num_filters": [64, 128, 256],
                              "upsample_strides": [1, 2, 4],
                              "num_upsample_filter": [128, 128, 128]},
            "shrink_header": {"kernal_size": [3], "stride": [2],
                              "padding": [1], "dim": [128],
                              "input_dim": 384},
        }},
        fusion_method="att", lidar_range=LIDAR_RANGE, anchor_number=2,
        use_gencomm=True, use_enhancer=True, half=half)


def scenes_config() -> SyntheticConfig:
    """``bench.py:build_flagship``'s sampler: 2 agents in 5 slots."""
    return SyntheticConfig(lidar_range=LIDAR_RANGE, max_cav=5, num_agents=2,
                           points_per_agent=30000, num_vehicles=12,
                           points_per_vehicle=300)


def build_flagship(half: bool = True, device=None):
    """(scenes, model, cfg) as ``bench.py:build_flagship`` returns them."""
    from gencomm_tpu_torch.models.heter_baseline import HeterModel

    cfg = scenes_config()
    return (SyntheticScenes(cfg),
            HeterModel(**flagship_kwargs(half), device=device), cfg)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def device_profile(run, n_frames: int):
    """(device busy ms, kernels and copies launched) per frame of ``run()``,
    which runs ``n_frames`` frames, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA
              and ev.self_device_time_total > 0]
    return (sum(ev.self_device_time_total for ev in events) / n_frames / 1e3,
            sum(ev.count for ev in events) / n_frames)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fp32", action="store_true",
                    help="the fp32 graph (half=False)")
    args = ap.parse_args(argv)

    import torch
    from gencomm_tpu_torch.data.bucketing import trim_agent_slots
    from gencomm_tpu_torch.pipeline import InferencePipeline, batch_to_device
    from gencomm_tpu_torch.weights import random_state_dict

    dev = resolve_device()
    if dev.type != "cuda":
        raise RuntimeError("the benchmark runs on a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    scenes, model, _ = build_flagship(half=not args.fp32, device=dev)
    model.load_state_dict(random_state_dict(model, seed=0))
    pipe = InferencePipeline(model, scenes.anchors, POSTPROCESS, device=dev)
    host = trim_agent_slots(scenes.sample(seed=0, batch_size=1),
                            buckets=(2, 3, 5))
    batch = batch_to_device(pipe.decorate(host), dev)
    n = N_FRAMES
    seeds = list(range(1, n + 1))

    pipe.run(batch, seed=0)  # warm-up: kernel builds, cuDNN's choices
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    looped = [pipe.run(batch, seed=s) for s in seeds]
    torch.cuda.synchronize()
    fps_loop = n / (time.perf_counter() - t0)

    frames = {k: v.expand((n,) + tuple(v.shape)) for k, v in batch.items()}
    pipe.run_stream(frames, seeds)  # captures the frame
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streamed = pipe.run_stream(frames, seeds)
    torch.cuda.synchronize()
    fps_stream = n / (time.perf_counter() - t0)
    equal = all(torch.equal(s[f], getattr(looped[f], name))
                for name, s in streamed._asdict().items()
                for f in range(n))

    # every timing above is taken before the process's first profiler
    # session, which leaves later launches slower
    prof_frames = 3
    busy, launches = device_profile(
        lambda: [pipe.run(batch, seed=s) for s in seeds[:prof_frames]],
        prof_frames)
    s_busy, s_launches = device_profile(
        lambda: pipe.run_stream(
            {k: v[:prof_frames] for k, v in frames.items()},
            seeds[:prof_frames]), prof_frames)
    fps = max(fps_loop, fps_stream)
    result = {
        "metric": "e2e_inference_fps_gencomm_stage1_opv2v",
        "value": fps, "unit": "frames/sec",
        "vs_baseline": fps / PYTORCH_GPU_BASELINE_FPS,
        "fps_dispatch_loop": fps_loop, "fps_streamed": fps_stream,
        "dtype": "fp32" if args.fp32 else "bf16",
        "device_busy_ms": busy, "launches_per_frame": launches,
        "streamed_device_busy_ms": s_busy,
        "streamed_launches_per_frame": s_launches,
        "streamed_equals_looped": equal,
        "frames": n, "agents": int(batch["agent_mask"].shape[1]),
        "card": card_name(),
    }
    print(json.dumps(result), flush=True)
    if not equal:
        raise SystemExit("streamed detections differ from the looped ones")
    return result


if __name__ == "__main__":
    main()
