#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``gencomm_tpu_torch/csrc`` with nvcc
(sm_90a) into ``build/``, then drives the flagship eval path of the port --
GenComm stage 1, PointPillars on a 512 x 256 pillar grid, 2 agents, attentive
fusion, 3-step diffusion, Enhancer, heads, decode and rotated NMS, fp32
activations, random weights from a seed -- through its entry points
(SyntheticScenes, host decoration, HeterModel, InferencePipeline.run).

Phases, each of which raises on failure:
  1. the card, its power limit, torch / CUDA versions, fp32 settings;
  2. the kernel build, timed;
  3. each kernel (K1 deformable conv, K2 pillar canvas, K3 affine warp) on
     the inputs the main path gives it, held against its plain PyTorch
     version (K2 bit-exact, K1 / K3 within the stated fp32 tolerance) and
     timed beside the plain version, a one-call PyTorch yardstick where one
     exists, and its bound on the card;
  4. the main path: 1 warm-up + 10 timed frames (CUDA events), frames/s,
     detections, finite outputs, and each kernel's launch count in this
     phase (it must be > 0);
  5. the same frame, weights and noise through the port on the CPU (plain
     versions): cls/reg/dir must agree with the card's.
The last line is {"ok": true, "device": {...}}; before it come the
card's nvidia-smi line and one JSON line with every kernel's numbers.
Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# fp32 peak outside the tensor cores and memory rate of one H100 SXM
# (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

LIDAR_RANGE = (-102.4, -51.2, -3.0, 102.4, 51.2, 1.0)
VOXEL = (0.4, 0.4, 4.0)
FLAGSHIP = dict(
    modality_args={"m1": {
        "encoder_args": {"voxel_size": list(VOXEL),
                         "lidar_range": list(LIDAR_RANGE),
                         "pillar_vfe": {"use_norm": True, "num_filters": [64]},
                         "striped_scatter": True},
        "backbone_args": {"layer_nums": [3, 5, 8], "layer_strides": [2, 2, 2],
                          "num_filters": [64, 128, 256],
                          "upsample_strides": [1, 2, 4],
                          "num_upsample_filter": [128, 128, 128]},
        "shrink_header": {"kernal_size": [3], "stride": [2], "padding": [1],
                          "dim": [128], "input_dim": 384},
    }},
    fusion_method="att", lidar_range=LIDAR_RANGE, anchor_number=2,
    use_gencomm=True, use_enhancer=True, half=False)
POSTPROCESS = {"gt_range": list(LIDAR_RANGE),
               "target_args": {"score_threshold": 0.2}, "nms_thresh": 0.15,
               "dir_args": {"dir_offset": 0.7853, "num_bins": 2},
               "nms_topk": 512}
TIMED_FRAMES = 10
# card vs CPU on the whole model, fp32 with TF32 off: sums in other orders
# over ~30 layers, and a bf16 canvas whose rounding can flip by one ulp
# where the two PFN matmuls differ in the last bit
CPU_TOL = 1e-3


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def warp_tolerance(src):
    """K3 vs its plain version: the plain version's scalar divisions round
    the sampling coordinate (up to max(H, W) pixels) differently in the
    last bit, which moves the bilinear blend by up to one coordinate ulp
    times the largest step between neighbours (<= 2 max|src|)."""
    h, w = src.shape[1], src.shape[2]
    return 4.0 * max(h, w) * 2.0 ** -23 * max(1.0, float(src.abs().max()))


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def capture_kernel_inputs(model, batch, noises):
    """One forward pass that records the arguments the main path gives
    each kernel wrapper."""
    import torch
    from gencomm_tpu_torch.models.encoders import point_pillar
    from gencomm_tpu_torch.models.fuse import fusion
    from gencomm_tpu_torch.ops import deform_conv

    seen = {}
    originals = [(point_pillar, "pillar_canvas"), (deform_conv, "deform_conv3x3"),
                 (fusion, "warp_affine")]

    def recorder(name, fn):
        def wrapped(*args):
            seen[name] = tuple(a.clone() if torch.is_tensor(a) else a
                               for a in args)
            return fn(*args)
        return wrapped

    saved = [getattr(mod, attr) for mod, attr in originals]
    try:
        for (mod, attr), fn in zip(originals, saved):
            setattr(mod, attr, recorder(attr, fn))
        with torch.inference_mode():
            model(batch, noises=noises)
    finally:
        for (mod, attr), fn in zip(originals, saved):
            setattr(mod, attr, fn)
    return seen


def profile_frames(pipe, batch, frame_ms, n=3):
    """Device busy time per frame and the kernels that take it, from
    torch.profiler over ``n`` frames; the idle share is against the
    CUDA-event frame time of phase 4."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            pipe.run(batch, seed=100 + i)
        torch.cuda.synchronize()
    # kernel-level events only: the aten ops above them carry the same
    # device time again
    rows = [(ev.self_device_time_total / n / 1e3, ev.count / n, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    if busy <= 0:
        log("profile: the profiler saw no device time")
        return
    log(f"profile: device busy {busy:.3f} ms/frame of {frame_ms:.3f} ms "
        f"(idle share {1 - busy / frame_ms:.3f}), {launches:.0f} kernels "
        f"and copies per frame; top by device time (ms/frame, calls/frame):")
    for dev_ms, calls, key in sorted(rows, reverse=True)[:15]:
        log(f"  {dev_ms:8.4f} {calls:6.0f}  {key[:90]}")


def check_kernels(inputs):
    """Phase 3: each kernel against its plain version on the main path's
    inputs; returns the rows of the kernels JSON line (launches filled in
    later)."""
    import torch
    import torch.nn.functional as F
    from gencomm_tpu_torch.ops.deform_conv import (
        deform_conv3x3, deform_conv3x3_plain,
    )
    from gencomm_tpu_torch.ops.pillar_canvas import (
        pillar_canvas, pillar_canvas_plain,
    )
    from gencomm_tpu_torch.ops.warp import warp_affine, warp_affine_plain

    rows = []

    # K1: deformable 3x3 conv
    x, off, wt = inputs["deform_conv3x3"]
    b, h, w, cin = x.shape
    cout = wt.shape[-1]
    got, want = deform_conv3x3(x, off, wt), deform_conv3x3_plain(x, off, wt)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    log(f"K1 deform_conv3x3 x{tuple(x.shape)} w{tuple(wt.shape)}: "
        f"max|kernel-plain| {err:.3e} (tol {tol:.3e}: fp32 sums of "
        f"{9 * cin} products in another order)")
    if not err <= tol:
        raise AssertionError(f"K1 disagrees with its plain version: {err}")
    flops = 2.0 * b * h * w * 9 * cin * cout
    k1_bytes = nbytes(x, off, wt, got)
    bound = max(flops / PEAK_FP32_FLOPS, k1_bytes / PEAK_BYTES) * 1e3
    rows.append(dict(
        name="deform_conv3x3", route="cuda",
        source="gencomm_tpu_torch/csrc/deform_conv.cu",
        replaces="gencomm_tpu/ops/deform_pallas.py:34",
        max_abs_err=err,
        ms=time_ms(lambda: deform_conv3x3(x, off, wt)),
        plain_ms=time_ms(lambda: deform_conv3x3_plain(x, off, wt), iters=5),
        bound_ms=bound,
        bound_by="operations" if flops / PEAK_FP32_FLOPS > k1_bytes / PEAK_BYTES
        else "bytes",
        library_ms=None))

    # K2: pillar segment-max canvas
    r, g, n_agents, ncell = inputs["pillar_canvas"]
    got, want = pillar_canvas(r, g, n_agents, ncell), pillar_canvas_plain(
        r, g, n_agents, ncell)
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int16), want.view(torch.int16))
    err = float((got.float() - want.float()).abs().max())
    log(f"K2 pillar_canvas rows{tuple(r.shape)} -> {tuple(got.shape)}: "
        f"bit-exact {same}, occupied cells {int((want > 0).any(-1).sum())}")
    if not same:
        raise AssertionError(f"K2 is not bit-exact (max abs diff {err})")
    m, c = r.shape
    idx = (torch.arange(m, device=r.device) // (m // n_agents) * ncell
           + g.long().clamp(0, ncell - 1))[:, None].expand(m, c)
    zeros = torch.zeros(n_agents * ncell, c, dtype=r.dtype, device=r.device)
    k2_bytes = nbytes(r, g, got)
    rows.append(dict(
        name="pillar_canvas", route="cuda",
        source="gencomm_tpu_torch/csrc/pillar_canvas.cu",
        replaces="gencomm_tpu/ops/pillar_pallas.py:58",
        max_abs_err=err,
        ms=time_ms(lambda: pillar_canvas(r, g, n_agents, ncell)),
        plain_ms=time_ms(lambda: pillar_canvas_plain(r, g, n_agents, ncell)),
        bound_ms=k2_bytes / PEAK_BYTES * 1e3, bound_by="bytes",
        library_ms=time_ms(lambda: torch.scatter_reduce(
            zeros, 0, idx, r, "amax", include_self=True))))

    # K3: affine warp
    src, theta = inputs["warp_affine"]
    got, want = warp_affine(src, theta), warp_affine_plain(src, theta)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = warp_tolerance(src)
    log(f"K3 warp_affine src{tuple(src.shape)}: max|kernel-plain| {err:.3e} "
        f"(tol {tol:.3e}: a one-ulp difference of the sampling coordinate "
        f"times the largest neighbour step)")
    if not err <= tol:
        raise AssertionError(f"K3 disagrees with its plain version: {err}")
    src_nchw = src.permute(0, 3, 1, 2).contiguous()
    grid = F.affine_grid(theta, list(src_nchw.shape), align_corners=False)
    k3_bytes = nbytes(src, theta, got)
    rows.append(dict(
        name="warp_affine", route="cuda",
        source="gencomm_tpu_torch/csrc/warp_affine.cu",
        replaces="gencomm_tpu/ops/warp_pallas.py:43",
        max_abs_err=err,
        ms=time_ms(lambda: warp_affine(src, theta)),
        plain_ms=time_ms(lambda: warp_affine_plain(src, theta)),
        bound_ms=k3_bytes / PEAK_BYTES * 1e3, bound_by="bytes",
        library_ms=time_ms(lambda: F.grid_sample(
            src_nchw, grid, mode="bilinear", padding_mode="zeros",
            align_corners=False))))
    for row in rows:
        log(f"  {row['name']}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from gencomm_tpu_torch.data.bucketing import trim_agent_slots
    from gencomm_tpu_torch.data.decorate import decorate_modality
    from gencomm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
    from gencomm_tpu_torch.models.heter_baseline import HeterModel
    from gencomm_tpu_torch.native import PillarVoxelizer
    from gencomm_tpu_torch.ops import _cuda
    from gencomm_tpu_torch.pipeline import InferencePipeline, batch_to_device
    from gencomm_tpu_torch.weights import random_state_dict

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(f"fp32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"matmul precision={torch.get_float32_matmul_precision()}")
    dev = torch.device("cuda")

    # phase 2: build
    build_s = _cuda.build_all()
    log(f"built {sorted(_cuda.SIGNATURES)} with nvcc in {build_s:.1f} s "
        f"into {_cuda.BUILD_DIR}")
    for name, text in sorted(_cuda.build_log.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # the flagship, a frame, random weights from a seed
    cfg = SyntheticConfig(lidar_range=LIDAR_RANGE, max_cav=5, num_agents=2,
                          points_per_agent=30000, num_vehicles=12,
                          points_per_vehicle=300)
    scenes = SyntheticScenes(cfg)
    t0 = time.perf_counter()
    host = trim_agent_slots(scenes.sample(seed=0, batch_size=1),
                            buckets=(2, 3, 5))
    host = decorate_modality(host, PillarVoxelizer(LIDAR_RANGE, VOXEL))
    log(f"frame: sampled, trimmed to {host['agent_mask'].shape[1]} agents and "
        f"decorated on the host in {time.perf_counter() - t0:.3f} s")
    model = HeterModel(**FLAGSHIP, device=dev)
    state = random_state_dict(model, seed=0)
    model.load_state_dict(state)
    batch = batch_to_device(host, dev)
    pipe = InferencePipeline(model, scenes.anchors, POSTPROCESS, device=dev)
    gen = torch.Generator().manual_seed(1)
    n = host["agent_mask"].size
    noises = [torch.randn(n, 64, 128, 128, generator=gen) for _ in range(3)]
    noises_dev = [t.to(dev) for t in noises]

    # phase 3: kernels on the main path's inputs
    inputs = capture_kernel_inputs(model, batch, noises_dev)
    kernel_rows = check_kernels(inputs)

    # phase 4: the main path, counted and timed
    for k in _cuda.LAUNCHES:
        _cuda.LAUNCHES[k] = 0
    dets = pipe.run(batch, seed=0)  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(TIMED_FRAMES):
        dets = pipe.run(batch, seed=i + 1)
    end.record()
    end.synchronize()
    launches = dict(_cuda.LAUNCHES)
    ms = start.elapsed_time(end) / TIMED_FRAMES
    n_det = int(dets.valid.sum())
    log(f"main path: {1 + TIMED_FRAMES} frames, {ms:.3f} ms/frame, "
        f"{1000.0 / ms:.2f} frames/s (fp32, batch 1, 2 agents) on {smi}; "
        f"{n_det} detections kept in the last frame; launches {launches}")
    if dets.corners3d.shape != (1, POSTPROCESS["nms_topk"], 8, 3):
        raise AssertionError(f"detections shape {tuple(dets.corners3d.shape)}")
    if not (torch.isfinite(dets.corners3d[dets.valid]).all()
            and torch.isfinite(dets.scores).all()):
        raise AssertionError("non-finite detections")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    for row in kernel_rows:
        row["launches"] = launches[row["name"]]

    profile_frames(pipe, batch, ms)

    # phase 5: the same frame, weights and noise on the CPU
    with torch.inference_mode():
        out_dev = model(batch, noises=noises_dev)
        cpu_model = HeterModel(**FLAGSHIP, device="cpu")
        cpu_model.load_state_dict(state)
        t0 = time.perf_counter()
        out_cpu = cpu_model(batch_to_device(host, "cpu"), noises=noises)
        cpu_s = time.perf_counter() - t0
    for key in ("cls_preds", "reg_preds", "dir_preds"):
        a, b = out_dev[key].float().cpu(), out_cpu[key]
        if not torch.isfinite(a).all():
            raise AssertionError(f"{key} on the card is not finite")
        err = float((a - b).abs().max())
        scale = max(1.0, float(b.abs().max()))
        log(f"card vs CPU {key} {tuple(a.shape)}: max abs diff {err:.3e}, "
            f"max |cpu| {scale:.3e}, tol {CPU_TOL:.0e} x max(1, max|cpu|)")
        if not err <= CPU_TOL * scale:
            raise AssertionError(f"{key}: card and CPU disagree ({err})")
    log(f"CPU forward took {cpu_s:.1f} s")

    print(smi, flush=True)
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
