#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's eight CUDA kernels from ``gencomm_tpu_torch/csrc`` with
nvcc (sm_90a) into ``build/``, then drives the port's paths through its entry
points (SyntheticScenes, trim_agent_slots, host decoration for lidar,
HeterModel, InferencePipeline.run, train.trainer.make_train_step), fp32
activations with TF32 off, random weights from a seed: the lidar flagship --
GenComm stage 1, PointPillars on a 512 x 256 pillar grid, 2 agents, attentive
fusion, 3-step diffusion, Enhancer, heads, decode and rotated NMS -- and the
camera model of configs/opv2v/gencomm/stage1/m2_att.yaml at full width --
Lift-Splat-Shoot, 4 cameras of 384 x 512 per agent, 48 depth bins, top-8, a
256 x 256 BEV grid, the same neck, diffusion, fusion and heads.

Phases, each of which raises on failure:
  1. the card, its power limit, torch / CUDA versions, fp32 settings;
  2. the kernel build, timed; K1 and K1b once on their general route
     (channel counts the tensor-core route does not take, a ragged map,
     offsets to +-9) and K2b once on its (6 channels) against their plain
     versions;
  3. each kernel (K1 deformable conv, K2 pillar canvas, K3 affine warp) on
     the inputs the main path gives it, held against its plain PyTorch
     version (K2 bit-exact, K1 / K3 within the stated fp32 tolerance) and
     timed beside the plain version, a one-call PyTorch yardstick where one
     exists, and its bound on the card. K1 and K1b are timed warm and with
     the L2 cache evicted before every launch ("cold_ms"), and their rows
     name the route the wrapper took ("path_route"; "route_launches" counts
     the main path's launches by route); K3 and F.grid_sample are timed in
     turns, 200 launches a turn ("turns_ms"). Every kernel and every library
     yardstick also has the profiler's device time per call ("device_ms",
     "library_device_ms"), which leaves out the host work between launches
     that the event time of a short kernel is made of;
  4. the main path: 1 warm-up + 10 timed frames (CUDA events), frames/s,
     detections, finite outputs, and each kernel's launch count in this
     phase (it must be > 0);
  5. the same frame, weights and noise through the port on the CPU (plain
     versions): cls/reg/dir must agree with the card's;
  6. training, the flagship's fp32 train step with the settings of
     configs/opv2v/gencomm/stage1/m1_att.yaml (batch 2 x 2 agents, AdamW,
     multistep LR, point_pillar_gencomm_loss) through
     gencomm_tpu_torch.train.trainer: the backward kernels (K1b deformable
     conv, K2b pillar canvas, K3b affine warp) on the arguments the train
     step gives them, held against their plain versions (K2b bit-exact) and
     timed; 1 warm-up + 10 timed steps (CUDA events) with every kernel's
     launch count (each must be > 0) and the loss terms of every step; 4
     steps on one repeated batch, whose loss must fall; one step on the card
     and on the port's CPU, whose losses must agree and whose gradients
     must differ no more than the CPU's own under a 1e-7 input jitter;
  7. the camera eval path: K4 (top-K depth splat) on the arguments the path
     gives it, held against its plain version (fp32 sum-order tolerance; K4
     itself gives the same bits on every run), once more with bf16 rows, the
     order it summed in held against a stable torch.sort's, and timed, with
     the device time of each of its launches by name (none may be a
     library's kernel); K1 and K3 held and timed again on this path's arguments (maps of
     64 x 64, not 64 x 128); 1 warm-up + 10 timed frames with the launch counts of K1, K3 and
     K4 (each must be > 0), the device profile, and the same frame on the
     CPU;
  8. the camera train step with the optimizer, schedule and
     point_pillar_depth_loss of m2_att.yaml (batch 2 x 2 agents): K1, K3 and
     K4 at the step's shapes, K1b, K3b and K4b (K4's backward) on the step's
     arguments, against their plain versions and timed; 1 warm-up + 10 timed steps with the launch counts of K1, K1b,
     K3, K3b, K4 and K4b (each must be > 0) and finite loss terms,
     depth_loss included; 4 steps on one batch, whose loss must fall; one
     step on the card and on the CPU, held as in phase 6.
Each phase prints its wall time, and each profile the convolution operators
by the shapes of their arguments. The last line is {"ok": true, "device":
{...}}; before it come the card's nvidia-smi line and one JSON line with
every kernel's numbers on the path that ran it first and, under
"other_paths", on the camera paths' arguments where those differ.
Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import json
import math
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
FEATURE_SHAPE = (64, 128, 128)  # the fused map, H x W x C
NMS_TOPK = 512

# the camera model: configs/opv2v/gencomm/stage1/m2_att.yaml:167-270
CAMERA_RANGE = (-51.2, -51.2, -3.0, 51.2, 51.2, 1.0)
CAMERA_DIM, CAMERA_NCAM = (384, 512), 4
CAMERA_GRID = {"xbound": [-51.2, 51.2, 0.4], "ybound": [-51.2, 51.2, 0.4],
               "zbound": [-10, 10, 20.0], "ddiscr": [2, 50, 48], "mode": "LID"}
CAMERA = dict(
    modality_args={"m1": {
        "core_method": "lift_splat_shoot", "sensor_type": "camera",
        "encoder_args": {"grid_conf": CAMERA_GRID,
                         "data_aug_conf": {"final_dim": list(CAMERA_DIM),
                                           "Ncams": CAMERA_NCAM},
                         "img_downsample": 8, "img_features": 128,
                         "trunk_blocks": 2, "depth_topk": 8,
                         "lidar_range": list(CAMERA_RANGE)},
        "backbone_args": FLAGSHIP["modality_args"]["m1"]["backbone_args"],
        "shrink_header": FLAGSHIP["modality_args"]["m1"]["shrink_header"],
    }},
    fusion_method="att", lidar_range=CAMERA_RANGE, anchor_number=2,
    use_gencomm=True, use_enhancer=True, half=False)
CAMERA_FEATURE_SHAPE = (64, 64, 128)
TIMED_FRAMES = 10
# card vs CPU on the whole model, fp32 with TF32 off: sums in other orders
# over ~30 layers, and a bf16 canvas whose rounding can flip by one ulp
# where the two PFN matmuls differ in the last bit
CPU_TOL = 1e-3

# training: configs/opv2v/gencomm/stage1/m1_att.yaml:108-141 (optimizer,
# lr_scheduler, loss), with train_params.batch_size 2 (:7)
TRAIN_HYPES = {
    "optimizer": {"core_method": "Adam", "lr": 0.002,
                  "args": {"eps": 1e-10, "weight_decay": 1e-4}},
    "lr_scheduler": {"core_method": "multistep", "gamma": 0.1,
                     "step_size": [10, 15]},
    "loss": {"core_method": "point_pillar_gencomm_loss", "args": {
        "pos_cls_weight": 2.0,
        "cls": {"type": "SigmoidFocalLoss", "alpha": 0.25, "gamma": 2.0,
                "weight": 2.0},
        "reg": {"type": "WeightedSmoothL1Loss", "sigma": 3.0,
                "codewise": True, "weight": 2.0},
        "dir": {"type": "WeightedSoftmaxClassificationLoss", "weight": 0.2,
                "args": {"dir_offset": 0.7853, "num_bins": 2,
                         "anchor_yaw": [0, 90]}},
        "generate_weight": 1}},
}
# the camera model's: m2_att.yaml:131-166 (generate_weight is read by nothing
# in point_pillar_depth_loss, as in the JAX package)
CAMERA_TRAIN_HYPES = dict(TRAIN_HYPES, loss={
    "core_method": "point_pillar_depth_loss",
    "args": dict(TRAIN_HYPES["loss"]["args"], depth={"weight": 1.0})})
TRAIN_BATCH = 2
TRAIN_SEED = 0  # tools/train.py batches(): sample(seed * 10000 + step, 2)
TIMED_STEPS = 10
# K1b vs its plain version: fp32 sums of up to 32,768 random-sign terms
# (dW over the pixels, dx by atomics in a run-dependent order) taken in
# other orders; each term rounds at ~6e-8 relative, and the cancellation
# between terms is bounded well inside 1e-3 of the output's largest value
K1B_TOL = 1e-3
# card vs CPU gradients. At the random-weight flagship point they move with
# the last bits of the inputs: a 1e-7 relative jitter of the CPU step's
# input points moves them by up to ~4e-2 (L2, the deep backbone levels),
# and two card runs differ by ~1e-4 (atomics). So the card's gradients are
# held to GRAD_FACTOR x the CPU's own jitter sensitivity, measured in the
# same run, per worst parameter (L2 norm of the difference over the norm)
JITTER = 1e-7
GRAD_FACTOR = 3.0
GRAD_FLOOR = 1e-4
LOSS_TOL = 1e-3  # relative, the losses of the same step
# K4 / K4b vs their plain versions: fp32 sums (a cell's rows; 128 products
# and K rows) taken in another order, relative to the output's largest value
SPLAT_TOL = 1e-5
K3_TURN_LAUNCHES = 200
# channel counts and a map that only the general route of K1 / K1b takes
GENERAL_SHAPE = (2, 20, 36, 40, 70)
# agents, rows per agent, channels, cells per agent: K2b's general route
GENERAL_CANVAS = (3, 1000, 6, 200)


def log(*a):
    print(*a, flush=True)


_L2_FLUSH = []  # one buffer larger than the card's 50 MB L2, made at first use


def time_ms(fn, iters=20, warmup=3, cold=False):
    """Mean ms of ``fn`` over ``iters`` launches after ``warmup``. Warm: the
    launches follow each other, so what one left in the L2 cache the next
    finds. ``cold``: a 128 MB buffer is rewritten before every launch, which
    evicts the L2, and each launch is timed on its own."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if not cold:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.zeros(32 << 20, device="cuda"))
    pairs = []
    for _ in range(iters):
        _L2_FLUSH[0].add_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def device_split(fn, n=20):
    """Device ms per call of ``fn`` of every kernel, copy and memset it
    launches, by name, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {ev.key: ev.self_device_time_total / n / 1e3
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0}


def device_ms(fn, n=20):
    """Device ms per call of ``fn``: the time of every kernel, copy and
    memset it launches, whatever the host needs between launches (which
    ``time_ms`` counts where a kernel is shorter than its wrapper's host
    work). None if the profiler saw nothing."""
    total = sum(device_split(fn, n).values())
    return total if total > 0 else None


def warp_tolerance(src):
    """K3 vs its plain version: the plain version's scalar divisions round
    the sampling coordinate (up to max(H, W) pixels) differently in the
    last bit, which moves the bilinear blend by up to one coordinate ulp
    times the largest step between neighbours (<= 2 max|src|)."""
    h, w = src.shape[1], src.shape[2]
    return 4.0 * max(h, w) * 2.0 ** -23 * max(1.0, float(src.abs().max()))


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(flops, moved):
    """(ms, what bounds it): the least time for ``flops`` fp32 operations
    and ``moved`` bytes on the card."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, moved / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def log_rows(rows):
    for row in rows:
        cold = (f" (cold L2 {row['cold_ms']:.4f} ms, route "
                f"{row['path_route']})" if "cold_ms" in row else "")
        log(f"  {row['name']}: kernel {row['ms']:.4f} ms by events, "
            f"{row['device_ms']} ms on the device{cold}, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']} ms "
            f"({row['library_device_ms']} on the device), "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")


def record_calls(targets, run):
    """Calls ``run()`` with each wrapper ``(module, name)`` of ``targets``
    replaced by one that records the arguments of its last call (tensors
    detached and cloned); returns {name: arguments}."""
    import torch

    seen = {}

    def recorder(name, fn):
        def wrapped(*args):
            seen[name] = tuple(a.detach().clone() if torch.is_tensor(a) else a
                               for a in args)
            return fn(*args)
        return wrapped

    saved = [getattr(mod, attr) for mod, attr in targets]
    try:
        for (mod, attr), fn in zip(targets, saved):
            setattr(mod, attr, recorder(attr, fn))
        run()
    finally:
        for (mod, attr), fn in zip(targets, saved):
            setattr(mod, attr, fn)
    return seen


def add_rows(kernel_rows, path, rows):
    """Adds a later path's rows to the kernels JSON line: a kernel that has
    no row yet gets this one; for a kernel that has one (from the path that
    ran it first), the numbers taken on ``path``'s arguments go under
    ``other_paths`` of that row."""
    by_name = {row["name"]: row for row in kernel_rows}
    for row in rows:
        first = by_name.get(row["name"])
        if first is None:
            kernel_rows.append(row)
        else:
            first.setdefault("other_paths", {})[path] = {
                k: row[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "cold_ms", "path_route", "route_launches",
                                    "turns_ms", "device_ms",
                                    "library_device_ms") if k in row}


def route_launches():
    """{kernel name: {route: launches}} of the kernels that have routes."""
    from gencomm_tpu_torch.ops import deform_conv, pillar_canvas

    return {**deform_conv.ROUTE_LAUNCHES,
            "pillar_canvas_bwd": pillar_canvas.ROUTE_LAUNCHES}


def reset_launch_counts():
    """Every wrapper's launch count, and those by route, to 0."""
    from gencomm_tpu_torch.ops import _cuda

    for k in _cuda.LAUNCHES:
        _cuda.LAUNCHES[k] = 0
    for counts in route_launches().values():
        for route in counts:
            counts[route] = 0


def fill_launches(rows, launches, path):
    """The path's launch counts into the kernels' rows; for a kernel with
    routes also the counts by route, which must show the route the check
    timed."""
    by_kernel = route_launches()
    for row in rows:
        row["launches"] = launches[row["name"]]
        by_route = by_kernel.get(row["name"])
        if by_route is not None:
            row["route_launches"] = dict(by_route)
            if by_route[row["path_route"]] != row["launches"]:
                raise AssertionError(
                    f"{row['name']} on the {path} path: route "
                    f"{row['path_route']} expected, launches {by_route}")
    log(f"{path} path, launches by route: "
        f"{ {k: dict(v) for k, v in by_kernel.items()} }")


def postprocess_cfg(gt_range):
    return {"gt_range": list(gt_range),
            "target_args": {"score_threshold": 0.2}, "nms_thresh": 0.15,
            "dir_args": {"dir_offset": 0.7853, "num_bins": 2},
            "nms_topk": NMS_TOPK}


def phase_done(label, t0):
    log(f"phase wall time, {label}: {time.perf_counter() - t0:.1f} s")


def profile_device(run, period_ms, n, unit):
    """Device busy time per ``unit`` and the kernels that take it, from
    torch.profiler over ``n`` calls of ``run(i)``; the idle share is against
    the CUDA-event time ``period_ms`` per unit."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
    # kernel-level events only: the aten ops above them, and annotations
    # such as the optimizer's step range, carry the same device time again
    rows = [(ev.self_device_time_total / n / 1e3, ev.count / n, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
            and not getattr(ev, "is_user_annotation", False)
            and not ev.key.startswith("Optimizer.")]
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    if busy <= 0:
        log("profile: the profiler saw no device time")
        return
    log(f"profile: device busy {busy:.3f} ms/{unit} of {period_ms:.3f} ms "
        f"(idle share {1 - busy / period_ms:.3f}), {launches:.0f} kernels "
        f"and copies per {unit}; top by device time (ms/{unit}, "
        f"calls/{unit}):")
    for dev_ms, calls, key in sorted(rows, reverse=True)[:15]:
        log(f"  {dev_ms:8.4f} {calls:6.0f}  {key[:90]}")
    # which layers the convolution kernels belong to: the operators that
    # launch them, by the shapes of their arguments
    convs = [(ev.self_device_time_total / n / 1e3, ev.count / n, ev.key,
              [s for s in (getattr(ev, "input_shapes", None) or []) if s])
             for ev in prof.key_averages(group_by_input_shape=True)
             if ev.device_type == DeviceType.CPU and "conv" in ev.key
             and ev.self_device_time_total > 0]
    log(f"profile: convolution operators by argument shapes (device "
        f"ms/{unit}, calls/{unit}):")
    for dev_ms, calls, key, shapes in sorted(convs, reverse=True)[:8]:
        log(f"  {dev_ms:8.4f} {calls:6.0f}  {key} {shapes}")


def check_deform(inputs, where):
    """K1 (deformable 3x3 conv) against its plain version on the arguments
    the path ``where`` gives it; returns its row of the kernels JSON line
    (launches filled in later)."""
    import torch
    from gencomm_tpu_torch.ops.deform_conv import (
        deform_conv3x3, deform_conv3x3_plain, kernel_route,
    )

    x, off, wt = inputs["deform_conv3x3"]
    b, h, w, cin = x.shape
    cout = wt.shape[-1]
    got, want = deform_conv3x3(x, off, wt), deform_conv3x3_plain(x, off, wt)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    log(f"K1 deform_conv3x3 ({where}) x{tuple(x.shape)} w{tuple(wt.shape)}: "
        f"max|kernel-plain| {err:.3e} (tol {tol:.3e}: fp32 sums of "
        f"{9 * cin} products in another order)")
    if not err <= tol:
        raise AssertionError(f"K1 disagrees with its plain version: {err}")
    bound_ms, bound_by = bound(2.0 * b * h * w * 9 * cin * cout,
                               nbytes(x, off, wt, got))
    row = dict(
        name="deform_conv3x3", route="cuda",
        source="gencomm_tpu_torch/csrc/deform_conv.cu",
        replaces="gencomm_tpu/ops/deform_pallas.py:34",
        max_abs_err=err,
        ms=time_ms(lambda: deform_conv3x3(x, off, wt)),
        device_ms=device_ms(lambda: deform_conv3x3(x, off, wt)),
        cold_ms=time_ms(lambda: deform_conv3x3(x, off, wt), cold=True),
        path_route=kernel_route(cin, cout),
        plain_ms=time_ms(lambda: deform_conv3x3_plain(x, off, wt), iters=5),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        library_device_ms=None)
    log_rows([row])
    return row


def check_deform_general(dev):
    """K1 and K1b on their general route (channel counts the tensor-core
    route does not take, a ragged map, offsets up to +-9 so that corners lie
    anywhere in the map) against the plain versions; returns the two
    errors for the kernels JSON line."""
    import torch
    from gencomm_tpu_torch.ops.deform_conv import (
        ROUTE_LAUNCHES, deform_conv3x3_bwd, deform_conv3x3_bwd_plain,
        deform_conv3x3_fwd, deform_conv3x3_plain, kernel_route,
    )

    b, h, w, cin, cout = GENERAL_SHAPE
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(b, h, w, cin, generator=gen).to(dev)
    off = (torch.randn(b, h, w, 18, generator=gen) * 3.0).clamp(-9, 9).to(dev)
    wt = (torch.randn(3, 3, cin, cout, generator=gen) * 0.1).to(dev)
    g = torch.randn(b, h, w, cout, generator=gen).to(dev)
    if kernel_route(cin, cout) != "general":
        raise AssertionError(f"{GENERAL_SHAPE} does not take the general route")
    before = {k: v["general"] for k, v in ROUTE_LAUNCHES.items()}
    want = deform_conv3x3_plain(x, off, wt)
    err = float((deform_conv3x3_fwd(x, off, wt) - want).abs().max())
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    if not err <= tol:
        raise AssertionError(f"K1 general route disagrees: {err} > {tol}")
    err_b = 0.0
    for name, gv, wv in zip(("dx", "doffsets", "dweight"),
                            deform_conv3x3_bwd(x, off, wt, g),
                            deform_conv3x3_bwd_plain(x, off, wt, g)):
        e, scale = float((gv - wv).abs().max()), float(wv.abs().max())
        if not e <= K1B_TOL * scale:
            raise AssertionError(f"K1b general route, {name}: {e} vs {scale}")
        err_b = max(err_b, e)
    torch.cuda.synchronize()
    if any(ROUTE_LAUNCHES[k]["general"] != before[k] + 1 for k in before):
        raise AssertionError("the general route was not launched")
    log(f"K1 / K1b general route x{GENERAL_SHAPE[:4]} -> {cout}, offsets to "
        f"+-9: max|kernel-plain| {err:.3e} (tol {tol:.3e}) / {err_b:.3e} "
        f"(tol {K1B_TOL:.0e} x max|plain|)")
    return {"deform_conv3x3": err, "deform_conv3x3_bwd": err_b}


def check_pillar(inputs, where):
    """K2 (pillar segment-max canvas) against its plain version, bit for
    bit, on the arguments the path ``where`` gives it; returns its row."""
    import torch
    from gencomm_tpu_torch.ops.pillar_canvas import (
        pillar_canvas, pillar_canvas_plain,
    )

    r, g, n_agents, ncell = inputs["pillar_canvas"]
    got, want = pillar_canvas(r, g, n_agents, ncell), pillar_canvas_plain(
        r, g, n_agents, ncell)
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int16), want.view(torch.int16))
    err = float((got.float() - want.float()).abs().max())
    log(f"K2 pillar_canvas ({where}) rows{tuple(r.shape)} -> "
        f"{tuple(got.shape)}: "
        f"bit-exact {same}, occupied cells {int((want > 0).any(-1).sum())}")
    if not same:
        raise AssertionError(f"K2 is not bit-exact (max abs diff {err})")
    m, c = r.shape
    idx = (torch.arange(m, device=r.device) // (m // n_agents) * ncell
           + g.long().clamp(0, ncell - 1))[:, None].expand(m, c)
    zeros = torch.zeros(n_agents * ncell, c, dtype=r.dtype, device=r.device)
    k2_bytes = nbytes(r, g, got)

    def library():
        return torch.scatter_reduce(zeros, 0, idx, r, "amax",
                                    include_self=True)

    row = dict(
        name="pillar_canvas", route="cuda",
        source="gencomm_tpu_torch/csrc/pillar_canvas.cu",
        replaces="gencomm_tpu/ops/pillar_pallas.py:58",
        max_abs_err=err,
        ms=time_ms(lambda: pillar_canvas(r, g, n_agents, ncell)),
        device_ms=device_ms(lambda: pillar_canvas(r, g, n_agents, ncell)),
        plain_ms=time_ms(lambda: pillar_canvas_plain(r, g, n_agents, ncell)),
        bound_ms=k2_bytes / PEAK_BYTES * 1e3, bound_by="bytes",
        library_ms=time_ms(library), library_device_ms=device_ms(library))
    log_rows([row])
    return row


def check_warp(inputs, where):
    """K3 (affine bilinear warp) against its plain version on the arguments
    the path ``where`` gives it; returns its row."""
    import torch
    import torch.nn.functional as F
    from gencomm_tpu_torch.ops.warp import warp_affine, warp_affine_plain

    src, theta = inputs["warp_affine"]
    got, want = warp_affine(src, theta), warp_affine_plain(src, theta)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = warp_tolerance(src)
    log(f"K3 warp_affine ({where}) src{tuple(src.shape)}: "
        f"max|kernel-plain| {err:.3e} "
        f"(tol {tol:.3e}: a one-ulp difference of the sampling coordinate "
        f"times the largest neighbour step)")
    if not err <= tol:
        raise AssertionError(f"K3 disagrees with its plain version: {err}")
    src_nchw = src.permute(0, 3, 1, 2).contiguous()
    grid = F.affine_grid(theta, list(src_nchw.shape), align_corners=False)
    k3_bytes = nbytes(src, theta, got)

    def library():
        return F.grid_sample(src_nchw, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=False)

    # K3 and the library call in turns in this one process, K3_TURN_LAUNCHES
    # launches a turn: the spread of the repeats says whether a difference
    # between the two is one
    turns = [(time_ms(lambda: warp_affine(src, theta), iters=K3_TURN_LAUNCHES),
              time_ms(library, iters=K3_TURN_LAUNCHES)) for _ in range(3)]
    k3_ms, lib_ms = ([t[i] for t in turns] for i in (0, 1))
    k3_dev, lib_dev = device_ms(lambda: warp_affine(src, theta)), device_ms(library)
    log(f"  K3 against F.grid_sample in turns, {K3_TURN_LAUNCHES} launches "
        f"each: K3 {', '.join(f'{t:.4f}' for t in k3_ms)} ms; grid_sample "
        f"{', '.join(f'{t:.4f}' for t in lib_ms)} ms; device time alone "
        f"(torch.profiler): K3 {k3_dev} ms, grid_sample {lib_dev} ms")
    row = dict(
        name="warp_affine", route="cuda",
        source="gencomm_tpu_torch/csrc/warp_affine.cu",
        replaces="gencomm_tpu/ops/warp_pallas.py:43",
        max_abs_err=err,
        ms=sum(k3_ms) / len(k3_ms),
        plain_ms=time_ms(lambda: warp_affine_plain(src, theta)),
        bound_ms=k3_bytes / PEAK_BYTES * 1e3, bound_by="bytes",
        library_ms=sum(lib_ms) / len(lib_ms),
        turns_ms={"kernel": k3_ms, "library": lib_ms},
        device_ms=k3_dev, library_device_ms=lib_dev)
    log_rows([row])
    return row


def check_deform_bwd(inputs, where):
    """K1b (deformable conv backward) against its plain version on the
    arguments the train step ``where`` gives it; returns its row of the
    kernels JSON line (launches filled in later)."""
    import torch
    from gencomm_tpu_torch.ops.deform_conv import (
        deform_conv3x3_bwd, deform_conv3x3_bwd_plain, kernel_route,
    )

    x, off, wt, g = inputs["deform_conv3x3_bwd"]
    b, h, w, cin = x.shape
    cout = wt.shape[-1]
    got = deform_conv3x3_bwd(x, off, wt, g)
    again = deform_conv3x3_bwd(x, off, wt, g)
    want = deform_conv3x3_bwd_plain(x, off, wt, g)
    torch.cuda.synchronize()
    # dweight and doffsets are summed in a fixed order; dx by atomics
    if not (torch.equal(got[2], again[2]) and torch.equal(got[1], again[1])):
        raise AssertionError("K1b dweight / doffsets differ between two runs")
    err = 0.0
    for name, gv, wv in zip(("dx", "doffsets", "dweight"), got, want):
        e = float((gv - wv).abs().max())
        scale = float(wv.abs().max())
        log(f"K1b {name}{tuple(gv.shape)} ({where}): max|kernel-plain| "
            f"{e:.3e}, "
            f"max|plain| {scale:.3e} (tol {K1B_TOL:.0e} x max|plain|: fp32 "
            f"sums of up to {b * h * w} terms in other orders)")
        if not e <= K1B_TOL * scale:
            raise AssertionError(f"K1b {name} disagrees with its plain "
                                 f"version: {e} vs scale {scale}")
        err = max(err, e)
    npix = b * h * w
    bound_ms, bound_by = bound(
        4.0 * npix * 9 * cin * cout + 24.0 * npix * 9 * cin,
        nbytes(x, off, wt, g, *got))
    row = dict(
        name="deform_conv3x3_bwd", route="cuda",
        source="gencomm_tpu_torch/csrc/deform_conv_bwd.cu",
        replaces="gencomm_tpu/ops/deform_pallas.py:93",
        max_abs_err=err,
        ms=time_ms(lambda: deform_conv3x3_bwd(x, off, wt, g)),
        device_ms=device_ms(lambda: deform_conv3x3_bwd(x, off, wt, g)),
        cold_ms=time_ms(lambda: deform_conv3x3_bwd(x, off, wt, g), cold=True),
        path_route=kernel_route(cin, cout, backward=True),
        plain_ms=time_ms(lambda: deform_conv3x3_bwd_plain(x, off, wt, g),
                         iters=5),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        library_device_ms=None)
    log_rows([row])
    return row


def check_pillar_bwd(inputs, where):
    """K2b (pillar canvas backward) against its plain version, bit for bit,
    on the arguments the train step ``where`` gives it; returns its row."""
    import torch
    from gencomm_tpu_torch.ops.pillar_canvas import (
        backward_route, pillar_canvas_bwd, pillar_canvas_bwd_plain,
    )

    r, gids, canvas, gout, n_agents, ncell = inputs["pillar_canvas_bwd"]
    got = pillar_canvas_bwd(r, gids, canvas, gout, n_agents, ncell)
    want = pillar_canvas_bwd_plain(r, gids, canvas, gout, n_agents, ncell)
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int16), want.view(torch.int16))
    err = float((got.float() - want.float()).abs().max())
    m, c = r.shape
    cells = (torch.arange(m, device=r.device) // (m // n_agents) * ncell
             + gids.long().clamp(0, ncell - 1))
    n_cells = int(torch.unique(cells).numel())
    log(f"K2b pillar_canvas_bwd ({where}) rows{tuple(r.shape)}: bit-exact "
        f"{same}, "
        f"{n_cells} cells hold rows, {int((got != 0).any(-1).sum())} rows "
        f"get a gradient")
    if not same:
        raise AssertionError(f"K2b is not bit-exact (max abs diff {err})")
    # the library's yardstick: autograd of one scatter_reduce amax
    r_req = r.detach().clone().requires_grad_()
    lib_out = torch.zeros(n_agents * ncell, c, dtype=r.dtype,
                          device=r.device).scatter_reduce(
        0, cells[:, None].expand(m, c), r_req, "amax", include_self=True)
    gflat = gout.reshape(-1, c)
    k2b_bytes = nbytes(r, gids, got) + 2 * n_cells * c * r.element_size()

    def kernel():
        return pillar_canvas_bwd(r, gids, canvas, gout, n_agents, ncell)

    def library():
        return torch.autograd.grad(lib_out, r_req, gflat, retain_graph=True)

    row = dict(
        name="pillar_canvas_bwd", route="cuda",
        source="gencomm_tpu_torch/csrc/pillar_canvas_bwd.cu",
        replaces="gencomm_tpu/models/encoders/point_pillar.py:189",
        max_abs_err=err,
        ms=time_ms(kernel), device_ms=device_ms(kernel),
        path_route=backward_route(c, m, n_agents * ncell),
        plain_ms=time_ms(lambda: pillar_canvas_bwd_plain(
            r, gids, canvas, gout, n_agents, ncell)),
        bound_ms=k2b_bytes / PEAK_BYTES * 1e3, bound_by="bytes",
        library_ms=time_ms(library), library_device_ms=device_ms(library))
    log_rows([row])
    return row


def check_pillar_bwd_general(dev):
    """K2b on its general route (a channel count the 64-channel route does
    not take, an odd number of channel pairs) against the plain version, bit
    for bit: short runs with ties, all-zero rows, an agent boundary inside a
    chunk and a clamped tail longer than 256 rows. Returns the error for the
    kernels JSON line."""
    import torch
    from gencomm_tpu_torch.ops.pillar_canvas import (
        ROUTE_LAUNCHES, backward_route, pillar_canvas_bwd,
        pillar_canvas_bwd_plain, pillar_canvas_plain,
    )

    n_agents, per_agent, c, ncell = GENERAL_CANVAS
    if backward_route(c, n_agents * per_agent, n_agents * ncell) != "general":
        raise AssertionError(f"{GENERAL_CANVAS} does not take the general route")
    gen = torch.Generator().manual_seed(6)
    gids = torch.randint(0, 3 * ncell, (n_agents, per_agent), generator=gen,
                         dtype=torch.int32).sort(dim=1).values.reshape(-1)
    # a few values only, so rows tie at their cell's max; ids >= ncell are
    # the zeroed invalid tail
    rows = torch.randint(0, 4, (n_agents * per_agent, c), generator=gen) * 0.5
    rows[gids >= ncell] = 0.0
    rows, gids = rows.to(dev, torch.bfloat16), gids.to(dev)
    gout = torch.randn(n_agents, ncell, c, generator=gen).to(dev, torch.bfloat16)
    canvas = pillar_canvas_plain(rows, gids, n_agents, ncell)
    before = ROUTE_LAUNCHES["general"]
    got = pillar_canvas_bwd(rows, gids, canvas, gout, n_agents, ncell)
    want = pillar_canvas_bwd_plain(rows, gids, canvas, gout, n_agents, ncell)
    torch.cuda.synchronize()
    if ROUTE_LAUNCHES["general"] != before + 1:
        raise AssertionError("K2b's general route was not launched")
    same = torch.equal(got.view(torch.int16), want.view(torch.int16))
    err = float((got.float() - want.float()).abs().max())
    log(f"K2b general route rows{tuple(rows.shape)}, {n_agents} agents, "
        f"{ncell} cells: bit-exact {same}")
    if not same:
        raise AssertionError(f"K2b general route is not bit-exact ({err})")
    return {"pillar_canvas_bwd": err}


def check_warp_bwd(inputs, where):
    """K3b (affine warp backward) against its plain version on the
    arguments the train step ``where`` gives it; returns its row."""
    import torch
    import torch.nn.functional as F
    from gencomm_tpu_torch.ops.warp import (
        warp_affine_bwd, warp_affine_bwd_plain,
    )

    g3, theta = inputs["warp_affine_bwd"]
    got = warp_affine_bwd(g3, theta)
    want = warp_affine_bwd_plain(g3, theta)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    h3, w3 = g3.shape[1], g3.shape[2]
    tol = 16.0 * max(h3, w3) * 2.0 ** -23 * float(g3.abs().max())
    log(f"K3b warp_affine_bwd ({where}) g{tuple(g3.shape)}: "
        f"max|kernel-plain| "
        f"{err:.3e} (tol {tol:.3e}: a one-ulp difference of the sampling "
        f"coordinate times the cotangent, over up to 16 contributions)")
    if not err <= tol:
        raise AssertionError(f"K3b disagrees with its plain version: {err}")
    src_req = torch.zeros(g3.shape, device=g3.device).permute(
        0, 3, 1, 2).contiguous().requires_grad_()
    grid = F.affine_grid(theta, list(src_req.shape), align_corners=False)
    lib_out = F.grid_sample(src_req, grid, mode="bilinear",
                            padding_mode="zeros", align_corners=False)
    g_nchw = g3.permute(0, 3, 1, 2).contiguous()

    def library():
        return torch.autograd.grad(lib_out, src_req, g_nchw, retain_graph=True)

    row = dict(
        name="warp_affine_bwd", route="cuda",
        source="gencomm_tpu_torch/csrc/warp_affine_bwd.cu",
        replaces="gencomm_tpu/ops/warp_pallas.py:122",
        max_abs_err=err,
        ms=time_ms(lambda: warp_affine_bwd(g3, theta)),
        device_ms=device_ms(lambda: warp_affine_bwd(g3, theta)),
        plain_ms=time_ms(lambda: warp_affine_bwd_plain(g3, theta)),
        bound_ms=nbytes(g3, theta, got) / PEAK_BYTES * 1e3, bound_by="bytes",
        library_ms=time_ms(library), library_device_ms=device_ms(library))
    log_rows([row])
    return row


def log_grad_errors(label, model, ref_model):
    """Per parameter, max|g - g_ref| / max|g_ref| and |g - g_ref| / |g_ref|
    (L2) of the gradients; logs the worst five and returns the worst L2."""
    ref = dict(ref_model.named_parameters())
    errs = []
    for name, p in model.named_parameters():
        want = ref[name].grad.double()
        diff = p.grad.detach().cpu().double() - want
        errs.append((float(diff.norm() / want.norm()),
                     float(diff.abs().max() / want.abs().max()), name))
    errs.sort()
    log(f"{label}, gradients of {len(errs)} parameters, worst five by L2: "
        + ", ".join(f"{n} {l2:.2e} (max {mx:.2e})" for l2, mx, n in errs[-5:]))
    return errs[-1][0]


def check_splat(inputs, where):
    """K4 against its plain version on the arguments ``where`` (the camera
    eval path or train step) gives it; returns its row of the kernels JSON
    line (launches filled in later)."""
    import torch
    from gencomm_tpu_torch.ops.splat import (
        sort_ids, splat_topk_fwd, splat_topk_plain, splat_topk_with_order,
    )

    dvals, feats, ids, num_cells, bf16_rows = inputs["splat_topk"]
    (p, k), c = dvals.shape, feats.shape[-1]
    err = 0.0
    for bf16 in (bf16_rows, True):
        got = splat_topk_fwd(dvals, feats, ids, num_cells, bf16)
        again = splat_topk_fwd(dvals, feats, ids, num_cells, bf16)
        want = splat_topk_plain(dvals, feats, ids, num_cells, bf16)
        torch.cuda.synchronize()
        e, scale = float((got - want).abs().max()), float(want.abs().max())
        tol = SPLAT_TOL * max(1.0, scale)
        log(f"K4 splat_topk ({where}, bf16_rows={bf16}) dvals{(p, k)} "
            f"feats{(p, c)} -> {tuple(got.shape)}: max|kernel-plain| {e:.3e}, "
            f"max|plain| {scale:.3e} (tol {tol:.3e}: fp32 sums of a cell's "
            f"rows in another order; the plain index_add_ uses atomics), "
            f"two launches bit-equal {torch.equal(got, again)}")
        if not e <= tol:
            raise AssertionError(f"K4 disagrees with its plain version: {e}")
        if not torch.equal(got, again):
            raise AssertionError("K4 gave different bits on a second launch")
        if not bool((got[(want == 0).all(-1)] == 0).all()):
            raise AssertionError("K4 left a cell that receives nothing non-zero")
        err = max(err, e)
    valid = (ids >= 0) & (ids < num_cells)
    kept = int(valid.sum())
    cells, counts = torch.unique(ids[valid], return_counts=True)
    log(f"  {kept} of {p * k} rows land in {cells.numel()} of "
        f"{num_cells} cells, the longest run {int(counts.max())} rows; "
        f"{p * k - kept} rows are dropped")
    # the order the kernel summed in is a stable sort's, without its tail of
    # dropped rows
    _, sids, order = splat_topk_with_order(dvals, feats, ids, num_cells,
                                           bf16_rows)
    want_sids, want_order = sort_ids(ids, num_cells)
    stable = (sids.numel() == kept and torch.equal(order, want_order[:kept])
              and torch.equal(sids, want_sids[:kept]))
    log(f"  the kernel's order of the {kept} kept rows equals "
        f"torch.sort(stable=True)'s: {stable}")
    if not stable:
        raise AssertionError("K4's row order is not the stable sort's")
    flat = torch.where(valid, ids, torch.full_like(ids, num_cells)).reshape(-1)
    rows = (dvals[..., None] * feats[:, None, :]).reshape(-1, c)
    zeros = torch.zeros(num_cells + 1, c, device=dvals.device)
    flat_long = flat.long()
    bound_ms, bound_by = bound(2.0 * p * k * c,
                               nbytes(dvals, feats, ids) + num_cells * c * 4)

    def kernel():
        return splat_topk_fwd(dvals, feats, ids, num_cells, bf16_rows)

    def library():
        return torch.index_add(zeros, 0, flat_long, rows)

    split = device_split(kernel)
    row = dict(
        name="splat_topk", route="cuda",
        source="gencomm_tpu_torch/csrc/splat_topk.cu",
        replaces="gencomm_tpu/ops/splat_pallas.py:61",
        max_abs_err=err,
        ms=time_ms(kernel), device_ms=sum(split.values()) or None,
        plain_ms=time_ms(lambda: splat_topk_plain(dvals, feats, ids,
                                                  num_cells, bf16_rows)),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=time_ms(library), library_device_ms=device_ms(library))
    log("  one call's launches, device ms each: " + ", ".join(
        f"{name.replace('void ', '').replace('(anonymous namespace)::', '').split('(')[0].strip()}"
        f" {ms:.4f}" for name, ms in split.items()))
    if any("at::" in name or "cub::" in name for name in split):
        raise AssertionError(f"K4 launched a library kernel: {sorted(split)}")
    log_rows([row])
    return row


def check_splat_bwd(inputs):
    """K4b against its plain version on the camera train step's arguments;
    returns its row."""
    import torch
    from gencomm_tpu_torch.ops.splat import (
        splat_topk_bwd, splat_topk_bwd_plain,
    )

    dvals, feats, ids, gout, num_cells = inputs["splat_topk_bwd"]
    (p, k), c = dvals.shape, feats.shape[-1]
    got = splat_topk_bwd(dvals, feats, ids, gout, num_cells)
    want = splat_topk_bwd_plain(dvals, feats, ids, gout, num_cells)
    torch.cuda.synchronize()
    err = 0.0
    for name, gv, wv in zip(("d_dvals", "d_feats"), got, want):
        e, scale = float((gv - wv).abs().max()), float(wv.abs().max())
        tol = SPLAT_TOL * max(1.0, scale)
        log(f"K4b {name}{tuple(gv.shape)}: max|kernel-plain| {e:.3e}, "
            f"max|plain| {scale:.3e} (tol {tol:.3e}: fp32 sums of {c} "
            f"products / {k} rows in another order)")
        if not e <= tol:
            raise AssertionError(f"K4b {name} disagrees with its plain "
                                 f"version: {e}")
        err = max(err, e)
    valid = (ids >= 0) & (ids < num_cells)
    touched = int(torch.unique(ids[valid]).numel())
    # the library's yardstick: autograd of one index_add on materialised rows
    flat = torch.where(valid, ids, torch.full_like(ids, num_cells)
                       ).reshape(-1).long()
    rows_req = (dvals[..., None] * feats[:, None, :]).reshape(
        -1, c).requires_grad_()
    lib_out = torch.index_add(
        torch.zeros(num_cells + 1, c, device=dvals.device), 0, flat, rows_req)
    g_pad = torch.cat([gout, torch.zeros(1, c, device=gout.device)])
    bound_ms, bound_by = bound(
        4.0 * p * k * c,
        2 * nbytes(dvals, feats) + nbytes(ids) + touched * c * 4)

    def library():
        return torch.autograd.grad(lib_out, rows_req, g_pad, retain_graph=True)

    row = dict(
        name="splat_topk_bwd", route="cuda",
        source="gencomm_tpu_torch/csrc/splat_topk_bwd.cu",
        replaces="gencomm_tpu/ops/splat_pallas.py:188",
        max_abs_err=err,
        ms=time_ms(lambda: splat_topk_bwd(dvals, feats, ids, gout, num_cells)),
        device_ms=device_ms(lambda: splat_topk_bwd(dvals, feats, ids, gout,
                                                   num_cells)),
        plain_ms=time_ms(lambda: splat_topk_bwd_plain(dvals, feats, ids, gout,
                                                      num_cells)),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=time_ms(library), library_device_ms=device_ms(library))
    log(f"  the cotangent rows of {touched} touched cells are read")
    log_rows([row])
    return row


def eval_phase(smi, dev, label, model_kw, feature_shape, scenes, host,
               targets, check, expected):
    """An eval path: the kernels named by ``targets`` on the arguments the
    path gives them (``check``), the path counted and timed, the device
    profile, and the same frame on the CPU. Returns the kernels' rows."""
    import torch
    from gencomm_tpu_torch.models.heter_baseline import HeterModel
    from gencomm_tpu_torch.ops import _cuda
    from gencomm_tpu_torch.pipeline import InferencePipeline, batch_to_device
    from gencomm_tpu_torch.weights import random_state_dict

    t_phase = time.perf_counter()
    model = HeterModel(**model_kw, device=dev)
    state = random_state_dict(model, seed=0)
    model.load_state_dict(state)
    batch = batch_to_device(host, dev)
    pipe = InferencePipeline(model, scenes.anchors,
                             postprocess_cfg(model_kw["lidar_range"]),
                             device=dev)
    gen = torch.Generator().manual_seed(1)
    n = host["agent_mask"].size
    noises = [torch.randn((n,) + feature_shape, generator=gen)
              for _ in range(3)]
    noises_dev = [t.to(dev) for t in noises]

    # the kernels on the path's inputs
    def forward():
        with torch.inference_mode():
            model(batch, noises=noises_dev)

    rows = check(record_calls(targets, forward))

    # the path, counted and timed
    reset_launch_counts()
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
    log(f"{label} eval path: {1 + TIMED_FRAMES} frames, {ms:.3f} ms/frame, "
        f"{1000.0 / ms:.2f} frames/s (fp32, batch 1, {n} agents) on {smi}; "
        f"{n_det} detections kept in the last frame; launches {launches}")
    if dets.corners3d.shape != (1, NMS_TOPK, 8, 3):
        raise AssertionError(f"detections shape {tuple(dets.corners3d.shape)}")
    if not (torch.isfinite(dets.corners3d[dets.valid]).all()
            and torch.isfinite(dets.scores).all()):
        raise AssertionError("non-finite detections")
    for name in expected:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{label} eval path")
    fill_launches(rows, launches, f"{label} eval")

    profile_device(lambda i: pipe.run(batch, seed=100 + i), ms, 3, "frame")

    # the same frame, weights and noise on the CPU
    with torch.inference_mode():
        out_dev = model(batch, noises=noises_dev)
        cpu_model = HeterModel(**model_kw, device="cpu")
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
    phase_done(f"{label} eval", t_phase)
    return rows


def train_phase(smi, dev, label, model_kw, hypes, feature_shape, hosts,
                targets, check, expected, jitter_key):
    """A training path: the kernels named by ``targets`` on the arguments
    the train step gives them (``check``), the steps counted and timed, the
    loss falling on one batch, and one step on the card against the CPU.
    Returns the kernels' rows."""
    import torch
    from gencomm_tpu_torch.loss import build_loss
    from gencomm_tpu_torch.models.heter_baseline import HeterModel
    from gencomm_tpu_torch.ops import _cuda
    from gencomm_tpu_torch.pipeline import batch_to_device
    from gencomm_tpu_torch.train.trainer import make_optimizer, make_train_step
    from gencomm_tpu_torch.weights import random_state_dict

    t_phase = time.perf_counter()
    batches = [batch_to_device(h, dev) for h in hosts]

    def fresh(device):
        model = HeterModel(**model_kw, device=device)
        model.load_state_dict(state)
        model.train()
        opt, sched = make_optimizer(hypes, model.parameters())
        return model, make_train_step(model, criterion, opt, sched)

    criterion = build_loss(hypes["loss"])
    state = random_state_dict(HeterModel(**model_kw, device=dev), seed=0)
    n_slots = hosts[0]["agent_mask"].size
    gen = torch.Generator().manual_seed(2)
    noises = [torch.randn((n_slots,) + feature_shape, generator=gen)
              for _ in range(3)]
    noises_dev = [t.to(dev) for t in noises]

    # the kernels on the train step's arguments: one forward and backward,
    # no update
    model, step = fresh(dev)

    def forward_backward():
        criterion(model(batches[0], noises=noises_dev),
                  batches[0])["total_loss"].backward()

    inputs = record_calls(targets, forward_backward)
    model.zero_grad(set_to_none=True)
    rows = check(inputs)

    # the training path, counted and timed
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    dgen = torch.Generator(device=dev).manual_seed(3)
    step_losses = [step(batches[0], generator=dgen)]  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(1, 1 + TIMED_STEPS):
        step_losses.append(step(batches[i], generator=dgen))
    end.record()
    end.synchronize()
    launches = dict(_cuda.LAUNCHES)
    ms = start.elapsed_time(end) / TIMED_STEPS
    for i, losses in enumerate(step_losses):
        vals = {k: float(v) for k, v in losses.items()}
        log(f"  step {i}{' (warm-up)' if i == 0 else ''}: "
            + ", ".join(f"{k} {v:.6f}" for k, v in sorted(vals.items())))
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"step {i}: non-finite loss {vals}")
        if set(vals) != set(step_losses[0]):
            raise AssertionError(f"step {i}: loss terms {sorted(vals)}")
    log(f"{label} train path: {1 + TIMED_STEPS} steps, {ms:.3f} ms/step, "
        f"{1000.0 / ms:.3f} steps/s, {TRAIN_BATCH * 1000.0 / ms:.2f} training "
        f"frames/s (fp32, TF32 off, batch {TRAIN_BATCH} x {n_slots // TRAIN_BATCH}"
        f" agents) on {smi}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
        f"launches {launches}")
    for name in expected:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{label} training path")
    fill_launches(rows, launches, f"{label} training")
    profile_device(lambda i: step(batches[i], generator=dgen), ms, 2, "step")

    # the loss falls over 4 steps on one repeated batch
    model, step = fresh(dev)
    totals = [float(step(batches[0], noises=noises_dev)["total_loss"])
              for _ in range(4)]
    log(f"4 steps on one batch: total_loss {totals}")
    if not totals[-1] < totals[0]:
        raise AssertionError(f"the loss did not fall: {totals}")

    # one step on the card and on the port's CPU; the CPU step once more
    # with its input (``jitter_key``) jittered by JITTER (relative), which
    # measures how far the gradients move with the last bits of the inputs
    model, step = fresh(dev)
    card = step(batches[0], noises=noises_dev)
    cpu_batch = batch_to_device(hosts[0], "cpu")
    cpu_model, cpu_step = fresh("cpu")
    t0 = time.perf_counter()
    cpu = cpu_step(cpu_batch, noises=noises)
    cpu_s = time.perf_counter() - t0
    for k, v in cpu.items():
        a, b = float(card[k]), float(v)
        log(f"card vs CPU {k}: {a:.7f} vs {b:.7f}")
        if not abs(a - b) <= LOSS_TOL * max(abs(b), 1e-6):
            raise AssertionError(f"{k}: card and CPU disagree ({a} vs {b})")
    jit_model, jit_step = fresh("cpu")
    jgen = torch.Generator().manual_seed(4)
    pts = cpu_batch[jitter_key]
    jit_step({**cpu_batch, jitter_key: pts * (
        1.0 + JITTER * torch.randn(pts.shape, generator=jgen))}, noises=noises)
    log(f"CPU step took {cpu_s:.1f} s")
    sensitivity = log_grad_errors(f"CPU vs CPU with a {JITTER:.0e} input jitter",
                                  jit_model, cpu_model)
    worst = log_grad_errors("card vs CPU", model, cpu_model)
    tol = GRAD_FACTOR * sensitivity + GRAD_FLOOR
    log(f"card vs CPU gradients: worst |card-cpu|/|cpu| (L2) {worst:.3e}, "
        f"tol {GRAD_FACTOR} x {sensitivity:.3e} + {GRAD_FLOOR:.0e}")
    if not worst <= tol:
        raise AssertionError(f"gradients disagree: {worst} > {tol}")
    phase_done(f"{label} training", t_phase)
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from gencomm_tpu_torch.data.bucketing import trim_agent_slots
    from gencomm_tpu_torch.data.decorate import decorate_modality
    from gencomm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
    from gencomm_tpu_torch.models.encoders import lss, point_pillar
    from gencomm_tpu_torch.models.fuse import fusion
    from gencomm_tpu_torch.native import PillarVoxelizer
    from gencomm_tpu_torch.ops import _cuda, deform_conv, pillar_canvas, splat, warp

    # phase 1: the card
    t_all = time.perf_counter()
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

    general_errs = {**check_deform_general(dev),
                    **check_pillar_bwd_general(dev)}

    # phases 3-5: the lidar flagship's eval path
    cfg = SyntheticConfig(lidar_range=LIDAR_RANGE, max_cav=5, num_agents=2,
                          points_per_agent=30000, num_vehicles=12,
                          points_per_vehicle=300)
    scenes = SyntheticScenes(cfg)
    voxelizer = PillarVoxelizer(LIDAR_RANGE, VOXEL)
    t0 = time.perf_counter()
    host = decorate_modality(trim_agent_slots(
        scenes.sample(seed=0, batch_size=1), buckets=(2, 3, 5)), voxelizer)
    log(f"lidar frame: sampled, trimmed to {host['agent_mask'].shape[1]} "
        f"agents and decorated on the host in {time.perf_counter() - t0:.3f} s")
    kernel_rows = eval_phase(
        smi, dev, "lidar", FLAGSHIP, FEATURE_SHAPE, scenes, host,
        [(point_pillar, "pillar_canvas"), (deform_conv, "deform_conv3x3"),
         (fusion, "warp_affine")],
        lambda inputs: [check_deform(inputs, "lidar eval"),
                        check_pillar(inputs, "lidar eval"),
                        check_warp(inputs, "lidar eval")],
        ("deform_conv3x3", "pillar_canvas", "warp_affine"))

    # phase 6: the lidar flagship's training path
    t0 = time.perf_counter()
    hosts = [decorate_modality(trim_agent_slots(
        scenes.sample(TRAIN_SEED * 10000 + i, TRAIN_BATCH), buckets=(2, 3, 5)),
        voxelizer) for i in range(1 + TIMED_STEPS)]
    log(f"lidar train batches: {len(hosts)} x {TRAIN_BATCH} samples, "
        f"{hosts[0]['agent_mask'].shape[1]} agent slots each, sampled, "
        f"labelled and decorated on the host in "
        f"{time.perf_counter() - t0:.3f} s; "
        f"{int(hosts[0]['pos_equal_one'].sum())} positive anchors in the first")
    kernel_rows += train_phase(
        smi, dev, "lidar", FLAGSHIP, TRAIN_HYPES, FEATURE_SHAPE, hosts,
        [(deform_conv, "deform_conv3x3_bwd"),
         (pillar_canvas, "pillar_canvas_bwd"), (warp, "warp_affine_bwd")],
        lambda inputs: [check_deform_bwd(inputs, "lidar train step"),
                        check_pillar_bwd(inputs, "lidar train step"),
                        check_warp_bwd(inputs, "lidar train step")],
        ("deform_conv3x3", "pillar_canvas", "warp_affine",
         "deform_conv3x3_bwd", "pillar_canvas_bwd", "warp_affine_bwd"),
        "decorated_m1")
    del hosts

    # phase 7: the camera eval path. The sampler is configured as
    # tools/train.py configures it for a camera-labelled model: the
    # vehicles spawn within d_max - 2 of the ego
    cam_cfg = SyntheticConfig(
        lidar_range=CAMERA_RANGE, max_cav=5, num_agents=2, num_vehicles=12,
        points_per_vehicle=300,
        modalities={"m1": {"sensor": "camera", "final_dim": CAMERA_DIM,
                           "ncam": CAMERA_NCAM}},
        max_spawn_radius=CAMERA_GRID["ddiscr"][1] - 2.0)
    cam_scenes = SyntheticScenes(cam_cfg)
    t0 = time.perf_counter()
    cam_host = trim_agent_slots(cam_scenes.sample(seed=0, batch_size=1),
                                buckets=(2, 3, 5))
    log(f"camera frame: sampled (images {cam_host['imgs_m1'].shape}) and "
        f"trimmed to {cam_host['agent_mask'].shape[1]} agents on the host in "
        f"{time.perf_counter() - t0:.3f} s")
    # K1 and K3 get (A, 64, 64, 128) maps here, not the lidar path's
    # (A, 64, 128, 128): they are held against their plain versions again
    add_rows(kernel_rows, "camera eval", eval_phase(
        smi, dev, "camera", CAMERA, CAMERA_FEATURE_SHAPE, cam_scenes, cam_host,
        [(deform_conv, "deform_conv3x3"), (fusion, "warp_affine"),
         (lss, "splat_topk")],
        lambda inputs: [check_deform(inputs, "camera eval"),
                        check_warp(inputs, "camera eval"),
                        check_splat(inputs, "camera eval")],
        ("deform_conv3x3", "warp_affine", "splat_topk")))

    # phase 8: the camera training path
    t0 = time.perf_counter()
    cam_hosts = [trim_agent_slots(
        cam_scenes.sample(TRAIN_SEED * 10000 + i, TRAIN_BATCH),
        buckets=(2, 3, 5)) for i in range(1 + TIMED_STEPS)]
    log(f"camera train batches: {len(cam_hosts)} x {TRAIN_BATCH} samples, "
        f"{cam_hosts[0]['agent_mask'].shape[1]} agent slots each, sampled and "
        f"labelled on the host in {time.perf_counter() - t0:.3f} s; "
        f"{int(cam_hosts[0]['pos_equal_one'].sum())} positive anchors in the "
        f"first")

    def check_camera_train(inputs):
        # the forward kernels once more at the train step's shapes (4 agent
        # slots; logged, no rows of their own), then the backward kernels
        where = "camera train step"
        check_deform(inputs, where)
        check_warp(inputs, where)
        check_splat(inputs, where)
        return [check_deform_bwd(inputs, where), check_warp_bwd(inputs, where),
                check_splat_bwd(inputs)]

    add_rows(kernel_rows, "camera train step", train_phase(
        smi, dev, "camera", CAMERA, CAMERA_TRAIN_HYPES, CAMERA_FEATURE_SHAPE,
        cam_hosts,
        [(deform_conv, "deform_conv3x3"), (fusion, "warp_affine"),
         (lss, "splat_topk"), (deform_conv, "deform_conv3x3_bwd"),
         (warp, "warp_affine_bwd"), (splat, "splat_topk_bwd")],
        check_camera_train,
        ("deform_conv3x3", "warp_affine", "splat_topk", "deform_conv3x3_bwd",
         "warp_affine_bwd", "splat_topk_bwd"), "imgs_m1"))

    for row in kernel_rows:
        if row["name"] in general_errs:
            shape = (GENERAL_CANVAS if row["name"] == "pillar_canvas_bwd"
                     else GENERAL_SHAPE)
            row["general_route"] = {"shape": list(shape),
                                    "max_abs_err": general_errs[row["name"]]}
    phase_done("all phases", t_all)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
