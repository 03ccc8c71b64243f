#!/usr/bin/env python3
"""Times the port's top-K depth splat K4, pillar canvas K2, pillar-canvas
backward K2b, BEV warp K3, warp backward K3b and the rotated NMS's greedy
keep-set N1 on one NVIDIA GPU, on the arguments the port's own paths give
them.

    python3 scripts/bench_splat_canvas_torch.py [--old-csrc DIR]
        [--variant NAME=DIR ...]
        [--cases K4,K2,K2b,K3b,K3bn,K3,K3p,K3v,K3n,N1] [--out FILE]

The arguments are recorded from the port's models at random weights (seed 0)
on the synthetic sampler's scenes (seed 0), as ``chip_smoke.py`` records
them, so run lengths, the dropped rows and the invalid-row tail are the
paths' own: K4 on the camera eval frame (24,576 pixels x top-8, 131,072
cells) and the camera train step (49,152 pixels, 262,144 cells); K2 on the
lidar eval frame (2 x 30,000 rows of 64 bf16 channels, 2 x 131,072 cells)
and the lidar train step (4 agents); K2b on the lidar train step; K3b on
the lidar train step (g (4, 64, 128, 128) fp32) and the camera train step
(g (4, 64, 64, 128)); K3 on the four eval frames (lidar and camera, fp32
and bf16: src (2, 64, 128, 128) and (2, 64, 64, 128), the bf16 maps from
the ``half=True`` models), where the bf16 instantiation must also give the
fp32 kernel's bits on the widened map, rounded once. ``K3p`` is K3 on the
HEAL pyramid's eval forward (``heal/stage1/m1_pyramid.yaml`` at full width,
seed 0): each level's feature (2, 128, 256, 64) / (2, 64, 128, 128) /
(2, 32, 64, 256) and its one-channel occupancy score alone, and the two in
one ``warp_affine_pair`` launch, timed against their two launches and the
JAX package's form (the two concatenated, one launch), all with the bits
of the two launches. ``K3v`` is K3 on V2VNet's eval forward
(``point_pillar_v2vnet.yaml``'s block on the flagship) on a non-ego theta:
its 128-channel node stack and its one-channel map of ones (2, 64, 128, 1).
``K3n`` is K3 on the pyramid levels' thetas at seeded widths (2, 3, 5, 6,
8, 12, 17, 33 channels) and on each level's concatenated map (65 / 129 /
257 channels): its routes and the crossover of its pixel and scalar
routes. Every fp32 K3 case on the rows route is also held bit for bit
against a copy of its map 4 bytes off a 16-byte boundary (the pixel or
scalar route). With any K3 case, an empty kernel is timed over a CUDA
graph of 200 launches: the floor a launch reaches. ``K3bn`` is K3b on
narrow maps: the HEAL pyramid step's one-channel occupancy-score
cotangents (``heal/stage1/m1_pyramid.yaml`` at full width, one forward and
backward) and, on the same thetas, seeded cotangents of 2, 3, 4, 6 and 8
channels, which place the crossover of its ``pixel`` and ``warp`` routes.
N1 runs on ``chip_smoke.py:nms_cases`` (car-sized boxes at random and
suppression chains K deep, K = 512 to 8,192) and on the lidar flagship's
own eval frame (K = 512, recorded from ``InferencePipeline.run``). For
each it
  * holds the kernel against its plain PyTorch version (K2 and K2b bit for
    bit; K4 within an fp32 sum-order tolerance, its order equal to a stable
    sort's; K3b within chip_smoke.py's tolerance, its pixel route bit for
    bit against its warp route; N1 bit for bit) and, K2b aside, two of its
    launches against each other, bit for bit;
  * times the wrapper with CUDA events, warm (back-to-back launches) and
    cold (a buffer larger than the L2 cache is written between launches),
    and, for K3, K3b and N1, over replays of a CUDA graph of 200 captured
    launches (``chip_smoke.graph_ms``: device time, no host work between
    launches), beside the one-call PyTorch yardstick (``torch.index_add``;
    ``scatter_reduce`` amax and its autograd; ``F.grid_sample`` and
    ``aten::grid_sampler_2d_backward``, the op autograd of ``grid_sample``
    runs for its input; N1 has none);
  * splits the device time per launch over its kernels, copies and memsets
    by name with torch.profiler (for N1 and K3b's pixel route, the
    package's kernel alone);
  * prints what ptxas reports for the sources (registers, shared memory).
With ``--old-csrc DIR`` (a directory that holds any of ``splat_topk.cu``,
``pillar_canvas_bwd.cu``, ``pillar_canvas.cu``, ``warp_affine_bwd.cu``,
``warp_affine.cu`` and ``nms_closure.cu``, e.g. written there by ``git
show <commit>:<path>``) that version is built
beside the package's and the two are timed in turns in this one process:
old, new, new, old. ``splat_topk.cu`` and ``pillar_canvas_bwd.cu`` there
must have the C interface of the port's first version of those kernels;
the old K4 includes the index preparation its wrapper did in PyTorch
(``torch.where`` and a stable ``torch.sort``). ``pillar_canvas.cu`` and
``warp_affine.cu`` have kept their C interface and run through the
package's wrappers; K3's old version must give the package's bits, fp32
and bf16 (an old ``warp_affine.cu`` has no pair entry: its pair case
times its two launches). ``warp_affine_bwd.cu`` there must have the C interface before
its ``route`` argument (any commit before the pixel route): it runs
through the package's wrapper with the route dropped, so on its one route.
``nms_closure.cu`` there must be the first version's (PRs 8-12): its
wrapper's scratch rule (none up to 1,280 boxes, K ceil(K / 32) words
above) is the old version's, and it takes at most 4,096 boxes, so larger
cases time the package's alone. ``--variant NAME=DIR`` (repeatable) builds
another version of any of the sources that has the package's current C
interface and times it
through the package's wrappers in the same turns, between the two "new"
turns; it is held to the same checks. One JSON object
goes to standard output last and, with ``--out``, to FILE.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

L2_FLUSH_BYTES = 128 << 20
SPLAT_TOL = 1e-5  # fp32 sums of a cell's rows in another order
# the sources this script times; splat_topk, pillar_canvas_bwd, nms_closure
# (its scratch) and warp_affine_bwd (its route) changed their C interface
# after the port's first version, the others did not
SOURCES = ("splat_topk", "pillar_canvas_bwd", "pillar_canvas", "warp_affine_bwd",
           "warp_affine", "nms_closure")
# K3bn's widths: the pyramid's one-channel scores and seeded wider maps
NARROW_WIDTHS = (1, 2, 3, 4, 6, 8)
# K3n's seeded widths on the pyramid levels' thetas: K3's routes and the
# crossover of its pixel and scalar routes
FORWARD_WIDTHS = (2, 3, 5, 6, 8, 12, 17, 33)
# the C entries of a source besides its own name (an older source may lack
# some: warp_affine_pair came after the others)
EXTRA_ENTRIES = {"warp_affine": ("warp_affine_bf16", "warp_affine_pair")}
# an empty kernel, timed over a CUDA graph as the floor of a launch
EMPTY_KERNEL = """
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
    empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
    return (int)cudaGetLastError();
}
"""


def time_ms(torch, fn, iters=50, warmup=5, flush=None):
    """Mean ms of ``fn`` over ``iters`` launches; with ``flush`` (a large
    tensor) each launch is timed on its own after the tensor is rewritten,
    which evicts the L2 cache."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if flush is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    pairs = []
    for _ in range(iters):
        flush.add_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def split_by_launch(torch, fn, n=20):
    """Device ms per call of ``fn`` of each kernel, copy and memset it
    launches, by name, and their sum under ``"all"``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            out[f"{ev.key[:70]} x{ev.count / n:g}"] = (
                ev.self_device_time_total / n / 1e3)
    out["all"] = sum(out.values())
    return out


def build_old(torch, _cuda, csrc):
    """Builds the sources of DIR and returns ({kernel name: the old version
    as a callable with the package wrapper's arguments}, {name: nvcc's
    output}). ``splat_topk`` and ``pillar_canvas_bwd`` are bound on the
    first version's C interface (the splat prepares its indices in PyTorch
    as that version's wrapper did); ``pillar_canvas`` and
    ``warp_affine_bwd`` run through the package's wrappers."""
    from gencomm_tpu_torch.ops import pillar_canvas as pc, warp

    out_dir = os.path.join(os.path.dirname(_cuda.BUILD_DIR), "kernels_old")
    os.makedirs(out_dir, exist_ok=True)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sigs = {"splat_topk": ("splat_topk_f32", [P] * 7 + [L, I, I, I, I, P]),
            "pillar_canvas_bwd": ("pillar_canvas_bwd_bf16",
                                  [P] * 6 + [L, L, I, I, P]),
            "pillar_canvas": _cuda.SIGNATURES["pillar_canvas"],
            "warp_affine_bwd": ("warp_affine_bwd_f32", [P] * 3 + [I] * 4 + [P]),
            "warp_affine": _cuda.SIGNATURES["warp_affine"],
            "nms_closure": ("nms_closure", [P] * 4 + [I, P])}
    fns, logs, extra = {}, {}, {}
    for name, (sym, argtypes) in sigs.items():
        if not os.path.exists(os.path.join(csrc, f"{name}.cu")):
            continue
        so = os.path.join(out_dir, f"lib{name}.so")
        done = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", so,
                               os.path.join(csrc, f"{name}.cu")], check=True,
                              capture_output=True, text=True)
        logs[name] = done.stdout + done.stderr
        lib = ctypes.CDLL(so)
        fn = getattr(lib, sym)
        fn.argtypes, fn.restype = argtypes, I
        fns[name] = fn
        for entry in EXTRA_ENTRIES.get(name, ()):
            esym, eargs = _cuda.SIGNATURES[entry][:2]
            if not hasattr(lib, esym):
                continue
            extra[entry] = getattr(lib, esym)
            extra[entry].argtypes, extra[entry].restype = eargs, I

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def splat(dvals, feats, ids, num_cells, bf16_rows):
        (p, k), c = dvals.shape, feats.shape[-1]
        valid = (ids >= 0) & (ids < num_cells)
        flat = torch.where(valid, ids,
                           torch.full_like(ids, num_cells)).reshape(-1)
        sids, order = torch.sort(flat, stable=True)
        order = order.to(torch.int32)
        canvas = torch.empty(num_cells, c, device=dvals.device)
        pieces = torch.empty(2, -(-p * k // 32), c, device=dvals.device)
        err = fns["splat_topk"](
            dvals.data_ptr(), feats.data_ptr(), sids.data_ptr(),
            order.data_ptr(), canvas.data_ptr(), pieces[0].data_ptr(),
            pieces[1].data_ptr(), p * k, k, c, num_cells, int(bf16_rows),
            stream())
        assert err == 0, err
        return canvas

    def canvas_bwd(rows, gids, canvas, gout, n_agents, ncell):
        m, c = rows.shape
        drows = torch.empty_like(rows)
        counts = torch.empty(-(-m // 32) * c, dtype=torch.int32,
                             device=rows.device)
        err = fns["pillar_canvas_bwd"](
            rows.data_ptr(), gids.data_ptr(), canvas.data_ptr(),
            gout.data_ptr(), drows.data_ptr(), counts.data_ptr(), m,
            m // n_agents, ncell, c, stream())
        assert err == 0, err
        return drows

    def nms_closure(overlap, valid):
        k = valid.numel()
        keep = torch.empty(k, dtype=torch.bool, device=valid.device)
        scratch = (torch.empty(k * -(-k // 32), dtype=torch.int32,
                               device=valid.device)
                   if 4 * k * -(-k // 32) > 200 * 1024 else None)
        err = fns["nms_closure"](
            overlap.data_ptr(), valid.data_ptr(), keep.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, k, stream())
        assert err == 0, err
        return keep

    def without_route(fn):
        # the package's K3b call (..., channels, route, stream) on the old
        # entry (..., channels, stream)
        return lambda *args: fn(*args[:7], args[-1])

    def wrapped(name, wrapper):
        # the package's wrapper with the old library bound while it runs
        entry = (without_route(fns[name]) if name == "warp_affine_bwd"
                 else fns[name])
        entries = {name: entry, **{e: extra[e] for e in
                                   EXTRA_ENTRIES.get(name, ()) if e in extra}}
        return through(_cuda, entries, wrapper)

    olds = {"splat_topk": splat, "pillar_canvas_bwd": canvas_bwd,
            "nms_closure": nms_closure}
    for name, wrapper in (("pillar_canvas", pc.pillar_canvas_fwd),
                          ("warp_affine_bwd", warp.warp_affine_bwd),
                          ("warp_affine", warp.warp_affine_fwd)):
        if name in fns:
            olds[name] = wrapped(name, wrapper)
    return {name: olds[name] for name in fns}, logs


def build_variant(_cuda, tag, csrc):
    """Builds the sources of DIR that stand for any of ``SOURCES`` with the
    package's C interface; returns
    ({kernel name: ctypes function}, {kernel name: nvcc's output})."""
    out_dir = os.path.join(os.path.dirname(_cuda.BUILD_DIR), f"kernels_{tag}")
    os.makedirs(out_dir, exist_ok=True)
    fns, logs = {}, {}
    for name in SOURCES:
        src = os.path.join(csrc, f"{name}.cu")
        if not os.path.exists(src):
            continue
        so = os.path.join(out_dir, f"lib{name}.so")
        done = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", so, src],
                              check=True, capture_output=True, text=True)
        logs[name] = done.stdout + done.stderr
        lib = ctypes.CDLL(so)
        for entry in (name, *EXTRA_ENTRIES.get(name, ())):
            sym, argtypes = _cuda.SIGNATURES[entry][:2]
            if not hasattr(lib, sym):
                continue
            fn = getattr(lib, sym)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[entry] = fn
    return fns, logs


def through(_cuda, fns, call):
    """``call`` with the package's wrappers bound to the functions ``fns``
    (by entry name) while it runs."""
    def run(*args):
        saved = {name: _cuda.library(name) for name in fns}
        _cuda._loaded.update(fns)
        try:
            return call(*args)
        finally:
            _cuda._loaded.update(saved)
    return run


def path_arguments(torch, dev, cases):
    """The arguments the port's paths give the kernels of ``cases``,
    recorded from one forward (and backward) of each model: ``splat_topk``
    on the camera eval frame and train step, ``pillar_canvas`` on the lidar
    eval frame and train step, ``pillar_canvas_bwd`` on the lidar train
    step, ``warp_affine_bwd`` on the lidar and camera train steps and
    (K3bn) the pyramid train step's score cotangents, ``warp_affine`` on
    the four eval frames (fp32 and bf16), ``nms_closure`` on the lidar
    flagship's eval frame and on ``chip_smoke.nms_cases``.
    Returns {path: {kernel name: arguments}}."""
    import chip_smoke as cs
    from gencomm_tpu_torch.data.bucketing import trim_agent_slots
    from gencomm_tpu_torch.data.decorate import decorate_modality
    from gencomm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
    from gencomm_tpu_torch.loss import build_loss
    from gencomm_tpu_torch.models.encoders import lss, point_pillar
    from gencomm_tpu_torch.models.fuse import fusion
    from gencomm_tpu_torch.models.heter_baseline import HeterModel
    from gencomm_tpu_torch.native import PillarVoxelizer
    from gencomm_tpu_torch.ops import pillar_canvas, warp
    from gencomm_tpu_torch.pipeline import batch_to_device
    from gencomm_tpu_torch.weights import random_state_dict

    def model_on(kw, train):
        model = HeterModel(**kw, device=dev)
        model.load_state_dict(random_state_dict(model, seed=0))
        return model.train() if train else model

    def noises(n, shape, seed):
        gen = torch.Generator().manual_seed(seed)
        return [torch.randn((n,) + shape, generator=gen).to(dev)
                for _ in range(3)]

    out = {}
    def eval_forward(model, batch, nz):
        with torch.inference_mode():
            model(batch, noises=nz) if nz is not None else model(batch)

    if {"K4", "K3b", "K3"} & cases:
        cam_scenes = SyntheticScenes(SyntheticConfig(
            lidar_range=cs.CAMERA_RANGE, max_cav=5, num_agents=2,
            num_vehicles=12, points_per_vehicle=300,
            modalities={"m1": {"sensor": "camera", "final_dim": cs.CAMERA_DIM,
                               "ncam": cs.CAMERA_NCAM}},
            max_spawn_radius=cs.CAMERA_GRID["ddiscr"][1] - 2.0))
    if {"K4", "K3"} & cases:
        host = trim_agent_slots(cam_scenes.sample(seed=0, batch_size=1),
                                buckets=(2, 3, 5))
        batch = batch_to_device(host, dev)
        nz = noises(host["agent_mask"].size, cs.CAMERA_FEATURE_SHAPE, 1)
        for half in (False, True) if "K3" in cases else (False,):
            model = model_on(dict(cs.CAMERA, half=half), False)
            out["camera eval bf16" if half else "camera eval"] = cs.record_calls(
                [(lss, "splat_topk"), (fusion, "warp_affine")],
                lambda: eval_forward(model, batch, nz))
    if {"K4", "K3b"} & cases:
        host = trim_agent_slots(cam_scenes.sample(cs.TRAIN_SEED * 10000,
                                                  cs.TRAIN_BATCH),
                                buckets=(2, 3, 5))
        model, batch = model_on(cs.CAMERA, True), batch_to_device(host, dev)
        nz = noises(host["agent_mask"].size, cs.CAMERA_FEATURE_SHAPE, 2)
        criterion = build_loss(cs.CAMERA_TRAIN_HYPES["loss"])
        out["camera step"] = cs.record_calls(
            [(lss, "splat_topk"), (warp, "warp_affine_bwd")],
            lambda: criterion(model(batch, noises=nz),
                              batch)["total_loss"].backward())
    if {"K2", "K2b", "K3b", "K3", "K3v"} & cases:
        scenes = SyntheticScenes(SyntheticConfig(
            lidar_range=cs.LIDAR_RANGE, max_cav=5, num_agents=2,
            points_per_agent=30000, num_vehicles=12, points_per_vehicle=300))
        voxelizer = PillarVoxelizer(cs.LIDAR_RANGE, cs.VOXEL)
    if {"K2", "K3", "K3v"} & cases:
        host_lidar = decorate_modality(trim_agent_slots(
            scenes.sample(seed=0, batch_size=1), buckets=(2, 3, 5)), voxelizer)
        batch_lidar = batch_to_device(host_lidar, dev)
        nz_lidar = noises(host_lidar["agent_mask"].size, cs.FEATURE_SHAPE, 1)
    if {"K2", "K3"} & cases:
        for half in (False, True) if "K3" in cases else (False,):
            model = model_on(dict(cs.FLAGSHIP, half=half), False)
            out["lidar eval bf16" if half else "lidar eval"] = cs.record_calls(
                [(point_pillar, "pillar_canvas"), (fusion, "warp_affine")],
                lambda: eval_forward(model, batch_lidar, nz_lidar))
    if {"K2", "K2b", "K3b"} & cases:
        host = decorate_modality(trim_agent_slots(
            scenes.sample(cs.TRAIN_SEED * 10000, cs.TRAIN_BATCH),
            buckets=(2, 3, 5)), voxelizer)
        model, batch = model_on(cs.FLAGSHIP, True), batch_to_device(host, dev)
        nz = noises(host["agent_mask"].size, cs.FEATURE_SHAPE, 2)
        criterion = build_loss(cs.TRAIN_HYPES["loss"])
        out["lidar step"] = cs.record_calls(
            [(point_pillar, "pillar_canvas"),
             (pillar_canvas, "pillar_canvas_bwd"), (warp, "warp_affine_bwd")],
            lambda: criterion(model(batch, noises=nz),
                              batch)["total_loss"].backward())
    if {"K3p", "K3n"} & cases:
        from gencomm_tpu_torch.models.heter_pyramid import HeterPyramidModel
        from gencomm_tpu_torch.tools import train as train_cli

        pscenes = train_cli.build_dataset(cs.PYRAMID_HYPES, True, "synthetic")
        host = train_cli.Adapt(cs.PYRAMID_HYPES)(pscenes.sample(0, 1))
        model = HeterPyramidModel(**cs.PYRAMID, device=dev)
        model.load_state_dict(random_state_dict(model, seed=0))
        batch = batch_to_device(host, dev)
        seen = cs.record_all(fusion, "warp_affine_pair",
                             lambda: eval_forward(model, batch, None))
        gen = torch.Generator(device=dev).manual_seed(14)
        for level, (feat, score, theta) in enumerate(seen):
            where = f"pyramid eval level {level}"
            out[f"{where} feature"] = {"warp_affine": (feat, theta)}
            out[f"{where} score"] = {"warp_affine": (score, theta)}
            out[f"{where} pair"] = {"warp_affine_pair": (feat, score, theta)}
            for c in FORWARD_WIDTHS:
                src = torch.randn(feat.shape[:3] + (c,), generator=gen,
                                  device=dev)
                out[f"{where}, {c} ch"] = {"warp_affine": (src, theta)}
            # the JAX package's form: the feature and score concatenated
            out[f"{where}, concatenated"] = {"warp_affine": (
                torch.cat([feat, score], dim=-1), theta)}
    if "K3v" in cases:
        l = host_lidar["agent_mask"].shape[1]
        model = model_on(cs.fusion_kwargs("v2vnet", l), False)
        seen = cs.record_all(fusion, "warp_affine", lambda: eval_forward(
            model, batch_lidar, nz_lidar))
        # the first iteration's warps into agent 1's frame: the node stack
        # and the map of ones
        for src, theta in seen[2:4]:
            out[f"v2vnet eval, non-ego theta, {src.shape[-1]} ch"] = {
                "warp_affine": (src, theta)}
    if "K3bn" in cases:
        from gencomm_tpu_torch.loss import create_loss
        from gencomm_tpu_torch.models.heter_pyramid import HeterPyramidModel
        from gencomm_tpu_torch.tools import train as train_cli

        pscenes = train_cli.build_dataset(cs.PYRAMID_HYPES, True, "synthetic")
        host = train_cli.Adapt(cs.PYRAMID_HYPES)(
            pscenes.sample(cs.TRAIN_SEED * 10000, cs.TRAIN_BATCH))
        model = HeterPyramidModel(**cs.PYRAMID, device=dev)
        model.load_state_dict(random_state_dict(model, seed=0))
        model.train()
        criterion, batch = create_loss(cs.PYRAMID_HYPES), batch_to_device(host, dev)
        seen = cs.record_all(warp, "warp_affine_bwd", lambda: criterion(
            model(batch), batch)["total_loss"].backward())
        gen = torch.Generator(device=dev).manual_seed(13)
        for g, theta in seen:
            if g.shape[-1] != 1:
                continue
            for c in NARROW_WIDTHS:
                gc = g if c == 1 else torch.randn(g.shape[:3] + (c,),
                                                  generator=gen, device=dev)
                out[f"pyramid step {g.shape[1]}x{g.shape[2]}, {c} ch"] = {
                    "warp_affine_bwd": (gc, theta)}
    if "N1" in cases:
        from gencomm_tpu_torch.bench import POSTPROCESS, build_flagship
        from gencomm_tpu_torch.ops import nms
        from gencomm_tpu_torch.pipeline import InferencePipeline

        fscenes, model, _ = build_flagship(half=False, device=dev)
        model.load_state_dict(random_state_dict(model, seed=0))
        pipe = InferencePipeline(model, fscenes.anchors, POSTPROCESS, device=dev)
        host = trim_agent_slots(fscenes.sample(seed=0, batch_size=1),
                                buckets=(2, 3, 5))
        batch = batch_to_device(pipe.decorate(host), dev)
        out["lidar eval frame"] = cs.record_calls(
            [(nms, "nms_closure")], lambda: pipe.run(batch, seed=0))
        pipe = None
        for label, args in cs.nms_cases(dev).items():
            out[label] = {"nms_closure": args}
    model = batch = nz = batch_lidar = None
    torch.cuda.empty_cache()
    return out


def run_stats(torch, keys):
    """Lengths of the runs of equal values in the sorted 1-D ``keys``."""
    _, counts = torch.unique_consecutive(keys, return_counts=True)
    c = counts.double()
    return {"runs": int(counts.numel()), "longest": int(counts.max()),
            "mean": float(c.mean()),
            "rows_in_runs_over_32": int(counts[counts > 32].sum()),
            "sum_of_squares": float((c * c).sum())}


def turns(torch, runs, order, iters, flush, graph=False):
    """{which_mode_ms: [ms per turn]} for the callables of ``runs`` taken in
    ``order``, warm and cold and, with ``graph``, over a CUDA graph."""
    import chip_smoke as cs

    out = {}
    for mode, fl in (("warm", None), ("cold", flush)):
        for which in order:
            out.setdefault(f"{which}_{mode}_ms", []).append(
                time_ms(torch, runs[which], iters, flush=fl))
    for which in order if graph else ():
        out.setdefault(f"{which}_graph_ms", []).append(cs.graph_ms(runs[which]))
    return out


def with_variants(_cuda, runs, order, variants, kernel, check):
    """Adds each variant that has ``kernel`` to ``runs`` and, between the
    two "new" turns, to ``order``; returns {variant: check(its result)}."""
    checks = {}
    at = order.index("new") + 1
    for tag, fns in variants.items():
        if kernel in fns:
            runs[tag] = through(_cuda, {e: fns[e] for e in (
                kernel, *EXTRA_ENTRIES.get(kernel, ())) if e in fns},
                runs["new"])
            order.insert(at, tag)
            at += 1
            checks[tag] = check(runs[tag]())
    return checks


def bench_splat(torch, label, args, old, variants, iters, flush):
    from gencomm_tpu_torch.ops import _cuda, splat as sp

    dvals, feats, ids, num_cells, bf16_rows = args
    (p, k), c = dvals.shape, feats.shape[-1]
    want = sp.splat_topk_plain(dvals, feats, ids, num_cells, bf16_rows)
    got = sp.splat_topk_fwd(dvals, feats, ids, num_cells, bf16_rows)
    again = sp.splat_topk_fwd(dvals, feats, ids, num_cells, bf16_rows)
    torch.cuda.synchronize()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    valid = (ids >= 0) & (ids < num_cells)
    row = {"dvals": [p, k], "channels": c, "num_cells": num_cells,
           "bf16_rows": bool(bf16_rows), "rows_kept": int(valid.sum()),
           "cells": run_stats(torch, ids[valid].sort().values),
           "max_abs_err": err, "max_plain": scale,
           "bit_equal_twice": bool(torch.equal(got, again)),
           "empty_cells_zero": bool((got[(want == 0).all(-1)] == 0).all())}
    ok = (err <= SPLAT_TOL * max(1.0, scale) and row["bit_equal_twice"]
          and row["empty_cells_zero"])
    if hasattr(sp, "splat_topk_with_order"):
        _, sids, order = sp.splat_topk_with_order(dvals, feats, ids, num_cells,
                                                  bf16_rows)
        ref_sids, ref_order = sp.sort_ids(ids, num_cells)
        n = int(valid.sum())
        row["order_is_stable_sort"] = bool(
            sids.numel() == n and torch.equal(order, ref_order[:n])
            and torch.equal(sids, ref_sids[:n]))
        ok = ok and row["order_is_stable_sort"]
    flat = torch.where(valid, ids, torch.full_like(ids, num_cells)
                       ).reshape(-1).long()
    rows = (dvals[..., None] * feats[:, None, :]).reshape(-1, c)
    zeros = torch.zeros(num_cells + 1, c, device=dvals.device)
    moved = (dvals.numel() + feats.numel() + ids.numel() + num_cells * c) * 4
    row["bound_ms"] = moved / 3.35e12 * 1e3
    runs = {"new": lambda: sp.splat_topk_fwd(dvals, feats, ids, num_cells,
                                             bf16_rows),
            "library": lambda: torch.index_add(zeros, 0, flat, rows)}
    order = ["new", "new", "library"]
    if old:
        runs["old"] = lambda: old(dvals, feats, ids, num_cells, bf16_rows)
        order = ["old", "new", "new", "old", "library"]
        row["old_equals_new_bits"] = bool(torch.equal(runs["old"](), got))
    row["variant_equals_new_bits"] = with_variants(
        _cuda, runs, order, variants, "splat_topk",
        lambda out: bool(torch.equal(out, got)))
    row.update(turns(torch, runs, order, iters, flush))
    for which in runs:
        row[f"{which}_split_ms"] = split_by_launch(torch, runs[which])
    row["ok"] = bool(ok)
    print(label, json.dumps(row), flush=True)
    return row


def bench_canvas_bwd(torch, label, args, old, variants, iters, flush):
    from gencomm_tpu_torch.ops import _cuda, pillar_canvas as pc

    rows, gids, canvas, gout, n_agents, ncell = args
    m, c = rows.shape
    want = pc.pillar_canvas_bwd_plain(rows, gids, canvas, gout, n_agents, ncell)
    got = pc.pillar_canvas_bwd(rows, gids, canvas, gout, n_agents, ncell)
    torch.cuda.synchronize()
    cells = (torch.arange(m, device=rows.device) // (m // n_agents) * ncell
             + gids.long().clamp(0, ncell - 1))
    stats = run_stats(torch, cells)
    tail = [int((gids.view(n_agents, -1)[a] >= ncell - 1).sum())
            for a in range(n_agents)]
    row = {"rows": [m, c], "n_agents": n_agents, "ncell": ncell,
           "cells": stats, "rows_in_last_cell_per_agent": tail,
           "bit_exact": bool(torch.equal(got.view(torch.int16),
                                         want.view(torch.int16)))}
    r_req = rows.detach().clone().requires_grad_()
    lib_out = torch.zeros(n_agents * ncell, c, dtype=rows.dtype,
                          device=rows.device).scatter_reduce(
        0, cells[:, None].expand(m, c), r_req, "amax", include_self=True)
    gflat = gout.reshape(-1, c)
    moved = (2 * rows.numel() * 2 + gids.numel() * 4
             + 2 * stats["runs"] * c * 2)
    row["bound_ms"] = moved / 3.35e12 * 1e3
    runs = {"new": lambda: pc.pillar_canvas_bwd(rows, gids, canvas, gout,
                                                n_agents, ncell),
            "library": lambda: torch.autograd.grad(lib_out, r_req, gflat,
                                                   retain_graph=True)}
    order = ["new", "new", "library"]
    if old:
        runs["old"] = lambda: old(rows, gids, canvas, gout, n_agents, ncell)
        order = ["old", "new", "new", "old", "library"]
        row["old_equals_new_bits"] = bool(torch.equal(
            runs["old"]().view(torch.int16), got.view(torch.int16)))
    row["variant_equals_new_bits"] = with_variants(
        _cuda, runs, order, variants, "pillar_canvas_bwd",
        lambda out: bool(torch.equal(out.view(torch.int16),
                                     got.view(torch.int16))))
    row.update(turns(torch, runs, order, iters, flush))
    for which in runs:
        row[f"{which}_split_ms"] = split_by_launch(torch, runs[which])
    row["ok"] = row["bit_exact"]
    print(label, json.dumps(row), flush=True)
    return row


def bench_canvas(torch, label, args, old, variants, iters, flush):
    from gencomm_tpu_torch.ops import _cuda, pillar_canvas as pc

    rows, gids, n_agents, ncell = args
    m, c = rows.shape
    want = pc.pillar_canvas_plain(rows, gids, n_agents, ncell)
    got = pc.pillar_canvas_fwd(rows, gids, n_agents, ncell)
    again = pc.pillar_canvas_fwd(rows, gids, n_agents, ncell)
    torch.cuda.synchronize()
    cells = (torch.arange(m, device=rows.device) // (m // n_agents) * ncell
             + gids.long().clamp(0, ncell - 1))
    tail = [int((gids.view(n_agents, -1)[a] >= ncell - 1).sum())
            for a in range(n_agents)]

    def bits(t):
        return t.view(torch.int16)

    row = {"rows": [m, c], "n_agents": n_agents, "ncell": ncell,
           "cells": run_stats(torch, cells), "rows_in_last_cell_per_agent": tail,
           "bit_exact": bool(torch.equal(bits(got), bits(want))),
           "bit_equal_twice": bool(torch.equal(bits(got), bits(again)))}
    flat = cells[:, None].expand(m, c)
    zeros = torch.zeros(n_agents * ncell, c, dtype=rows.dtype,
                        device=rows.device)
    row["bound_ms"] = (rows.numel() * 2 + gids.numel() * 4
                       + got.numel() * 2) / 3.35e12 * 1e3
    runs = {"new": lambda: pc.pillar_canvas_fwd(rows, gids, n_agents, ncell),
            "library": lambda: torch.scatter_reduce(zeros, 0, flat, rows,
                                                    "amax", include_self=True)}
    order = ["new", "new", "library"]
    if old:
        runs["old"] = lambda: old(rows, gids, n_agents, ncell)
        order = ["old", "new", "new", "old", "library"]
        row["old_equals_new_bits"] = bool(torch.equal(bits(runs["old"]()),
                                                      bits(got)))
    row["variant_equals_new_bits"] = with_variants(
        _cuda, runs, order, variants, "pillar_canvas",
        lambda out: bool(torch.equal(bits(out), bits(got))))
    row.update(turns(torch, runs, order, iters, flush))
    for which in runs:
        row[f"{which}_split_ms"] = split_by_launch(torch, runs[which])
    row["ok"] = row["bit_exact"] and row["bit_equal_twice"]
    print(label, json.dumps(row), flush=True)
    return row


def bench_warp_bwd(torch, label, args, old, variants, iters, flush):
    import torch.nn.functional as F
    from gencomm_tpu_torch.ops import _cuda, warp

    g, theta = args
    n, h, w, c = g.shape
    route = warp.backward_route(c)
    want = warp.warp_affine_bwd_plain(g, theta)
    got = warp.warp_affine_bwd(g, theta)
    again = warp.warp_affine_bwd(g, theta)
    torch.cuda.synchronize()
    tol = 16.0 * max(h, w) * 2.0 ** -23 * float(g.abs().max())
    row = {"g": [n, h, w, c], "theta": theta.reshape(n, 6).tolist(),
           "route": route, "max_abs_err": float((got - want).abs().max()),
           "tol": tol, "bit_equal_twice": bool(torch.equal(got, again))}
    src = torch.zeros(n, c, h, w, device=g.device)
    grid = F.affine_grid(theta, [n, c, h, w], align_corners=False)
    g_nchw = g.permute(0, 3, 1, 2).contiguous()
    row["bound_ms"] = (2 * g.numel() * 4 + theta.numel() * 4) / 3.35e12 * 1e3
    runs = {"new": lambda: warp.warp_affine_bwd(g, theta),
            "library": lambda: torch.ops.aten.grid_sampler_2d_backward(
                g_nchw, src, grid, 0, 0, False, [True, False])[0]}
    order = ["new", "new", "library"]
    ok = row["max_abs_err"] <= tol and row["bit_equal_twice"]
    if route == "pixel":
        runs["warp"] = lambda: warp.warp_affine_bwd(g, theta, "warp")
        order = ["new", "warp", "warp", "new", "library"]
        row["pixel_equals_warp_route"] = bool(torch.equal(runs["warp"](), got))
        ok = ok and row["pixel_equals_warp_route"]

    def close(out):
        return float((out - want).abs().max()) <= tol

    if old:
        runs["old"] = lambda: old(g, theta)
        order = ["old"] + order[:-1] + ["old", "library"]
        row["old_within_tol"] = close(runs["old"]())
    row["variant_within_tol"] = with_variants(
        _cuda, runs, order, variants, "warp_affine_bwd", close)
    row.update(turns(torch, runs, order, iters, flush, graph=True))
    for which in runs if route == "warp" else ("new",):
        row[f"{which}_split_ms"] = split_by_launch(torch, runs[which])
    row["ok"] = bool(ok)
    print(label, json.dumps(row), flush=True)
    return row


def bench_nms(torch, label, args, old, variants, iters, flush):
    import chip_smoke as cs
    from gencomm_tpu_torch.ops import _cuda, nms

    over, valid = args
    k = valid.numel()
    want = nms.nms_closure_plain(over, valid)
    got = nms.nms_closure(over, valid)
    again = nms.nms_closure(over, valid)
    torch.cuda.synchronize()
    row = {"k": k, "valid": int(valid.sum()), "kept": int(want.sum()),
           "storage_route": nms.storage_route(k),
           "bound_ms": cs.nms_bound(want)[0],
           "bit_exact": bool(torch.equal(got, want)),
           "bit_equal_twice": bool(torch.equal(got, again))}
    ok = row["bit_exact"] and row["bit_equal_twice"]
    runs = {"new": lambda: nms.nms_closure(over, valid)}
    order = ["new", "new"]
    if old and k <= 4096:
        runs["old"] = lambda: old(over, valid)
        order = ["old", "new", "new", "old"]
        row["old_equals_new_bits"] = bool(torch.equal(runs["old"](), got))
        ok = ok and row["old_equals_new_bits"]
    row["variant_equals_new_bits"] = with_variants(
        _cuda, runs, order, variants, "nms_closure",
        lambda out: bool(torch.equal(out, got)))
    ok = ok and all(row["variant_equals_new_bits"].values())
    row.update(turns(torch, runs, order, iters, flush, graph=True))
    row["plain_ms"] = time_ms(torch, lambda: nms.nms_closure_plain(over, valid),
                              iters=3, warmup=1)
    row["new_split_ms"] = split_by_launch(torch, runs["new"])
    row["ok"] = bool(ok)
    print(label, json.dumps(row), flush=True)
    return row


def offset_copy(torch, t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary: K3 takes it off its rows route."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def bench_warp(torch, label, args, old, variants, iters, flush):
    import torch.nn.functional as F
    import chip_smoke as cs
    from gencomm_tpu_torch.ops import _cuda, warp

    src, theta = args
    n, h, w, c = src.shape
    half = src.dtype == torch.bfloat16
    want = warp.warp_affine_plain(src, theta)
    got = warp.warp_affine_fwd(src, theta)
    again = warp.warp_affine_fwd(src, theta)
    torch.cuda.synchronize()
    scale = float(src.float().abs().max())
    tol = cs.warp_tolerance(src.float()) + (2.0 ** -7 * scale if half else 0.0)
    aligned = src.data_ptr() % 16 == 0
    row = {"src": [n, h, w, c], "dtype": "bf16" if half else "fp32",
           "route": warp.forward_route(c, aligned, 8 if half else 4),
           "theta": theta.reshape(n, 6).tolist(),
           "max_abs_err": float((got.float() - want.float()).abs().max()),
           "tol": tol, "bit_equal_twice": bool(torch.equal(got, again))}
    ok = row["max_abs_err"] <= tol and row["bit_equal_twice"]
    if half:
        row["equals_fp32_kernel_rounded"] = bool(torch.equal(
            got, warp.warp_affine_fwd(src.float(), theta).to(torch.bfloat16)))
        ok = ok and row["equals_fp32_kernel_rounded"]
    if row["route"] == "rows":
        # the same map 4 bytes off a 16-byte boundary: pixel or scalar
        off = offset_copy(torch, src)
        other = warp.forward_route(c, False, 8 if half else 4)
        row[f"equals_{other}_route"] = bool(torch.equal(
            warp.warp_affine_fwd(off, theta), got))
        ok = ok and row[f"equals_{other}_route"]
    src_nchw = src.permute(0, 3, 1, 2).contiguous()
    grid = F.affine_grid(theta.to(src.dtype), list(src_nchw.shape),
                         align_corners=False)
    row["bound_ms"] = (2 * src.numel() * src.element_size()
                       + theta.numel() * 4) / 3.35e12 * 1e3
    name = "warp_affine_bf16" if half else "warp_affine"
    runs = {"new": lambda: warp.warp_affine_fwd(src, theta),
            "library": lambda: F.grid_sample(src_nchw, grid, mode="bilinear",
                                             padding_mode="zeros",
                                             align_corners=False)}
    order = ["new", "new", "library"]
    if old:
        runs["old"] = lambda: old(src, theta)
        order = ["old", "new", "new", "old", "library"]
        row["old_equals_new_bits"] = bool(torch.equal(runs["old"](), got))
        ok = ok and row["old_equals_new_bits"]
    row["variant_equals_new_bits"] = with_variants(
        _cuda, runs, order, variants, "warp_affine",
        lambda out: bool(torch.equal(out, got)))
    ok = ok and all(row["variant_equals_new_bits"].values())
    row.update(turns(torch, runs, order, iters, flush, graph=True))
    for which in ("new", "library"):
        row[f"{which}_split_ms"] = split_by_launch(torch, runs[which])
    row["entry"] = name
    row["ok"] = bool(ok)
    print(label, json.dumps(row), flush=True)
    return row


def bench_warp_pair(torch, label, args, old, variants, iters, flush):
    """A pyramid level's feature and score: one pair launch against the two
    launches (this package's and, with ``old``, the old source's) and the
    JAX package's form (the two concatenated, one launch), all with the
    bits of the two launches."""
    from gencomm_tpu_torch.ops import _cuda, warp

    feat, score, theta = args
    n, h, w, c = feat.shape
    got, got_s = warp.warp_affine_pair_fwd(feat, score, theta)
    two = (warp.warp_affine_fwd(feat, theta), warp.warp_affine_fwd(score, theta))
    cat = warp.warp_affine_fwd(torch.cat([feat, score], dim=-1), theta)
    torch.cuda.synchronize()
    row = {"feat": [n, h, w, c], "score": list(score.shape),
           "route": warp.forward_route(c, feat.data_ptr() % 16 == 0),
           "pair_equals_two_launches": bool(torch.equal(got, two[0])
                                            and torch.equal(got_s, two[1])),
           "cat_equals_two_launches": bool(
               torch.equal(cat[..., :c], two[0])
               and torch.equal(cat[..., c:], two[1]))}
    ok = row["pair_equals_two_launches"] and row["cat_equals_two_launches"]
    row["bound_ms"] = (2 * (feat.numel() + score.numel()) * 4
                       + theta.numel() * 4) / 3.35e12 * 1e3
    runs = {"new": lambda: warp.warp_affine_pair_fwd(feat, score, theta),
            "two": lambda: (warp.warp_affine_fwd(feat, theta),
                            warp.warp_affine_fwd(score, theta)),
            "cat": lambda: warp.warp_affine_fwd(
                torch.cat([feat, score], dim=-1), theta)}
    order = ["two", "new", "new", "two", "cat"]
    if old:
        runs["old"] = lambda: (old(feat, theta), old(score, theta))
        order = ["old"] + order + ["old"]
        ob = runs["old"]()
        row["old_two_equal_pair"] = bool(torch.equal(ob[0], got)
                                         and torch.equal(ob[1], got_s))
        ok = ok and row["old_two_equal_pair"]
    row["variant_equals_new_bits"] = with_variants(
        _cuda, runs, order, variants, "warp_affine",
        lambda out: bool(torch.equal(out[0], got) and torch.equal(out[1], got_s)))
    ok = ok and all(row["variant_equals_new_bits"].values())
    row.update(turns(torch, runs, order, iters, flush, graph=True))
    row["new_split_ms"] = split_by_launch(torch, runs["new"])
    row["ok"] = bool(ok)
    print(label, json.dumps(row), flush=True)
    return row


def empty_kernel_graph_ms(torch, _cuda):
    """An empty kernel's device ms a launch over a CUDA graph of
    ``chip_smoke.GRAPH_LAUNCHES`` launches: the floor a launch reaches."""
    import chip_smoke as cs

    out_dir = os.path.join(os.path.dirname(_cuda.BUILD_DIR), "kernels_empty")
    os.makedirs(out_dir, exist_ok=True)
    src, so = (os.path.join(out_dir, f) for f in ("empty.cu", "libempty.so"))
    with open(src, "w") as f:
        f.write(EMPTY_KERNEL)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", so, src],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(so).empty_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def launch():
        assert fn(torch.cuda.current_stream().cuda_stream) == 0

    return [cs.graph_ms(launch) for _ in range(3)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", default=None)
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR")
    ap.add_argument("--cases", default="K4,K2,K2b,K3b",
                    help="comma-separated kernels to time")
    ap.add_argument("--out", default=None)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    cases = set(args.cases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("bench_splat_canvas_torch: no CUDA device is available",
              file=sys.stderr)
        return 1
    from gencomm_tpu_torch.ops import _cuda

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    _cuda.build_all()
    logs = {n: _cuda.build_log.get(n, "") for n in SOURCES}
    old = build_old(torch, _cuda, args.old_csrc) if args.old_csrc else None
    if old:
        logs.update({f"{n} (old)": text for n, text in old[1].items()})
    variants = {}
    for spec in args.variant:
        tag, csrc = spec.split("=", 1)
        variants[tag], vlogs = build_variant(_cuda, tag, csrc)
        logs.update({f"{n} ({tag})": text for n, text in vlogs.items()})
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
    paths = path_arguments(torch, dev, cases)
    flush = torch.zeros(L2_FLUSH_BYTES // 4, device=dev)
    olds = old[0] if old else {}

    result = {"card": smi, "cases": {}}
    if {"K3", "K3p", "K3v", "K3n"} & cases:
        result["empty_kernel_graph_ms"] = empty_kernel_graph_ms(torch, _cuda)
        print(f"empty kernel over a CUDA graph: "
              f"{result['empty_kernel_graph_ms']} ms a launch", flush=True)
    plan = [("K4", "camera eval", "splat_topk", bench_splat),
            ("K4", "camera step", "splat_topk", bench_splat),
            ("K2", "lidar eval", "pillar_canvas", bench_canvas),
            ("K2", "lidar step", "pillar_canvas", bench_canvas),
            ("K2b", "lidar step", "pillar_canvas_bwd", bench_canvas_bwd),
            ("K3b", "lidar step", "warp_affine_bwd", bench_warp_bwd),
            ("K3b", "camera step", "warp_affine_bwd", bench_warp_bwd),
            ("K3", "lidar eval", "warp_affine", bench_warp),
            ("K3", "lidar eval bf16", "warp_affine", bench_warp),
            ("K3", "camera eval", "warp_affine", bench_warp),
            ("K3", "camera eval bf16", "warp_affine", bench_warp)]
    plan += [("K3v", path, "warp_affine", bench_warp)
             for path in paths if path.startswith("v2vnet eval")]
    plan += [("K3p", path, name, bench)
             for path, seen in paths.items() if path.startswith("pyramid eval")
             and ", " not in path
             for name, bench in (("warp_affine", bench_warp),
                                 ("warp_affine_pair", bench_warp_pair))
             if name in seen]
    plan += [("K3n", path, "warp_affine", bench_warp)
             for path in paths if path.startswith("pyramid eval")
             and ", " in path]
    plan += [("K3bn", path, "warp_affine_bwd", bench_warp_bwd)
             for path in paths if path.startswith("pyramid step")]
    plan += [("N1", path, "nms_closure", bench_nms)
             for path, seen in paths.items() if "nms_closure" in seen]
    for kernel, path, name, bench in plan:
        if kernel in cases:
            label = f"{kernel} {path}"
            result["cases"][label] = bench(
                torch, label, paths[path][name], olds.get(name), variants,
                args.iters, flush)
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0 if all(r["ok"] for r in result["cases"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
