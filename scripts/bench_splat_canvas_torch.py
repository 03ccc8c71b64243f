#!/usr/bin/env python3
"""Times the port's top-K depth splat K4 and pillar-canvas backward K2b on
one NVIDIA GPU, on the arguments the port's own paths give them.

    python3 scripts/bench_splat_canvas_torch.py [--old-csrc DIR]
        [--variant NAME=DIR ...] [--out FILE]

The arguments are recorded from the port's models at random weights (seed 0)
on the synthetic sampler's scenes (seed 0), as ``chip_smoke.py`` records
them, so run lengths, the dropped rows and the invalid-row tail are the
paths' own: K4 on the camera eval frame (24,576 pixels x top-8, 131,072
cells) and the camera train step (49,152 pixels, 262,144 cells), K2b on the
lidar train step (4 x 30,000 rows of 64 bf16 channels, 4 x 131,072 cells).
For each it
  * holds the kernel against its plain PyTorch version (K2b bit for bit; K4
    within an fp32 sum-order tolerance, two launches bit-equal, its order
    equal to a stable sort's);
  * times the wrapper with CUDA events, warm (back-to-back launches) and
    cold (a buffer larger than the L2 cache is written between launches),
    beside the one-call PyTorch yardstick (``torch.index_add``; autograd of
    ``scatter_reduce`` amax);
  * splits the device time per launch over its kernels, copies and memsets
    by name with torch.profiler;
  * prints what ptxas reports for both sources (registers, shared memory).
With ``--old-csrc DIR`` (a directory that holds ``splat_topk.cu`` and
``pillar_canvas_bwd.cu`` with the C interface of the port's first version of
these kernels, e.g. written there by ``git show <commit>:<path>``) that
version is built beside the package's and the two are timed in turns in
this one process: old, new, new, old. The old K4 includes the index
preparation its wrapper did in PyTorch (``torch.where`` and a stable
``torch.sort``). ``--variant NAME=DIR`` (repeatable) builds another version
of either source that has the package's current C interface and times it
through the package's wrappers in the same turns, between the two "new"
turns; it is held to the same checks. One JSON object goes to standard
output last and, with ``--out``, to FILE.
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
    """Builds DIR/splat_topk.cu and DIR/pillar_canvas_bwd.cu and returns
    (splat(dvals, feats, ids, num_cells, bf16_rows), canvas_bwd(rows, gids,
    canvas, gout, n_agents, ncell)) on the first version's C interface; the
    splat prepares its indices in PyTorch as that version's wrapper did."""
    out_dir = os.path.join(os.path.dirname(_cuda.BUILD_DIR), "kernels_old")
    os.makedirs(out_dir, exist_ok=True)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sigs = {"splat_topk": ("splat_topk_f32", [P] * 7 + [L, I, I, I, I, P]),
            "pillar_canvas_bwd": ("pillar_canvas_bwd_bf16",
                                  [P] * 6 + [L, L, I, I, P])}
    fns, logs = {}, {}
    for name, (sym, argtypes) in sigs.items():
        so = os.path.join(out_dir, f"lib{name}.so")
        done = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", so,
                               os.path.join(csrc, f"{name}.cu")], check=True,
                              capture_output=True, text=True)
        logs[name] = done.stdout + done.stderr
        fn = getattr(ctypes.CDLL(so), sym)
        fn.argtypes, fn.restype = argtypes, I
        fns[name] = fn

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

    return splat, canvas_bwd, logs


def build_variant(_cuda, tag, csrc):
    """Builds the sources of DIR that stand for ``splat_topk.cu`` or
    ``pillar_canvas_bwd.cu`` with the package's C interface; returns
    ({kernel name: ctypes function}, {kernel name: nvcc's output})."""
    out_dir = os.path.join(os.path.dirname(_cuda.BUILD_DIR), f"kernels_{tag}")
    os.makedirs(out_dir, exist_ok=True)
    fns, logs = {}, {}
    for name in ("splat_topk", "pillar_canvas_bwd"):
        src = os.path.join(csrc, f"{name}.cu")
        if not os.path.exists(src):
            continue
        so = os.path.join(out_dir, f"lib{name}.so")
        done = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", so, src],
                              check=True, capture_output=True, text=True)
        logs[name] = done.stdout + done.stderr
        sym, argtypes = _cuda.SIGNATURES[name]
        fn = getattr(ctypes.CDLL(so), sym)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns, logs


def through(_cuda, fns, call):
    """``call`` with the package's wrappers bound to the variant's
    functions ``fns`` while it runs."""
    saved = {name: _cuda.library(name) for name in fns}

    def run():
        _cuda._loaded.update(fns)
        try:
            return call()
        finally:
            _cuda._loaded.update(saved)
    return run


def path_arguments(torch, dev):
    """The arguments the port's camera eval frame and camera train step give
    ``splat_topk`` and the lidar train step gives ``pillar_canvas_bwd``,
    recorded from one forward (and backward) of each model."""
    import chip_smoke as cs
    from gencomm_tpu_torch.data.bucketing import trim_agent_slots
    from gencomm_tpu_torch.data.decorate import decorate_modality
    from gencomm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
    from gencomm_tpu_torch.loss import build_loss
    from gencomm_tpu_torch.models.encoders import lss
    from gencomm_tpu_torch.models.heter_baseline import HeterModel
    from gencomm_tpu_torch.native import PillarVoxelizer
    from gencomm_tpu_torch.ops import pillar_canvas
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

    cam_scenes = SyntheticScenes(SyntheticConfig(
        lidar_range=cs.CAMERA_RANGE, max_cav=5, num_agents=2, num_vehicles=12,
        points_per_vehicle=300,
        modalities={"m1": {"sensor": "camera", "final_dim": cs.CAMERA_DIM,
                           "ncam": cs.CAMERA_NCAM}},
        max_spawn_radius=cs.CAMERA_GRID["ddiscr"][1] - 2.0))
    out = {}

    host = trim_agent_slots(cam_scenes.sample(seed=0, batch_size=1),
                            buckets=(2, 3, 5))
    model, batch = model_on(cs.CAMERA, False), batch_to_device(host, dev)
    nz = noises(host["agent_mask"].size, cs.CAMERA_FEATURE_SHAPE, 1)

    def eval_forward():
        with torch.inference_mode():
            model(batch, noises=nz)

    out["camera eval"] = cs.record_calls([(lss, "splat_topk")],
                                         eval_forward)["splat_topk"]

    host = trim_agent_slots(cam_scenes.sample(cs.TRAIN_SEED * 10000,
                                              cs.TRAIN_BATCH), buckets=(2, 3, 5))
    model, batch = model_on(cs.CAMERA, True), batch_to_device(host, dev)
    nz = noises(host["agent_mask"].size, cs.CAMERA_FEATURE_SHAPE, 2)
    with torch.no_grad():
        out["camera step"] = cs.record_calls(
            [(lss, "splat_topk")],
            lambda: model(batch, noises=nz))["splat_topk"]

    scenes = SyntheticScenes(SyntheticConfig(
        lidar_range=cs.LIDAR_RANGE, max_cav=5, num_agents=2,
        points_per_agent=30000, num_vehicles=12, points_per_vehicle=300))
    host = decorate_modality(trim_agent_slots(
        scenes.sample(cs.TRAIN_SEED * 10000, cs.TRAIN_BATCH),
        buckets=(2, 3, 5)), PillarVoxelizer(cs.LIDAR_RANGE, cs.VOXEL))
    model, batch = model_on(cs.FLAGSHIP, True), batch_to_device(host, dev)
    nz = noises(host["agent_mask"].size, cs.FEATURE_SHAPE, 2)
    criterion = build_loss(cs.TRAIN_HYPES["loss"])
    out["lidar step"] = cs.record_calls(
        [(pillar_canvas, "pillar_canvas_bwd")],
        lambda: criterion(model(batch, noises=nz),
                          batch)["total_loss"].backward())["pillar_canvas_bwd"]
    del model, batch, nz
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


def turns(torch, runs, order, iters, flush):
    """{which_mode_ms: [ms per turn]} for the callables of ``runs`` taken in
    ``order``, warm and cold."""
    out = {}
    for mode, fl in (("warm", None), ("cold", flush)):
        for which in order:
            out.setdefault(f"{which}_{mode}_ms", []).append(
                time_ms(torch, runs[which], iters, flush=fl))
    return out


def with_variants(_cuda, runs, order, variants, kernel, check):
    """Adds each variant that has ``kernel`` to ``runs`` and, between the
    two "new" turns, to ``order``; returns {variant: check(its result)}."""
    checks = {}
    at = order.index("new") + 1
    for tag, fns in variants.items():
        if kernel in fns:
            runs[tag] = through(_cuda, {kernel: fns[kernel]}, runs["new"])
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", default=None)
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR")
    ap.add_argument("--out", default=None)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()

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
    logs = {n: _cuda.build_log.get(n, "")
            for n in ("splat_topk", "pillar_canvas_bwd")}
    old = build_old(torch, _cuda, args.old_csrc) if args.old_csrc else None
    if old:
        logs.update({f"{n} (old)": text for n, text in old[2].items()})
    variants = {}
    for spec in args.variant:
        tag, csrc = spec.split("=", 1)
        variants[tag], vlogs = build_variant(_cuda, tag, csrc)
        logs.update({f"{n} ({tag})": text for n, text in vlogs.items()})
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
    paths = path_arguments(torch, dev)
    flush = torch.zeros(L2_FLUSH_BYTES // 4, device=dev)

    result = {"card": smi, "cases": {}}
    for label in ("camera eval", "camera step"):
        result["cases"][f"K4 {label}"] = bench_splat(
            torch, f"K4 {label}", paths[label], old and old[0], variants,
            args.iters, flush)
    result["cases"]["K2b lidar step"] = bench_canvas_bwd(
        torch, "K2b lidar step", paths["lidar step"], old and old[1],
        variants, args.iters, flush)
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0 if all(r["ok"] for r in result["cases"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
