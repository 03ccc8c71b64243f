#!/usr/bin/env python3
"""Times the port's deformable-conv kernels K1 (forward) and K1b (backward)
on one NVIDIA GPU, at the shapes the port's paths give them.

    python3 scripts/bench_deform_torch.py [--dtype fp32|bf16] [--parts]
        [--old-csrc DIR] [--variant NAME=DIR ...] [--out FILE]

``--dtype fp32`` (the default): the four fp32 shapes (lidar eval, lidar
step, camera eval, camera step; NHWC, 128 -> 64 channels, offsets from a
seed, clamped to +-4). For each it
  * holds K1 and K1b against their plain PyTorch versions;
  * times them with CUDA events, warm (back-to-back launches) and cold (a
    buffer larger than the L2 cache is written between launches);
  * splits each call's device time over its launches (memset and kernels,
    by name) with torch.profiler;
  * prints what ptxas reports for both sources (registers, shared memory).
``--dtype bf16``: K1's bf16 instantiation (``half=True``) at the two bf16
eval shapes (lidar eval and camera eval, x bf16). For each it holds the
kernel against its plain version (1e-4 x max(1, scale) + one bf16 step),
two of its launches against each other (bit for bit) and its output against
the fp32 kernel's on the widened map, rounded once: it counts the outputs
that differ and requires each to lie within one bf16 step (taken at no less
than 2^-8 of the largest value). It times the
kernel as above and gives its device time from torch.profiler.

``--parts`` builds the package's ``deform_conv.cu`` twice more, with
``K1_PART=1`` (the product only: no corner row is read) and ``K1_PART=2``
(the sampling only: no products), and times both in the same turns: the
split of the tensor-core route's time.

``--dtype fp32`` also times K1b on concentrated offsets: every tap of every
pixel pulled to one point of its pixel's block (9 x 9 pixels with the
offsets clamped to +-4, as the message extractor clamps them; 32 x 32 and
one point an image unclamped, as route ``general`` takes them), where the
input gradient's records pile onto a few pixels and K4's order pass sorts
long segments. Each case is held against the plain version and itself
twice, and reports the most records a pixel receives.

``--old-csrc DIR`` (a directory that holds another version of
``deform_conv.cu``, ``deform_conv_bwd.cu`` and ``deform_common.cuh``, e.g.
``git archive <commit> gencomm_tpu_torch/csrc`` unpacked; K1 must take the
route argument, PR 4's and later trees) builds that version beside the
package's and times the two in turns in this one process: old, new,
(parts,) new, old. A K1b that adds its input gradient by atomics (trees
before the fixed-order sum, e.g. 6b6c033) is bound through its own C
interface (``OLD_K1B_ARGTYPES``), and its dx is also checked against the
plain version and against itself on a second launch. It also confirms
that K1 fp32 gives the old version's bits at its four shapes.

``--variant NAME=DIR`` (repeatable, with ``--dtype bf16``) builds another
``deform_conv.cu`` with the package's C interface and times it in the same
turns, held to the same checks: the way to try a change of the source
against the package's in one call.

One JSON object goes to standard output last and, with ``--out``, to FILE.
Exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import bf16_steps_apart  # noqa: E402

SHAPES = {"lidar eval": (2, 64, 128), "lidar step": (4, 64, 128),
          "camera eval": (2, 64, 64), "camera step": (4, 64, 64)}
BF16_SHAPES = ("lidar eval", "camera eval")
CIN, COUT = 128, 64
L2_FLUSH_BYTES = 128 << 20
# the C entries of each source
ENTRIES = {"deform_conv": ("deform_conv", "deform_conv_bf16"),
           "deform_conv_bwd": ("deform_conv_bwd",)}
# the C interface of a K1b that adds dx by atomics: x, offsets, weight, g,
# dx, doffsets, dweight, scratch, b, h, w, cin, cout, nsplit, route, stream
OLD_K1B_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
# K1b on concentrated offsets: (label, (b, h, w, cin, cout), the block whose
# taps meet at one point (None: one point an image), the clamp or None)
CONCENTRATED = (("lidar step, 9 x 9 blocks, clamped", (4, 64, 128, CIN, COUT), 9, 4.0),
                ("lidar step, 32 x 32 blocks", (4, 64, 128, CIN, COUT), 32, None),
                ("lidar step, one point an image", (4, 64, 128, CIN, COUT), None, None),
                ("general route, one point an image", (2, 20, 36, 40, 70), None, None))


def make_inputs(torch, b, h, w, seed, dev, cin=CIN, cout=COUT, clamp=4.0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, cin, generator=gen)
    off = (torch.randn(b, h, w, 18, generator=gen) * 1.5).clamp(-clamp, clamp)
    wt = torch.randn(3, 3, cin, cout, generator=gen) * 0.05
    g = torch.randn(b, h, w, cout, generator=gen)
    return tuple(t.to(dev).contiguous() for t in (x, off, wt, g))


def concentrated_offsets(torch, b, h, w, window, clamp, seed, dev):
    """Offsets (B, H, W, 18) that pull every tap of a pixel to one point of
    the pixel's ``window`` x ``window`` block (0.4 px below and right of its
    middle pixel, with a 0.03 px jitter; ``window`` None: one point an
    image), clipped to +-``clamp`` unless it is None."""
    gen = torch.Generator().manual_seed(seed)
    win = window or max(h, w)
    ys = torch.arange(h, dtype=torch.float32)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32)[None, :].expand(h, w)
    point = torch.stack([((ys // win) * win + win // 2).clamp(max=h - 1),
                         ((xs // win) * win + win // 2).clamp(max=w - 1)],
                        -1) + 0.4
    k = torch.arange(9)
    tap = torch.stack([k // 3 - 1, k % 3 - 1], -1).float()
    off = point[:, :, None] - (torch.stack([ys, xs], -1)[:, :, None] + tap)
    off = off + 0.03 * torch.randn(b, h, w, 9, 2, generator=gen)
    if clamp is not None:
        off = off.clamp(-clamp, clamp)
    return off.reshape(b, h, w, 18).to(dev).contiguous()


def old_k1b(torch, fn):
    """(x, offsets, weight, g) -> (dx, doffsets, dweight) through ``fn``, a
    K1b entry with ``OLD_K1B_ARGTYPES`` (dx added by atomics), its scratch
    sized as the package sizes it."""
    from gencomm_tpu_torch.ops.deform_conv import (
        ROUTES, backward_scratch, kernel_route,
    )

    def run(x, off, wt, g):
        b, h, w, cin = x.shape
        cout = wt.shape[-1]
        route = kernel_route(cin, cout, backward=True)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        nsplit, nscratch = backward_scratch(route, b * h * w, cin, cout, sms)
        dx, doff, dw = (torch.empty_like(t) for t in (x, off, wt))
        scratch = torch.empty(nscratch, device=x.device)
        err = fn(x.data_ptr(), off.data_ptr(), wt.data_ptr(), g.data_ptr(),
                 dx.data_ptr(), doff.data_ptr(), dw.data_ptr(),
                 scratch.data_ptr(), b, h, w, cin, cout, nsplit, ROUTES[route],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the old K1b failed to launch: error {err}")
        return dx, doff, dw
    return run


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


def build(_cuda, csrc, tag, defines=(), sources=tuple(ENTRIES)):
    """Builds the ``sources`` of ``ENTRIES`` found in ``csrc`` into
    build/kernels_<tag> with the extra ``-D`` ``defines``; returns
    ({entry: ctypes function with the package's C interface},
    {source: nvcc's output}). A K1b that adds by atomics is bound with
    ``OLD_K1B_ARGTYPES`` under ``deform_conv_bwd_atomic`` instead."""
    out_dir = os.path.join(os.path.dirname(_cuda.BUILD_DIR), f"kernels_{tag}")
    os.makedirs(out_dir, exist_ok=True)
    fns, logs = {}, {}
    for src in sources:
        entries = ENTRIES[src]
        path = os.path.join(csrc, f"{src}.cu")
        if not os.path.exists(path):
            continue
        so = os.path.join(out_dir, f"lib{src}.so")
        done = subprocess.run(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *(f"-D{d}" for d in defines),
             "-o", so, path], check=True, capture_output=True, text=True)
        logs[src] = done.stdout + done.stderr
        lib = ctypes.CDLL(so)
        with open(path) as f:
            atomic = src == "deform_conv_bwd" and "atomicAdd" in f.read()
        for entry in entries:
            sym, argtypes = _cuda.SIGNATURES[entry][:2]
            if atomic:
                entry, argtypes = "deform_conv_bwd_atomic", OLD_K1B_ARGTYPES
            fn = getattr(lib, sym)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[entry] = fn
    return fns, logs


def through(_cuda, fns, call):
    """``call`` with the package's wrappers bound to ``fns`` while it
    runs."""
    def run(*args):
        saved = {name: _cuda.library(name) for name in fns}
        _cuda._loaded.update(fns)
        try:
            return call(*args)
        finally:
            _cuda._loaded.update(saved)
    return run


def split_by_launch(torch, fn, n=10):
    """Device ms per call of each kernel and memset that ``fn`` launches,
    and their sum under ``"all"``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {ev.key[:60]: ev.self_device_time_total / n / 1e3
           for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA
           and ev.self_device_time_total > 0}
    out["all"] = sum(out.values())
    return out


def turns(torch, runs, order, iters, flush):
    """{which_mode_ms: [ms per turn]} and {which_device_ms: ms} of the
    callables of ``runs``, taken in ``order``."""
    out = {}
    for mode, fl in (("warm", None), ("cold", flush)):
        for which in order:
            out.setdefault(f"{which}_{mode}_ms", []).append(
                time_ms(torch, runs[which], iters, flush=fl))
    for which in dict.fromkeys(order):
        out[f"{which}_device_ms"] = split_by_launch(torch, runs[which])
    return out


def bench_bf16(torch, dev, label, b, h, w, wrappers, old, parts, variants,
               iters, flush):
    fwd, plain = wrappers
    x, off, wt, _ = make_inputs(torch, b, h, w, 0, dev)
    x = x.to(torch.bfloat16)
    want = plain(x, off, wt).float()
    got, again = fwd(x, off, wt), fwd(x, off, wt)
    widened = fwd(x.float(), off, wt).to(torch.bfloat16)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = float((got.float() - want).abs().max())
    tol = 1e-4 * max(1.0, scale) + 2.0 ** -7 * scale
    differ, beyond = bf16_steps_apart(got, widened)
    row = {"x": [b, h, w, CIN], "dtype": "bf16", "max_abs_err": err,
           "tol": tol, "bit_equal_twice": bool(torch.equal(got, again)),
           "differ_from_fp32_kernel": differ, "outputs": got.numel(),
           "beyond_one_step_of_fp32_kernel": beyond}
    runs = {"new": lambda: fwd(x, off, wt)}
    order = ["new", "new"]
    if old:
        runs["old"] = lambda: old(x, off, wt)
        old_out = old(x, off, wt)
        row["old_differ_from_fp32_kernel"] = bf16_steps_apart(
            old_out, widened)[0]
        row["old_max_abs_err"] = float((old_out.float() - want).abs().max())
        order = ["old", "new", "new", "old"]
    for tag, fn in parts.items():
        runs[tag] = lambda fn=fn: fn(x, off, wt)
        order.insert(order.index("new") + 1, tag)
    ok = True
    for tag, fn in variants.items():
        runs[tag] = lambda fn=fn: fn(x, off, wt)
        order.insert(order.index("new") + 1, tag)
        out = fn(x, off, wt)
        differ, beyond = bf16_steps_apart(out, widened)
        row[f"{tag}_check"] = {
            "max_abs_err": float((out.float() - want).abs().max()),
            "bit_equal_twice": bool(torch.equal(out, fn(x, off, wt))),
            "differ_from_fp32_kernel": differ,
            "beyond_one_step_of_fp32_kernel": beyond}
        ok = ok and (row[f"{tag}_check"]["max_abs_err"] <= tol and beyond == 0
                     and row[f"{tag}_check"]["bit_equal_twice"])
    row.update(turns(torch, runs, order, iters, flush))
    row["bound_ms"] = max(2.0 * b * h * w * 9 * CIN * COUT / 989e12,
                          (x.numel() * 2 + off.numel() * 4 + wt.numel() * 4
                           + got.numel() * 2) / 3.35e12) * 1e3
    row["ok"] = bool(ok and err <= tol and row["bit_equal_twice"] and beyond == 0)
    print(label, json.dumps(row), flush=True)
    return row


def bench_concentrated(torch, dev, dims, window, clamp, old_bwd, wrappers,
                       iters=3):
    """K1b on ``concentrated_offsets``: the most records an input pixel
    receives, each gradient against the plain version (1e-3 x max|plain|)
    and the same bits twice, ms by events in turns (old, new, new, old with
    ``old_bwd``) and the device split by launch."""
    from gencomm_tpu_torch.ops.deform_conv import input_grad_records_plain

    bwd, plain = wrappers
    b, h, w, cin, cout = dims
    x, _, wt, g = make_inputs(torch, b, h, w, 2, dev, cin, cout)
    off = concentrated_offsets(torch, b, h, w, window, clamp, 3, dev)
    ids = input_grad_records_plain(off, wt, g)[2]
    ids = ids[ids >= 0].long()
    most = int(torch.bincount(ids, minlength=b * h * w).max())
    gots, again, wants = bwd(x, off, wt, g), bwd(x, off, wt, g), plain(x, off, wt, g)
    errs = {n: (float((a - c).abs().max()), float(c.abs().max()))
            for n, a, c in zip(("dx", "doff", "dweight"), gots, wants)}
    row = {"x": [b, h, w, cin], "cout": cout, "window": window, "clamp": clamp,
           "most_records_a_pixel": most, "k1b_err_scale": errs,
           "bit_equal_twice": {n: bool(torch.equal(a, c)) for n, a, c in zip(
               ("dx", "doff", "dweight"), gots, again)}}
    runs = {"new": lambda: bwd(x, off, wt, g)}
    order = ["new", "new"]
    if old_bwd:
        runs["old"] = lambda: old_bwd(x, off, wt, g)
        order = ["old", "new", "new", "old"]
    for which in order:
        row.setdefault(f"k1b_{which}_warm_ms", []).append(
            time_ms(torch, runs[which], iters, warmup=1))
    for which in runs:
        row[f"k1b_{which}_split_ms"] = split_by_launch(torch, runs[which], n=2)
    row["ok"] = bool(all(e <= 1e-3 * s for e, s in errs.values())
                     and all(row["bit_equal_twice"].values()))
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32")
    ap.add_argument("--parts", action="store_true")
    ap.add_argument("--old-csrc", default=None)
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--out", default=None)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_deform_torch: no CUDA device is available", file=sys.stderr)
        return 1
    from gencomm_tpu_torch.ops import _cuda
    from gencomm_tpu_torch.ops.deform_conv import (
        deform_conv3x3_bwd, deform_conv3x3_bwd_plain, deform_conv3x3_fwd,
        deform_conv3x3_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    _cuda.build_all(["deform_conv", "deform_conv_bwd", "splat_topk"])
    logs = {n: _cuda.build_log.get(n, "") for n in ENTRIES}
    old = parts = old_bwd = None
    if args.old_csrc:
        old, old_logs = build(_cuda, args.old_csrc, "old")
        logs.update({f"{n} (old)": t for n, t in old_logs.items()})
        if "deform_conv_bwd_atomic" in old:
            old_bwd = old_k1b(torch, old.pop("deform_conv_bwd_atomic"))
        elif "deform_conv_bwd" in old:
            old_bwd = through(_cuda, old, deform_conv3x3_bwd)
    if args.parts:
        parts = {}
        for tag, part in (("product", 1), ("gather", 2)):
            fns, part_logs = build(_cuda, _cuda.CSRC_DIR, tag, [f"K1_PART={part}"],
                                     ["deform_conv"])
            parts[tag] = fns
            logs[f"deform_conv ({tag} only)"] = part_logs["deform_conv"]
    variants = {}
    for spec in args.variant:
        tag, csrc = spec.split("=", 1)
        variants[tag], var_logs = build(_cuda, csrc, tag, (), ["deform_conv"])
        logs[f"deform_conv ({tag})"] = var_logs["deform_conv"]
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling", "arning")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
    flush = torch.zeros(L2_FLUSH_BYTES // 4, device=dev)
    result = {"card": smi, "dtype": args.dtype, "shapes": {}}
    checks = []

    # K1 fp32 keeps the old version's bits at its four shapes
    if old:
        old_fwd = through(_cuda, old, deform_conv3x3_fwd)
        same = {}
        for label, (b, h, w) in SHAPES.items():
            x, off, wt, _ = make_inputs(torch, b, h, w, 0, dev)
            same[label] = bool(torch.equal(deform_conv3x3_fwd(x, off, wt),
                                           old_fwd(x, off, wt)))
        result["k1_fp32_old_bits"] = same
        print("K1 fp32 gives the old version's bits:", json.dumps(same),
              flush=True)
        checks.append(all(same.values()))

    if args.dtype == "bf16":
        part_fwds = {tag: through(_cuda, fns, deform_conv3x3_fwd)
                     for tag, fns in (parts or {}).items()}
        var_fwds = {tag: through(_cuda, fns, deform_conv3x3_fwd)
                    for tag, fns in variants.items()}
        for label in BF16_SHAPES:
            row = bench_bf16(torch, dev, f"K1 bf16 {label}", *SHAPES[label],
                             (deform_conv3x3_fwd, deform_conv3x3_plain),
                             through(_cuda, old, deform_conv3x3_fwd) if old else None,
                             part_fwds, var_fwds, args.iters, flush)
            result["shapes"][label] = row
            checks.append(row["ok"])
    else:
        # the general route (ragged channel counts and maps) and offsets
        # beyond +-4 on both routes, against the plain versions
        for label, dims, clamp in (("general route", (2, 20, 36, 40, 70), 9.0),
                                   ("offsets to 9", (1, 24, 40, CIN, COUT), 9.0)):
            x, off, wt, g = make_inputs(torch, *dims[:3], 1, dev, *dims[3:], clamp)
            want = deform_conv3x3_plain(x, off, wt)
            err = float((deform_conv3x3_fwd(x, off, wt) - want).abs().max())
            errs = [float((a - c).abs().max() / c.abs().max()) for a, c in zip(
                deform_conv3x3_bwd(x, off, wt, g),
                deform_conv3x3_bwd_plain(x, off, wt, g))]
            ok = err <= 1e-4 * max(1.0, float(want.abs().max())) and max(errs) <= 1e-3
            result[label] = {"k1_err": err, "k1b_rel_err": errs, "ok": bool(ok)}
            print(label, json.dumps(result[label]), flush=True)
            checks.append(ok)
        for label, (b, h, w) in SHAPES.items():
            x, off, wt, g = make_inputs(torch, b, h, w, 0, dev)
            want = deform_conv3x3_plain(x, off, wt)
            got = deform_conv3x3_fwd(x, off, wt)
            k1_err = float((got - want).abs().max())
            k1_tol = 1e-4 * max(1.0, float(want.abs().max()))
            wants = deform_conv3x3_bwd_plain(x, off, wt, g)
            gots = deform_conv3x3_bwd(x, off, wt, g)
            again = deform_conv3x3_bwd(x, off, wt, g)
            k1b = {n: (float((a - c).abs().max()), float(c.abs().max()))
                   for n, a, c in zip(("dx", "doff", "dweight"), gots, wants)}
            row = {"x": [b, h, w, CIN], "k1_err": k1_err, "k1_tol": k1_tol,
                   "k1b_err_scale": k1b,
                   "bit_equal_twice": {n: bool(torch.equal(a, c)) for n, a, c
                                       in zip(("dx", "doff", "dweight"), gots,
                                              again)}}
            runs = {"k1_new": lambda: deform_conv3x3_fwd(x, off, wt),
                    "k1b_new": lambda: deform_conv3x3_bwd(x, off, wt, g)}
            orders = {"k1": ["new", "new"], "k1b": ["new", "new"]}
            if old:
                runs["k1_old"] = lambda: through(
                    _cuda, old, deform_conv3x3_fwd)(x, off, wt)
                orders["k1"] = ["old", "new", "new", "old"]
            if old_bwd:
                olds = [old_bwd(x, off, wt, g) for _ in range(2)]
                row["old_dx_err"] = float((olds[0][0] - wants[0]).abs().max())
                row["old_dx_bit_equal_twice"] = bool(torch.equal(olds[0][0],
                                                                 olds[1][0]))
                runs["k1b_old"] = lambda: old_bwd(x, off, wt, g)
                orders["k1b"] = ["old", "new", "new", "old"]
            for kern, order in orders.items():
                for mode, fl in (("warm", None), ("cold", flush)):
                    for which in order:
                        row.setdefault(f"{kern}_{which}_{mode}_ms", []).append(
                            time_ms(torch, runs[f"{kern}_{which}"], args.iters,
                                    flush=fl))
            for name in runs:
                row[f"{name}_split_ms"] = split_by_launch(torch, runs[name])
            ok = k1_err <= k1_tol and all(e <= 1e-3 * s for e, s in k1b.values())
            row["ok"] = bool(ok and all(row["bit_equal_twice"].values()))
            print(label, json.dumps(row), flush=True)
            result["shapes"][label] = row
            checks.append(row["ok"])
        for label, dims, window, clamp in CONCENTRATED:
            row = bench_concentrated(torch, dev, dims, window, clamp, old_bwd,
                                     (deform_conv3x3_bwd, deform_conv3x3_bwd_plain))
            print(f"K1b, {label}", json.dumps(row), flush=True)
            result.setdefault("concentrated", {})[label] = row
            checks.append(row["ok"])
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0 if all(checks) else 1


if __name__ == "__main__":
    sys.exit(main())
