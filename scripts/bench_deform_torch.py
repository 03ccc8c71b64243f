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

``--old-csrc DIR`` (a directory that holds another version of
``deform_conv.cu``, ``deform_conv_bwd.cu`` and ``deform_common.cuh`` with
the package's C interface, e.g. ``git archive <commit>
gencomm_tpu_torch/csrc`` unpacked; PR 4's and later trees have it) builds
that version beside the package's and times the two in turns in this one
process: old, new, (parts,) new, old. It also confirms that K1 fp32 gives
the old version's bits at its four shapes.

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


def make_inputs(torch, b, h, w, seed, dev, cin=CIN, cout=COUT, clamp=4.0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, cin, generator=gen)
    off = (torch.randn(b, h, w, 18, generator=gen) * 1.5).clamp(-clamp, clamp)
    wt = torch.randn(3, 3, cin, cout, generator=gen) * 0.05
    g = torch.randn(b, h, w, cout, generator=gen)
    return tuple(t.to(dev).contiguous() for t in (x, off, wt, g))


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
    {source: nvcc's output})."""
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
        for entry in entries:
            sym, argtypes = _cuda.SIGNATURES[entry][:2]
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
    _cuda.build_all(["deform_conv", "deform_conv_bwd"])
    logs = {n: _cuda.build_log.get(n, "") for n in ENTRIES}
    old = parts = None
    if args.old_csrc:
        old, old_logs = build(_cuda, args.old_csrc, "old")
        logs.update({f"{n} (old)": t for n, t in old_logs.items()})
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
                   "dweight_bit_equal": bool(torch.equal(gots[2], again[2])),
                   "doff_bit_equal": bool(torch.equal(gots[1], again[1]))}
            runs = {"k1_new": lambda: deform_conv3x3_fwd(x, off, wt),
                    "k1b_new": lambda: deform_conv3x3_bwd(x, off, wt, g)}
            order = ["new", "new"]
            if old:
                runs["k1_old"] = lambda: through(
                    _cuda, old, deform_conv3x3_fwd)(x, off, wt)
                runs["k1b_old"] = lambda: through(
                    _cuda, old, deform_conv3x3_bwd)(x, off, wt, g)
                order = ["old", "new", "new", "old"]
            for kern in ("k1", "k1b"):
                for mode, fl in (("warm", None), ("cold", flush)):
                    for which in order:
                        row.setdefault(f"{kern}_{which}_{mode}_ms", []).append(
                            time_ms(torch, runs[f"{kern}_{which}"], args.iters,
                                    flush=fl))
            for name in runs:
                row[f"{name}_split_ms"] = split_by_launch(torch, runs[name])
            ok = k1_err <= k1_tol and all(e <= 1e-3 * s for e, s in k1b.values())
            row["ok"] = bool(ok and row["dweight_bit_equal"])
            print(label, json.dumps(row), flush=True)
            result["shapes"][label] = row
            checks.append(row["ok"])
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0 if all(checks) else 1


if __name__ == "__main__":
    sys.exit(main())
