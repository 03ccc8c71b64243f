#!/usr/bin/env python3
"""Times the port's deformable-conv kernels K1 (forward) and K1b (backward)
on one NVIDIA GPU, at the four shapes the port's paths give them.

    python3 scripts/bench_deform_torch.py [--old-csrc DIR] [--out FILE]

For each shape (lidar eval, lidar step, camera eval, camera step; fp32, NHWC,
128 -> 64 channels, offsets from a seed, clamped to +-4) it
  * holds K1 and K1b against their plain PyTorch versions;
  * times them with CUDA events, warm (back-to-back launches) and cold (a
    buffer larger than the L2 cache is written between launches);
  * splits K1b's time over its launches (memset and kernels, by name) with
    torch.profiler;
  * prints what ptxas reports for both sources (registers, shared memory).
With ``--old-csrc DIR`` (a directory that holds another version of
``deform_conv.cu`` and ``deform_conv_bwd.cu`` with the C interface of the
port's first version of these kernels, e.g. unpacked by ``git archive`` from
an earlier commit) that version is built beside the package's and the two
are timed in turns in this one process: old, new, new, old.
One JSON object goes to standard output last and, with ``--out``, to FILE.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = {"lidar eval": (2, 64, 128), "lidar step": (4, 64, 128),
          "camera eval": (2, 64, 64), "camera step": (4, 64, 64)}
CIN, COUT = 128, 64
L2_FLUSH_BYTES = 128 << 20


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


def build_old(torch, _cuda, csrc):
    """Builds DIR/deform_conv.cu and DIR/deform_conv_bwd.cu and returns
    (fwd(x, off, wt), bwd(x, off, wt, g)) on the old C interface."""
    out_dir = os.path.join(os.path.dirname(_cuda.BUILD_DIR), "kernels_old")
    os.makedirs(out_dir, exist_ok=True)
    P, I = ctypes.c_void_p, ctypes.c_int
    sigs = {"deform_conv": ("deform_conv3x3_f32", [P] * 4 + [I] * 5 + [P]),
            "deform_conv_bwd": ("deform_conv3x3_bwd_f32",
                                [P] * 8 + [I] * 6 + [P])}
    fns = {}
    for name, (sym, argtypes) in sigs.items():
        so = os.path.join(out_dir, f"lib{name}.so")
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", so,
                        os.path.join(csrc, f"{name}.cu")], check=True,
                       capture_output=True, text=True)
        fn = getattr(ctypes.CDLL(so), sym)
        fn.argtypes, fn.restype = argtypes, I
        fns[name] = fn

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def fwd(x, off, wt):
        b, h, w, cin = x.shape
        out = torch.empty(b, h, w, wt.shape[-1], device=x.device)
        err = fns["deform_conv"](x.data_ptr(), off.data_ptr(), wt.data_ptr(),
                                 out.data_ptr(), b, h, w, cin, wt.shape[-1],
                                 stream())
        assert err == 0, err
        return out

    def bwd(x, off, wt, g):
        b, h, w, cin = x.shape
        cout = wt.shape[-1]
        nsplit = max(1, min(64, -(-b * h * w // 2048)))
        dx, doff, dw = (torch.empty_like(t) for t in (x, off, wt))
        scratch = torch.empty(nsplit * 9 * cin * cout, device=x.device)
        err = fns["deform_conv_bwd"](
            x.data_ptr(), off.data_ptr(), wt.data_ptr(), g.data_ptr(),
            dx.data_ptr(), doff.data_ptr(), dw.data_ptr(), scratch.data_ptr(),
            b, h, w, cin, cout, nsplit, stream())
        assert err == 0, err
        return dx, doff, dw

    return fwd, bwd


def split_by_launch(torch, fn, n=10):
    """Device ms per launch of each kernel and memset that ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {ev.key[:60]: ev.self_device_time_total / max(ev.count, 1) / 1e3
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", default=None)
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
    for name in ("deform_conv", "deform_conv_bwd"):
        for line in _cuda.build_log.get(name, "").splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
    old = build_old(torch, _cuda, args.old_csrc) if args.old_csrc else None
    flush = torch.zeros(L2_FLUSH_BYTES // 4, device=dev)

    result = {"card": smi, "shapes": {}}
    # the general route (ragged channel counts and maps) and offsets beyond
    # +-4 on both routes, against the plain versions
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
            runs["k1_old"] = lambda: old[0](x, off, wt)
            runs["k1b_old"] = lambda: old[1](x, off, wt, g)
            order = ["old", "new", "new", "old"]
            row["k1_old_vs_new"] = float((old[0](x, off, wt) - got).abs().max())
        for kern in ("k1", "k1b"):
            for mode, fl in (("warm", None), ("cold", flush)):
                for which in order:
                    row.setdefault(f"{kern}_{which}_{mode}_ms", []).append(
                        time_ms(torch, runs[f"{kern}_{which}"], args.iters,
                                flush=fl))
        row["k1b_new_split_ms"] = split_by_launch(torch, runs["k1b_new"])
        row["k1_new_split_ms"] = split_by_launch(torch, runs["k1_new"])
        if old:
            row["k1b_old_split_ms"] = split_by_launch(torch, runs["k1b_old"])
        ok = k1_err <= k1_tol and all(e <= 1e-3 * s for e, s in k1b.values())
        row["ok"] = bool(ok and row["dweight_bit_equal"])
        print(label, json.dumps(row), flush=True)
        result["shapes"][label] = row
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    rows = [*result["shapes"].values(), result["general route"],
            result["offsets to 9"]]
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
