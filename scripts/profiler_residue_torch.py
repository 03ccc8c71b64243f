#!/usr/bin/env python3
"""Times host-bound PyTorch launches on one NVIDIA GPU before and after
torch.profiler sessions in the same process: does a finished profiler
session leave a cost on every later launch?

    python3 scripts/profiler_residue_torch.py [--ops 2000] [--sessions 5]

A "frame" is ``--ops`` small elementwise launches on a (2, 64, 128, 128)
fp32 map, about as many launches as one frame of the port's lidar eval path
(2,744) and as small, so its time is the host's launch cost. A reading is
the mean frame time by CUDA events over 10 frames after two warm-up
frames. A fresh process takes five readings, runs ``--sessions`` sessions
(each what ``chip_smoke.py``'s ``device_launches`` runs before the lidar
eval path is timed: a ``torch.profiler.profile`` with the CUDA activity
around 20 calls of a small function) and takes five readings again; the
median of each five is compared within the process, because the host's
speed varies more from process to process than within one. Four processes
run in turns, two with the environment as it is and two with
``TEARDOWN_CUPTI=1`` (which asks the profiler's CUPTI layer to tear down
when a session ends). One JSON object goes to standard output last.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


def readings(ops, sessions):
    """{"before": [ms], "after": [ms]} in this process."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(2, 64, 128, 128, device="cuda")

    def frame():
        for _ in range(ops):
            x.add_(1.0)

    def frame_ms(frames=10):
        for _ in range(2):
            frame()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(frames):
            frame()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / frames

    before = [frame_ms() for _ in range(5)]
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]):
            for _ in range(20):
                x.mul_(1.0)
            torch.cuda.synchronize()
    after = [frame_ms() for _ in range(5)]
    return {"before": before, "after": after}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ops", type=int, default=2000)
    ap.add_argument("--sessions", type=int, default=5)
    ap.add_argument("--child", action="store_true",
                    help="take the readings in this process (used by the "
                         "script itself)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profiler_residue_torch: no CUDA device is available")
    if args.child:
        print(json.dumps(readings(args.ops, args.sessions)), flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    result = {"card": smi, "ops": args.ops, "sessions": args.sessions,
              "runs": []}
    for label, extra in 2 * (("as_is", {}), ("teardown_cupti", {"TEARDOWN_CUPTI": "1"})):
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             "--ops", str(args.ops), "--sessions", str(args.sessions)],
            env={**os.environ, **extra}, check=True, capture_output=True,
            text=True)
        run = json.loads(done.stdout.strip().splitlines()[-1])
        before, after = (statistics.median(run[k]) for k in ("before", "after"))
        result["runs"].append({"env": label, **run, "median_before": before,
                               "median_after": after})
        print(f"{label}: median {before:.3f} ms a frame of {args.ops} launches "
              f"before {args.sessions} profiler sessions, {after:.3f} after "
              f"({after / before:.2f}x)", flush=True)
    print(smi, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
