#!/usr/bin/env python3
"""chip_smoke.py's phase 15 and its p6 check alone, on one CUDA card.

    python3 scripts/baselines_chip_torch.py [a] [p6] [b]

``a``: the four baselines (``chip_smoke.baselines``: eval looped and
streamed, training with each freeze, card against CPU); ``p6``: SECOND's
timed cell and ``chip_smoke.hold_repeat_step``; ``b``: the baselines'
workflow through the tools (``chip_smoke.py --baseline-workflow
build/bw``). With no argument, all three. Builds the kernels first; exits
non-zero without a card.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gencomm_tpu_torch.ops import _cuda  # noqa: E402


def main(argv):
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    cs.log(f"card: {smi}; torch {torch.__version__} CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    cs.log(f"built in {_cuda.build_all():.1f} s")
    what = argv or ["a", "p6", "b"]
    if "a" in what:
        cs.baselines(smi, dev)
    if "p6" in what:
        sec = cs.second_timed(smi, dev)
        cs.log(f"p6: {cs.hold_repeat_step(sec.train)}")
        del sec
        torch.cuda.empty_cache()
    if "b" in what:
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--baseline-workflow", os.path.join(ROOT, "build", "bw")],
            capture_output=True, text=True, timeout=900)
        for line in proc.stdout.splitlines():
            cs.log(f"  | {line}")
        if proc.returncode:
            print(proc.stderr[-6000:], file=sys.stderr)
            return proc.returncode
    cs.log(f"done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
