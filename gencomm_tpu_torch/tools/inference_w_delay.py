"""Communication-delay robustness sweep of a trained run.

Counterpart of ``gencomm_tpu/tools/inference_w_delay.py``:

    python -m gencomm_tpu_torch.tools.inference_w_delay --model_dir <run> \
        --dataset synthetic [--frames N] [--delays 0,100,200,300,400,500] \
        [--device cuda|cpu]

evaluates the run once a delay (ms: the non-ego agents observe the
vehicles that much stale, the GT stays current) through
``tools/inference.py`` and writes ``eval_delay_<ms>ms.yaml`` and its
global-sort twin into the run dir. Returns {delay: the global-sort APs}.
"""

from __future__ import annotations

import argparse

from gencomm_tpu_torch.tools import inference
from gencomm_tpu_torch.tools.train import DATASETS


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--dataset", default="opv2v", choices=DATASETS)
    parser.add_argument("--frames", type=int, default=50)
    parser.add_argument("--delays", default="0,100,200,300,400,500")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    results = {}
    for delay in [int(x) for x in args.delays.split(",")]:
        results[delay] = inference.main([
            "--model_dir", args.model_dir, "--dataset", args.dataset,
            "--frames", str(args.frames), "--delay", str(delay),
            "--device", args.device, "--infer_info", f"delay_{delay}ms"])
    print("delay sweep keys:", sorted(results))
    return results


if __name__ == "__main__":
    main()
