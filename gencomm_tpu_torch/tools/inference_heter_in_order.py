"""Agents join in order: the same run evaluated with 1, 2, ... collaborators
(ego only first), the AP-against-agent-count curve.

Counterpart of ``gencomm_tpu/tools/inference_heter_in_order.py`` over the
port's ``inference.main``:

    python -m gencomm_tpu_torch.tools.inference_heter_in_order \
        --model_dir <run> --dataset opv2v|v2xset|v2xreal|synthetic [--frames N] \
        [--max_cav K] \
        [--device cuda|cpu]

Each count k writes ``eval_in_order_<k>cav.yaml`` and
``eval_global_sort_in_order_<k>cav.yaml`` into the run dir.
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
    parser.add_argument("--max_cav", type=int, default=5)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    results = {}
    for k in range(1, args.max_cav + 1):
        results[k] = inference.main([
            "--model_dir", args.model_dir,
            "--dataset", args.dataset,
            "--frames", str(args.frames),
            "--use_cav", str(k),
            "--infer_info", f"in_order_{k}cav",
            "--device", args.device,
        ])
    print("agents -> result keys:", sorted(results))
    return results


if __name__ == "__main__":
    main()
