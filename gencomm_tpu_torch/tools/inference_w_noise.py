"""Pose-noise robustness sweep of a trained run.

Counterpart of ``gencomm_tpu/tools/inference_w_noise.py``:

    python -m gencomm_tpu_torch.tools.inference_w_noise --model_dir <run> \
        --dataset synthetic [--frames N] [--levels 0,0.2,0.4,0.6] \
        [--laplace] [--device cuda|cpu]

evaluates the run once a level, sigma_pos = sigma_rot = the level (m and
degrees; Laplace draws with ``--laplace``), through ``tools/inference.py``
on the same scenes (the noise has a stream of its own), and writes
``eval_noise_<level>[_laplace].yaml`` and its global-sort twin into the
run dir. Returns {level: the global-sort APs}.
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
    parser.add_argument("--laplace", action="store_true")
    parser.add_argument("--levels", default="0,0.2,0.4,0.6")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    results = {}
    for level in [float(x) for x in args.levels.split(",")]:
        sub = ["--model_dir", args.model_dir, "--dataset", args.dataset,
               "--frames", str(args.frames), "--pos_std", str(level),
               "--rot_std", str(level), "--device", args.device,
               "--infer_info",
               f"noise_{level}" + ("_laplace" if args.laplace else "")]
        if args.laplace:
            sub.append("--laplace")
        results[level] = inference.main(sub)
    print("noise sweep:", {k: round(v.get("ap50", 0.0), 4)
                           for k, v in results.items()})
    return results


if __name__ == "__main__":
    main()
