#!/usr/bin/env bash
# Robustness sweeps on a trained run dir with the PyTorch port (the port's
# copy of scripts/robustness_sweeps.sh, without its figure step): AP against
# pose noise (Gaussian, then Laplace) and AP against communication delay,
# each level written as eval_noise_<level>[_laplace].yaml /
# eval_delay_<ms>ms.yaml into the run dir.
#   scripts/robustness_sweeps_torch.sh <model_dir> [dataset]
# DEVICE=cpu runs it without a card; FRAMES sets the frames a level (50).
set -euo pipefail
cd "$(dirname "$0")/.."

MODEL_DIR="${1:?usage: robustness_sweeps_torch.sh <model_dir> [dataset]}"
DATASET="${2:-${DATASET:-synthetic}}"
DEVICE="${DEVICE:-cuda}"
FRAMES="${FRAMES:-50}"

run() { echo "+ $*"; "$@"; }

run python -m gencomm_tpu_torch.tools.inference_w_noise \
    --model_dir "$MODEL_DIR" --dataset "$DATASET" --device "$DEVICE" \
    --frames "$FRAMES" --levels 0,0.2,0.4,0.6
run python -m gencomm_tpu_torch.tools.inference_w_noise \
    --model_dir "$MODEL_DIR" --dataset "$DATASET" --device "$DEVICE" \
    --frames "$FRAMES" --levels 0,0.2,0.4,0.6 --laplace
run python -m gencomm_tpu_torch.tools.inference_w_delay \
    --model_dir "$MODEL_DIR" --dataset "$DATASET" --device "$DEVICE" \
    --frames "$FRAMES"
