#!/usr/bin/env bash
# GenComm two-stage heterogeneous training protocol on the PyTorch port
# (the port's copy of scripts/gencomm_two_stage.sh): stage 1 trains each
# agent type homogeneously with its message extractor and diffusion
# generator; the new agent's checkpoint is merged into the collaboration
# base; stage 2 trains ONLY the new agent's message extractor; then the
# static and the agents-in-order evaluations.
#   DATASET=synthetic DEVICE=cuda EPOCHS=2 STEPS=100 \
#       scripts/gencomm_two_stage_torch.sh
# DEVICE=cpu runs it without a card.
set -euo pipefail
cd "$(dirname "$0")/.."

DATASET="${DATASET:-synthetic}"
DEVICE="${DEVICE:-cuda}"
EPOCHS="${EPOCHS:-2}"
STEPS="${STEPS:-100}"
OUT="${OUT:-logs/gencomm_two_stage_torch}"

run() { echo "+ $*"; "$@"; }

# ---- stage 1: homogeneous, one run per agent type ------------------------
for M in m1 m2; do
  run python -m gencomm_tpu_torch.tools.train \
      -y "configs/opv2v/gencomm/stage1/${M}_att.yaml" \
      --model_dir "$OUT/stage1_${M}" --dataset "$DATASET" --device "$DEVICE" \
      --epochs "$EPOCHS" --steps_per_epoch "$STEPS"
done

# ---- checkpoint surgery: merge new agent (m2) into collab base (m1) ------
run python -m gencomm_tpu_torch.tools.heal_tools --device "$DEVICE" merge \
    --new_ckpt "$OUT/stage1_m2" --base_ckpt "$OUT/stage1_m1" \
    --out "$OUT/stage2_m1m2/merged"

# ---- stage 2: train only the new agent's message extractor ---------------
run python -m gencomm_tpu_torch.tools.train \
    -y "configs/opv2v/gencomm/stage2/m1m2_att.yaml" \
    --model_dir "$OUT/stage2_m1m2" --dataset "$DATASET" --device "$DEVICE" \
    --init_from "$OUT/stage2_m1m2/merged" \
    --epochs "$EPOCHS" --steps_per_epoch "$STEPS"

# ---- evaluation ----------------------------------------------------------
run python -m gencomm_tpu_torch.tools.inference \
    --model_dir "$OUT/stage2_m1m2" --dataset "$DATASET" --device "$DEVICE" \
    --report_comm
run python -m gencomm_tpu_torch.tools.inference_heter_in_order \
    --model_dir "$OUT/stage2_m1m2" --dataset "$DATASET" --device "$DEVICE"
