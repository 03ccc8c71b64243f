#!/usr/bin/env bash
# HEAL pipeline on the PyTorch port (the port's copy of
# scripts/heal_pipeline.sh):
#
#   stage 1  train the collaboration base with pyramid fusion and the
#            occupancy heads (heter_pyramid_collab, m1).
#   stage 2  back-align the new agent type: heter_pyramid_single with the
#            base's pyramid and detection heads restored (--init_from) and
#            frozen, so that only the new encoder, backbone and aligner
#            learn.
#   stage 3  merge the checkpoints (heal_tools merge) and run the joint
#            inference with the final_infer collab config.
#
#   DATASET=synthetic DEVICE=cuda EPOCHS=2 STEPS=100 \
#       scripts/heal_pipeline_torch.sh
# DEVICE=cpu runs it without a card.
set -euo pipefail
cd "$(dirname "$0")/.."

DATASET="${DATASET:-synthetic}"
DEVICE="${DEVICE:-cuda}"
EPOCHS="${EPOCHS:-2}"
STEPS="${STEPS:-100}"
OUT="${OUT:-logs/heal_pipeline_torch}"

run() { echo "+ $*"; "$@"; }

# ---- stage 1: collaboration base (m1, pyramid fusion + occupancy heads) --
run python -m gencomm_tpu_torch.tools.train \
    -y configs/opv2v/heal/stage1/m1_pyramid.yaml \
    --model_dir "$OUT/base_m1" --dataset "$DATASET" --device "$DEVICE" \
    --epochs "$EPOCHS" --steps_per_epoch "$STEPS"

# ---- stage 2: back-align the new type (m2) to the frozen base ------------
run python -m gencomm_tpu_torch.tools.train \
    -y configs/opv2v/heal/stage2/m2_single_pyramid.yaml \
    --model_dir "$OUT/single_m2" --dataset "$DATASET" --device "$DEVICE" \
    --init_from "$OUT/base_m1" \
    --epochs "$EPOCHS" --steps_per_epoch "$STEPS"

# ---- stage 3: assemble the multi-type checkpoint and jointly infer -------
run python -m gencomm_tpu_torch.tools.heal_tools --device "$DEVICE" merge \
    --new_ckpt "$OUT/single_m2" --base_ckpt "$OUT/base_m1" \
    --out "$OUT/final_m1m2"
cp configs/opv2v/heal/final_infer/m1m2.yaml "$OUT/final_m1m2/config.yaml"

run python -m gencomm_tpu_torch.tools.inference \
    --model_dir "$OUT/final_m1m2" --dataset "$DATASET" --device "$DEVICE"
run python -m gencomm_tpu_torch.tools.inference_heter_in_order \
    --model_dir "$OUT/final_m1m2" --dataset "$DATASET" --device "$DEVICE" \
    --max_cav 3
