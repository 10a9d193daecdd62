#!/usr/bin/env bash
# Evaluation render + metrics on the PyTorch/CUDA port (scripts/render.sh's
# variables and defaults; parity: reference scripts/*/render.sh).
set -euo pipefail

DATASET=${DATASET:-synthetic}
DATASET_PATH=${DATASET_PATH:?set DATASET_PATH}
SCENE=${SCENE:-$DATASET_PATH}
EXP=${EXP:?set EXP}
LDR_IMG_DIR=${LDR_IMG_DIR:-}
SPLIT=${SPLIT:-val}
SPP=${SPP:-256}
spp=${spp:-16}
CRF_BASIS=${CRF_BASIS:-3}
MAX_FRAMES=${MAX_FRAMES:-0}
LDR_ARG=${LDR_IMG_DIR:+--ldr_img_dir $LDR_IMG_DIR}

python -m iris_tpu_torch.pipeline.render \
    --dataset $DATASET $DATASET_PATH --scene $SCENE $LDR_ARG \
    --experiment_name $EXP/brdf1 \
    --emitter_path checkpoints/$EXP/bake \
    --output_path outputs/$EXP/render --split $SPLIT \
    --SPP $SPP --spp $spp --crf_basis $CRF_BASIS --max_frames $MAX_FRAMES
