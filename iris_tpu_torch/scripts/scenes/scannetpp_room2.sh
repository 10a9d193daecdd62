#!/usr/bin/env bash
# scannetpp_room2: reference scripts/scannetpp/room2/train.sh budgets, mapped onto the
# PyTorch/CUDA port's stage CLIs (iris_tpu_torch/scripts/run_pipeline.sh).
# Usage: DATASET_ROOT=/data/... iris_tpu_torch/scripts/scenes/scannetpp_room2.sh
set -euo pipefail
cd "$(dirname "$0")/../../.."
export DATASET=scannetpp SCENE=7e09430da7 EXP=scannetpp_room2 LDR_IMG_DIR=Image
export DATASET_PATH=${DATASET_ROOT:?set DATASET_ROOT}
export HAS_PART=0 CRF_BASIS=3 RES_SCALE=0.5 VAL_FRAME=3
export SPP=128 spp=32 L_CRF_WEIGHT=0.001
export EPOCHS_INIT=5 EPOCHS_BRDF=2 EPOCHS_EMITTER=1
exec iris_tpu_torch/scripts/run_pipeline.sh
