#!/usr/bin/env bash
# fipt_real_classroom: reference scripts/fipt/classroom/train.sh budgets, mapped onto the
# PyTorch/CUDA port's stage CLIs (iris_tpu_torch/scripts/run_pipeline.sh).
# Usage: DATASET_ROOT=/data/... iris_tpu_torch/scripts/scenes/fipt_real_classroom.sh
set -euo pipefail
cd "$(dirname "$0")/../../.."
export DATASET=real SCENE=classroom EXP=fipt_real_classroom LDR_IMG_DIR=Image
export DATASET_PATH=${DATASET_ROOT:?set DATASET_ROOT}
export HAS_PART=0 CRF_BASIS=3 RES_SCALE=1.0 VAL_FRAME=1
export SPP=128 spp=32 L_CRF_WEIGHT=0.01
export EPOCHS_INIT=3 EPOCHS_BRDF=2 EPOCHS_EMITTER=1
exec iris_tpu_torch/scripts/run_pipeline.sh
