#!/usr/bin/env bash
# fipt_real_conferenceroom: reference scripts/fipt/conferenceroom/train.sh budgets, mapped onto the
# PyTorch/CUDA port's stage CLIs (iris_tpu_torch/scripts/run_pipeline.sh).
# Usage: DATASET_ROOT=/data/... iris_tpu_torch/scripts/scenes/fipt_real_conferenceroom.sh
set -euo pipefail
cd "$(dirname "$0")/../../.."
export DATASET=real SCENE=conferenceroom EXP=fipt_real_conferenceroom LDR_IMG_DIR=Image
export DATASET_PATH=${DATASET_ROOT:?set DATASET_ROOT}
export HAS_PART=0 CRF_BASIS=3 RES_SCALE=1.0 VAL_FRAME=0
export SPP=128 spp=32 L_CRF_WEIGHT=0.001
export EPOCHS_INIT=3 EPOCHS_BRDF=2 EPOCHS_EMITTER=1
exec iris_tpu_torch/scripts/run_pipeline.sh
