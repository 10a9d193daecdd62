#!/usr/bin/env bash
# fipt_syn_kitchen: reference scripts/fipt/kitchen/train.sh budgets, mapped onto the
# PyTorch/CUDA port's stage CLIs (iris_tpu_torch/scripts/run_pipeline.sh).
# Usage: DATASET_ROOT=/data/... iris_tpu_torch/scripts/scenes/fipt_syn_kitchen.sh
set -euo pipefail
cd "$(dirname "$0")/../../.."
export DATASET=synthetic SCENE=kitchen EXP=fipt_syn_kitchen LDR_IMG_DIR=Image
export DATASET_PATH=${DATASET_ROOT:?set DATASET_ROOT}
export HAS_PART=1 CRF_BASIS=3 RES_SCALE=1.0 VAL_FRAME=10
export SPP=128 spp=32 L_CRF_WEIGHT=0.001
export EPOCHS_INIT=3 EPOCHS_BRDF=2 EPOCHS_EMITTER=1
exec iris_tpu_torch/scripts/run_pipeline.sh
