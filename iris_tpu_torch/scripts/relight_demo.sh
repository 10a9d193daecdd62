#!/usr/bin/env bash
# Relight/disco record on the PyTorch/CUDA port (scripts/relight_demo.sh's
# variables and defaults): merged-scene path trace of the recovered BRDF
# with a YAML light ball + gold sphere + animated 20-spot disco ball.
set -euo pipefail
cd "$(dirname "$0")/../.."
EXP=${EXP:-tpu_n}
DATASET_PATH=${DATASET_PATH:-workdir_scene_m}
N_FRAMES=${N_FRAMES:-16}
python -m iris_tpu_torch.pipeline.render_relight \
  --dataset synthetic "$DATASET_PATH" --ldr_img_dir ldr \
  --experiment_name "$EXP/brdf1" --checkpoint_path ./checkpoints \
  --emitter_path "checkpoints/$EXP/bake" \
  --output_path "outputs/relight_$EXP" \
  --light_cfg scripts/relight/demo_ball.yaml \
  --mode traj --n_frames "$N_FRAMES" --SPP "${SPP:-32}" --spp "${spp:-8}" \
  --disco 1
