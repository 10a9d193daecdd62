#!/usr/bin/env bash
# Production-scale hermetic record on the PyTorch/CUDA port
# (scripts/run_scale_demo.sh's stages with iris_tpu_torch's CLIs, on the
# card): generate a large procedural scene and run the full 9-stage
# pipeline + eval render + BRDF/CRF metrics on it. Defaults give ~8.4K
# faces (the paired walk, trace_paired), 256x192 x 16 train frames;
# N_CLUTTER=2000 (~24K faces) takes the same kernel. The dataset and the
# experiment are named apart from the JAX record's, whose generator draws
# other samples.
set -euo pipefail
cd "$(dirname "$0")/../.."

ROOT=${ROOT:-workdir_scene_l_torch}
EXP=${EXP:-torch_l}
HW=${HW:-"192 256"}
N_TRAIN=${N_TRAIN:-16}
N_CLUTTER=${N_CLUTTER:-700}
GEN_SPP=${GEN_SPP:-64}
# metallic low-roughness blob: makes roughness/metallic recovery scoreable
# on this record (the all-dielectric scene saturates roughness, PERF 2i/3c)
METALLIC_AMP=${METALLIC_AMP:-0.8}
# eval subset: render/score only the first N train frames (0 = all) —
# decomposition metrics converge well before the full frame set and the
# render stage is ~45 min / 16 frames on the chip
RENDER_FRAMES=${RENDER_FRAMES:-0}

echo "SCALE config: HW=$HW N_TRAIN=$N_TRAIN N_CLUTTER=$N_CLUTTER \
GEN_SPP=$GEN_SPP METALLIC_AMP=$METALLIC_AMP RENDER_FRAMES=$RENDER_FRAMES"
# SKIP_GEN=1 reuses an existing $ROOT dataset; START_STAGE (run_pipeline.
# sh) resumes the stage chain — together they restart a crashed record
# without redoing finished work (the generator is seeded, so a kept
# dataset is bit-identical to what a rerun would produce).
if [ "${SKIP_GEN:-0}" != "1" ]; then
  echo "SCALE gen start $(date +%H:%M:%S)"
  python -m iris_tpu_torch.data.make_demo_dataset "$ROOT" --hw $HW \
    --n_train "$N_TRAIN" --n_val 2 --spp "$GEN_SPP" --indir_depth 2 \
    --n_clutter "$N_CLUTTER" --seed 3 --metallic_amp "$METALLIC_AMP"
  echo "SCALE gen done $(date +%H:%M:%S)"
else
  echo "SCALE gen skipped (SKIP_GEN=1, reusing $ROOT)"
fi

export DATASET=synthetic DATASET_PATH=$ROOT EXP=$EXP LDR_IMG_DIR=ldr
export STEPS_INIT=${STEPS_INIT:-2000} STEPS_BRDF=${STEPS_BRDF:-4000} \
       STEPS_EMITTER=${STEPS_EMITTER:-600}
export RADIANCE_LOG_SPACE=${RADIANCE_LOG_SPACE:-1} \
       RADIANCE_LR_SCALE=${RADIANCE_LR_SCALE:-10}
export VOXEL_NUM=${VOXEL_NUM:-256} SPP=${SPP:-32} \
       SPP_BAKE_DIFFUSE=${SPP_BAKE_DIFFUSE:-64} \
       SPP_REFINE_DIFFUSE=${SPP_REFINE_DIFFUSE:-64} \
       SPP_REFINE_SPECULAR=${SPP_REFINE_SPECULAR:-32} \
       INDIR_DEPTH=${INDIR_DEPTH:-3}
bash iris_tpu_torch/scripts/run_pipeline.sh
echo "SCALE trained $(date +%H:%M:%S)"

SPLIT=train SPP=64 spp=16 MAX_FRAMES=$RENDER_FRAMES bash iris_tpu_torch/scripts/render.sh
echo "SCALE rendered $(date +%H:%M:%S)"
python -m iris_tpu_torch.utils.metric_brdf --gt "$ROOT/train" \
  --method "outputs/$EXP/render/train" --max_frames "$RENDER_FRAMES"
python -m iris_tpu_torch.utils.metric_crf --crf_gt "$ROOT/train/ldr/cam/crf.npy" \
  --ckpt "checkpoints/$EXP/brdf1/last.pkl"
echo SCALE_DONE
