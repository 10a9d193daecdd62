#!/usr/bin/env bash
# Full 9-stage IRIS pipeline on the PyTorch/CUDA port (iris_tpu_torch),
# parameterized per scene: scripts/run_pipeline.sh's stages, variables and
# defaults, each stage a CLI of iris_tpu_torch.pipeline (on the card; the
# checkpoints are the port's own, see iris_tpu_torch/convert.py to carry
# a JAX state across). The reference's per-scene train.sh stage chain
# (scripts/scannetpp/bathroom2/train.sh).
#
# Usage: DATASET=synthetic DATASET_PATH=/data/kitchen EXP=kitchen \
#        iris_tpu_torch/scripts/run_pipeline.sh
set -euo pipefail

DATASET=${DATASET:-synthetic}            # synthetic | real | scannetpp
DATASET_PATH=${DATASET_PATH:?set DATASET_PATH}
DATASET_ROOT=${DATASET_ROOT:-$DATASET_PATH}
SCENE=${SCENE:-$DATASET_PATH}            # scene id for scannetpp
EXP=${EXP:?set EXP}
LDR_IMG_DIR=${LDR_IMG_DIR:-}
HAS_PART=${HAS_PART:-1}
CRF_BASIS=${CRF_BASIS:-3}
RES_SCALE=${RES_SCALE:-1.0}
SPP=${SPP:-128}
spp=${spp:-32}
STEPS_INIT=${STEPS_INIT:-2000}
STEPS_BRDF=${STEPS_BRDF:-4000}
STEPS_EMITTER=${STEPS_EMITTER:-1000}
# reference per-scene scripts budget in EPOCHS (train.sh --max_epochs);
# when set they override the step budgets above
EPOCHS_INIT=${EPOCHS_INIT:-0}
EPOCHS_BRDF=${EPOCHS_BRDF:-0}
EPOCHS_EMITTER=${EPOCHS_EMITTER:-0}
VAL_FRAME=${VAL_FRAME:-0}
L_CRF_WEIGHT=${L_CRF_WEIGHT:-0.001}
# model/batch knobs (shrink for smoke tests). Grid default = the round-4
# production parameterization: 8 levels x 8 features row-gather grid, the
# same parameter count / MLP width as the reference 32x2 at 1.73x step
# throughput (pipeline/config.py, PERF.md round-3f + round-4 scale
# receipt). Reference parity: HASH_LEVELS=32 HASH_FEATURES=2.
BATCH_SIZE=${BATCH_SIZE:-8192}
HASH_LEVELS=${HASH_LEVELS:-4}
HASH_FEATURES=${HASH_FEATURES:-16}
LOG2_HASH=${LOG2_HASH:-19}
VOXEL_NUM=${VOXEL_NUM:-256}
TRAIN_COMMON="--batch_size $BATCH_SIZE --hash_levels $HASH_LEVELS --hash_features $HASH_FEATURES --log2_hashmap_size $LOG2_HASH"
INIT_BUDGET="--max_steps $STEPS_INIT"
[ "$EPOCHS_INIT" -gt 0 ] && INIT_BUDGET="--max_epochs $EPOCHS_INIT"
BRDF_BUDGET="--max_steps $STEPS_BRDF"
[ "$EPOCHS_BRDF" -gt 0 ] && BRDF_BUDGET="--max_epochs $EPOCHS_BRDF"
EMITTER_BUDGET="--max_steps $STEPS_EMITTER"
[ "$EPOCHS_EMITTER" -gt 0 ] && EMITTER_BUDGET="--max_epochs $EPOCHS_EMITTER"
SPP_BAKE_DIFFUSE=${SPP_BAKE_DIFFUSE:-256}
SPP_REFINE_DIFFUSE=${SPP_REFINE_DIFFUSE:-128}
SPP_REFINE_SPECULAR=${SPP_REFINE_SPECULAR:-64}
INDIR_DEPTH=${INDIR_DEPTH:-5}
# emitter-radiance optimizer knobs (pipeline/config.py): log-space
# multiplicative steps + lr scale close large radiance scale gaps in few
# steps (PERF.md round-2g). Defaults = reference parity (additive, 1x).
RADIANCE_LOG_SPACE=${RADIANCE_LOG_SPACE:-0}
RADIANCE_LR_SCALE=${RADIANCE_LR_SCALE:-1.0}
RAD_ARGS="--radiance_log_space $RADIANCE_LOG_SPACE --radiance_lr_scale $RADIANCE_LR_SCALE"
# hash-grid encode estimator for the refine_shading bake: stoch (1-corner
# unbiased; device A/B round-2h: 2.4x faster, deviation 10-100x below the
# MC noise floor) or exact (8-corner reference semantics)
ENCODE_REFINE=${ENCODE_REFINE:-stoch}
# resume support: skip stages below START_STAGE (1=slf_bake 2=extract
# 3=initialize 4=emitter-update 5=bake_shading 6=brdf0 7=slf_refine
# 8=train_emitter 9=refine_shading+brdf1). Stage artifacts are all on
# disk, so a crashed run resumes from the failed stage (reference
# train.sh's per-stage invocations are restartable the same way).
START_STAGE=${START_STAGE:-1}
stage() { [ "$START_STAGE" -le "$1" ]; }

CKPT=checkpoints/$EXP
BAKE=$CKPT/bake
OUT=outputs/$EXP
LDR_ARG=${LDR_IMG_DIR:+--ldr_img_dir $LDR_IMG_DIR}

COMMON_DS="--dataset_root $DATASET_ROOT --scene $SCENE --dataset $DATASET --res_scale $RES_SCALE $LDR_ARG"
TRAIN_DS="--dataset $DATASET $DATASET_PATH --scene $SCENE --res_scale $RES_SCALE $LDR_ARG"

if stage 1; then
  # 1. bake surface light field
  python -m iris_tpu_torch.pipeline.slf_bake $COMMON_DS --output $BAKE --voxel_num $VOXEL_NUM
fi

if stage 2; then
  # 2. extract emitter mask
  python -m iris_tpu_torch.pipeline.extract_emitter $COMMON_DS --output $BAKE \
      --threshold 0.99
fi

if stage 3; then
  # 3. joint BRDF + emitter initialization
  python -m iris_tpu_torch.pipeline.initialize --experiment_name $EXP/init \
      $TRAIN_DS --voxel_path $BAKE/vslf.npz --emitter_path $BAKE/emitter.npz \
      --has_part $HAS_PART --SPP $SPP --spp $spp --crf_basis $CRF_BASIS \
      --val_frame $VAL_FRAME $INIT_BUDGET $TRAIN_COMMON $RAD_ARGS
fi

if stage 4; then
  # 4. write learned emitter radiance into emitter.npz
  python -m iris_tpu_torch.pipeline.extract_emitter $COMMON_DS --output $BAKE \
      --mode update --ckpt checkpoints/$EXP/init/last.pkl
fi

if stage 5; then
  # 5. bake shading caches
  python -m iris_tpu_torch.pipeline.bake_shading $COMMON_DS \
      --slf_path $BAKE/vslf.npz --emitter_path $BAKE/emitter.npz \
      --output $OUT/shading --spp_diffuse $SPP_BAKE_DIFFUSE
fi

if stage 6; then
  # 6. optimize BRDF + CRF against the caches
  python -m iris_tpu_torch.pipeline.train_brdf_crf --experiment_name $EXP/brdf0 \
      $TRAIN_DS --has_part $HAS_PART --crf_basis $CRF_BASIS \
      --ckpt_path checkpoints/$EXP/init/last.pkl \
      --voxel_path $BAKE/vslf.npz --emitter_path $BAKE/emitter.npz \
      --cache_dir $OUT/shading --lp 0.005 --la 0.01 --l_crf_weight $L_CRF_WEIGHT \
      --val_frame $VAL_FRAME $BRDF_BUDGET $TRAIN_COMMON
fi

if stage 7; then
  # 7. re-bake the SLF with the learned CRF
  python -m iris_tpu_torch.pipeline.slf_refine $COMMON_DS --output $BAKE \
      --load vslf.npz --save vslf_0.npz \
      --ckpt checkpoints/$EXP/brdf0/last.pkl --crf_basis $CRF_BASIS
fi

if stage 8; then
  # 8. refine emitter radiance
  python -m iris_tpu_torch.pipeline.train_emitter --experiment_name $EXP/emitter \
      $TRAIN_DS --crf_basis $CRF_BASIS --SPP $SPP --spp $spp \
      --ckpt_path checkpoints/$EXP/brdf0/last.pkl \
      --voxel_path $BAKE/vslf_0.npz --emitter_path $BAKE/emitter.npz \
      $EMITTER_BUDGET --batch_size $BATCH_SIZE $RAD_ARGS
  python -m iris_tpu_torch.pipeline.extract_emitter $COMMON_DS --output $BAKE \
      --mode update --ckpt checkpoints/$EXP/emitter/emitter_last.pkl
fi

if stage 9; then
  # 9. refine shadings with the learned BRDF + final BRDF/CRF pass
  python -m iris_tpu_torch.pipeline.refine_shading $COMMON_DS \
      --slf_path $BAKE/vslf_0.npz --emitter_path $BAKE/emitter.npz \
      --ckpt checkpoints/$EXP/brdf0/last.pkl --output $OUT/shading_1 \
      --spp_diffuse $SPP_REFINE_DIFFUSE --spp_specular $SPP_REFINE_SPECULAR \
      --indir_depth $INDIR_DEPTH --encode $ENCODE_REFINE
fi

python -m iris_tpu_torch.pipeline.train_brdf_crf --experiment_name $EXP/brdf1 \
    $TRAIN_DS --has_part $HAS_PART --crf_basis $CRF_BASIS \
    --ckpt_path checkpoints/$EXP/init/last.pkl \
    --voxel_path $BAKE/vslf_0.npz --emitter_path $BAKE/emitter.npz \
    --cache_dir $OUT/shading_1 --lp 0.005 --la 0.01 --l_crf_weight $L_CRF_WEIGHT \
    --val_frame $VAL_FRAME $BRDF_BUDGET $TRAIN_COMMON

echo "pipeline complete: checkpoints/$EXP/brdf1/last.pkl"
