"""Shared CLI option schema (counterpart of iris_tpu/pipeline/config.py,
the same options and defaults; parity: reference configs/config.py:7-159).
The comments on each option's measurements speak of the JAX package's TPU
runs (its PERF.md history and records/), not of this port.

Every stage app builds its parser from this dict plus program-level flags,
exactly like the reference's add_model_specific_args pattern.
"""

from __future__ import annotations

from argparse import ArgumentParser

default_options = {
    "batch_size": {"type": int, "default": 1024 * 8},
    "dataset": {"type": str, "nargs": 2,
                "default": ["synthetic", "../data/indoor_synthetic/kitchen"]},
    "scene": {"type": str, "default": ""},
    "voxel_path": {"type": str, "default": "outputs/kitchen/vslf.npz"},
    "num_workers": {"type": int, "default": 0},
    "dir_val": {"type": str, "default": "val"},
    "val_step": {"type": int, "default": 250},
    "has_part": {"type": int, "default": 1},
    "res_scale": {"type": float, "default": 1.0},
    "optimizer": {"type": str, "choices": ["SGD", "Adam"], "default": "Adam"},
    "learning_rate": {"type": float, "default": 1e-3},
    "weight_decay": {"type": float, "default": 0.0},
    "scheduler_rate": {"type": float, "default": 0.5},
    "milestones": {"type": int, "nargs": "*", "default": [1000]},
    "le": {"type": float, "default": 1.0},
    "ld": {"type": float, "default": 5e-4},
    "lp": {"type": float, "default": 5e-3},
    "ls": {"type": float, "default": 1e-3},
    "la": {"type": float, "default": 0.0},
    "sigma_albedo": {"type": float, "default": 0.05 / 3.0},
    "sigma_pos": {"type": float, "default": 0.3 / 3.0},
    "ckpt_path": {"type": str, "default": None},
    "emitter_path": {"type": str, "default": None},
    "freeze_emitter": {"type": int, "default": 0},
    "freeze_crf": {"type": int, "default": 0},
    "indir_depth": {"type": int, "default": 5},
    "SPP": {"type": int, "default": 512},
    "spp": {"type": int, "default": 8},
    "ldr_img_dir": {"type": str, "default": None},
    "crf_basis": {"type": int, "default": 3},
    "load_crf": {"type": int, "default": 0},
    "l_crf_increasing": {"type": float, "default": 0.1},
    "l_crf_weight": {"type": float, "default": 0.001},
    # TPU-specific additions
    # data parallel: N devices on this host, one process a device (the
    # trainers start the other N-1 themselves; pipeline/common.run_ranks)
    "n_devices": {"type": int, "default": None},
    # one process of a data-parallel run started elsewhere: the
    # counterparts of the JAX package's IRIS_TPU_MULTIHOST (a coordinator
    # given), IRIS_TPU_NUM_PROCESSES and the process index
    # (parallel/distributed.ensure_multihost); the backend defaults to
    # NCCL on the card and gloo on the CPU
    "coordinator": {"type": str, "default": None},
    "num_processes": {"type": int, "default": None},
    "process_id": {"type": int, "default": None},
    "dist_backend": {"type": str, "default": None,
                     "choices": [None, "nccl", "gloo"]},
    # PRODUCTION DEFAULT (round 5): 4 levels x 16 features — the row-gather
    # grid (models/hashgrid.py row_gather). Same parameter count
    # (L*F*2^19 = 2^24 table floats) and same 64-wide MLP input as the
    # reference 32x2 parameterization (model/brdf.py:222-229), but each
    # corner costs ONE (1,8) row gather instead of 8 scalar/packed
    # gathers — 1.73x full-step throughput on TPU (2.684M vs 1.554M
    # rays/s/chip, PERF.md round-3f), where the scalar-gather latency
    # wall is the chip's weakest axis. Quality receipts: equal-capacity
    # arms indistinguishable at miniature (PERF.md round-3a addendum) and
    # at the 256x192 production-scale record — grid-only A/B vs the r3d
    # record on the bit-identical dataset: render PSNR 28.41 vs 28.35,
    # every decomposition metric within noise (PERF.md round-4d,
    # records/scale_r4a.log).
    # Reference-parity parameterization: --hash_levels 32
    # --hash_features 2 (kept exact; tests pin it explicitly).
    # Round-5 promotion: 4 levels x 16 features (same 2^24 params, same
    # 64-wide MLP input) — 1.36x the 8x8 step (48.7 vs 66.1 ms,
    # records/compact_scatter_arms_r5.log) and the full production-scale
    # grid-only A/B is quality-neutral on image metrics and BETTER on
    # every decomposition-correlation axis (PERF.md round-5f,
    # records/scale_r5_4x16.log). 8x8 was the round-4 default; both are
    # dials away, 32x2 stays the exact reference escape.
    "hash_levels": {"type": int, "default": 4},
    "log2_hashmap_size": {"type": int, "default": 19},
    # wide-feature levels (models/hashgrid.py row_gather): trade levels for
    # features at the SAME parameter count and MLP width — e.g.
    # --hash_levels 8 --hash_features 8 keeps 64 features / 2^19*64 params
    # but costs 1/4 the latency-bound table accesses per query (row
    # gathers are ~free-width on this backend, PERF.md round-2e). -1 =
    # auto (row mode on when hash_features > 2). per_level_scale -1 = auto:
    # span the reference 32-level resolution range at any level count.
    "hash_features": {"type": int, "default": 16},
    "hash_row_gather": {"type": int, "default": -1},
    "per_level_scale": {"type": float, "default": -1.0},
    # hash-grid gradient/forward estimators for TRAINING (see
    # models/hashgrid.py): stochastic_bwd is unbiased with exact forward;
    # stochastic_fwd also single-corner-samples the encode forward (8x
    # fewer latency-bound gathers; adds MC feature noise during training
    # only — eval/render paths never pass a key and stay exact)
    "stochastic_bwd": {"type": int, "default": 1},
    "stochastic_fwd": {"type": int, "default": 1},
    # strided level-block subsampling of the hash-grid gradient scatter:
    # K of n_levels levels updated per step (must divide n_levels). The
    # scatter is 63% of the 32-level train step on TPU; K = n_levels/4
    # cuts it 4x, unbiased, quality-indistinguishable (PERF.md round-2
    # A/B). -1 = that auto default; 0 = scatter all levels.
    "bwd_level_sample": {"type": int, "default": -1},
    # strided level-block subsampling of the FORWARD encode gather during
    # training (requires stochastic_fwd): K of n_levels levels gathered
    # per step, kept features scaled by stride (inverse-scaled block
    # dropout; eval/render stay exact). 0 = off (default: dropout changes
    # the training objective, so it is opt-in — see PERF.md round 2f).
    "fwd_level_sample": {"type": int, "default": 0},
    "max_segments": {"type": int, "default": 128},
    # within-segment partner samples of the semantic propagation loss
    # (train/steps.py propagation_loss). Default = the reference's 1024
    # (train_brdf_crf.py:249): the round-4 receipts show 256 is a real
    # estimator downgrade (grad cosine 0.69 vs 0.88 against a 16384-pair
    # reference; miniature training A/B: albedo corr [.70,.70,.00] vs
    # [.71,.73,.05] and +1.3% final loss — PERF.md round-4e). --n_pairs
    # 256 is the documented perf dial (~4x fewer partner gathers in the
    # semantic-branch brdf steps).
    "n_pairs": {"type": int, "default": 1024},
    # periodic full-state checkpoint cadence (steps) for kill-and-resume
    "save_every": {"type": int, "default": 1000},
    # optimizer steps per dispatch: on the card one CUDA-graph replay of
    # this many steps after an eager first chunk (train/loop.py
    # make_train_chunk; the JAX package runs one jitted lax.scan). Eager,
    # a step's ~1,000 launches keep the host behind the card. Generators,
    # update math and bits are chunk_steps=1's; keep
    # save_every/log_every/val_step multiples of this. 1 = unchunked.
    "chunk_steps": {"type": int, "default": 10},
    # reference trainers budget in epochs (train.sh --max_epochs); when >0
    # this overrides --max_steps as epochs * batches_per_epoch
    "max_epochs": {"type": int, "default": 0},
    # update-scale for the emitter radiance leaf (1.0 = reference parity;
    # raw radiance under Adam crawls at ~lr/step — see train/optim.py)
    "radiance_lr_scale": {"type": float, "default": 1.0},
    # opt-in log-space emitter radiance leaf (radiance = exp(param)): Adam
    # then moves radiance multiplicatively, reaching bright emitters from a
    # dark init in O(log(target/init)/lr) steps instead of target/lr (see
    # train/steps.py radiance_to_param). 0 = reference parity.
    "radiance_log_space": {"type": int, "default": 0},
}


def add_model_specific_args(parser: ArgumentParser | None = None):
    parser = parser or ArgumentParser()
    for name, args in default_options.items():
        parser.add_argument(f"--{name}", **args)
    return parser
