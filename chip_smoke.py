#!/usr/bin/env python3
"""On-card smoke run of iris_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py [--seed 0] [--rounds 2]
    python3 chip_smoke.py --sweep-only [--counts]
    python3 chip_smoke.py --stages-only
    python3 chip_smoke.py --pipeline-only
    python3 chip_smoke.py --relight-only
    python3 chip_smoke.py --tools-only
    python3 chip_smoke.py --parallel-only
    python3 chip_smoke.py --drivers-only
    python3 chip_smoke.py --chunks-only
    python3 chip_smoke.py --renders-only
    python3 chip_smoke.py --encode-only

Needs one NVIDIA card (sm_90a: H100/H200), nvcc and g++. It builds the
traversal kernels from iris_tpu_torch/csrc/traverse.cu and the SAH builder
from csrc/bvh_builder.cpp, then:

1. prints the card's name and power limit (nvidia-smi);
2. builds the kernels and prints the build time, ptxas' report, and for
   every instantiated packet width of the three packet walks the shared
   memory a block takes and the blocks an SM keeps resident;
3. holds each of the seven kernels against its plain PyTorch version on
   the card, on 16,384 camera rays and 16,384 random rays: trace_union on
   the flagship tree (398 faces), trace_paired, trace_paired_streamed,
   trace_streamed, trace_dense and trace_dense_streamed on the 102,014-face
   clutter tree, trace_ordered on a 6,014-face tree built with leaf_size 16
   (its leaf row is too wide for the paired layout); the three packet
   walks at every instantiated packet width on the camera rays (the
   random rays at the shipped width only); and trace_union again on a
   tree the L1 cannot hold, the Morton (heap) tree of the 102,014-face
   scene, on the same two sets; trace_union and the packet walks must be
   bit-equal to their plain versions on every ray;
4. renders the flagship frame (camera_rays(90) = 8,100 pixels) at the
   production width — 4-level x 16-feature x 2^19 row-mode hash grid (a
   128 MB table), MLP 64-64-64-5, 3-basis EMoR CRF, 64^3 SLF seeded with
   nonzero radiance — at spp 8 and indir_depth 5, for --rounds rounds,
   each one CUDA graph replay, after the warm-up round and the capture
   (pipeline.render.make_render_round; a cut of the 64 rounds that
   SPP=512 takes),
   with the AOV pass and CRF to LDR; counts one more round's material
   evaluations (one at the camera hits, one per bounce, one in the AOV
   pass: 8) and, under torch.profiler, the kernels it launches and their
   device time; and holds a small render on the card against the same
   render on the CPU;
5. renders one round of the 102,014-face scene the same way
   (trace_paired_streamed), and one round at depth 2 of the 6,014-face
   scene with leaf_size 16 (trace_ordered) and with leaf_size 4
   (trace_paired);
6. trains at full width: the benchmark step (fwd+bwd of
   crf_forward(path_tracing_single) against 0.5 at 8,100 rays x spp 32 =
   259,200 camera samples, gradients into the hash grid and MLP, the
   emitter radiance and the CRF weights, Adam) through make_train_step,
   1 warm-up + 5 timed steps on the flagship scene and 1 + 3 on the
   102,014-face scene, with the trainers' estimator settings (stochastic
   forward and backward, one level block per step, compact bf16 scatter);
7. takes 3 steps each of the three stage losses (initialize,
   train_emitter, brdf_crf with and without part segmentation) on a
   4,096-pixel demo batch;
8. holds a small train step on the card against the same step on the CPU
   under the same draws;
9. runs the reference-parity configuration at full width: the 32-level x
   2-feature x 2^19 hash grid (HashGridConfig's default, a flat table of
   2^25 floats = 128 MB read through packed bfloat16 words) on the
   102,014-face scene under each of three traversal policies, which send
   the tree to trace_dense, trace_streamed and trace_dense_streamed: one
   render round (spp 8, depth 5, AOVs, CRF) and 1 warm-up + 3 timed steps
   of the benchmark loss through run_training (259,200 camera samples,
   Adam, stochastic forward and backward, 8 of 32 level blocks per step),
   with a state hook that saves one checkpoint, which is loaded again and
   compared. The same on the flagship scene with the unpacked (flat
   float32) table through trace_union; and a small render and train step
   of both table modes on the card against the CPU;
10. runs the shading-cache stages of the pipeline on two datasets that
   the port's generator (data/make_demo_dataset.py) writes at 240 x 320
   pixels, 2 train and 1 val frames (cuts of a capture's frame size and
   count), spp 48, depth 2: the flagship scene (398 faces, trace_union,
   the generator's fixed cameras) and the 102,014-face scene
   (trace_paired_streamed; its cameras from the generator's orbit search,
   since its 8,500 boxes enclose the fixed ones). Every frame must see
   lit surfaces and a train frame the light. On each, through
   each CLI's main(argv) on the card: slf_bake at 256^3 (run twice: the
   same bits), extract_emitter at threshold 0.99 (its per-face mean taken
   twice: the same bits; on the flagship the light's two faces found, 8
   faces at most) and its update mode with the light's radiance,
   bake_shading and refine_shading on one frame at the reference's spp
   (256 diffuse, 64 and 128 x 5 specular; 128 / 64 at depth 5 with the
   production 4 x 16 x 2^19 row-mode material from --seed, exact
   encode) and chunk budgets. Per stage it prints wall seconds, rays
   traced and rays per second, launches by kernel, peak device memory
   and, for the two bakes, ms per chunk and the largest trace; every EXR
   written must read back finite and >= 0 under the expected names, each
   bake's diffuse map must be nonzero, and only the dataset's kernel may
   launch. The largest trace of each bake (655,360 secondary rays of
   bake_shading, 2,621,440 of refine_shading's fused trace) is kept as the
   kernel received it, for phase 13. On the flagship, path_tracing_det_diff and
   path_tracing_det_spec on 1,024 first hits run on the card and on the
   CPU under the same samples (ConstantBRDF within 1e-5, the NGP material
   on 95% of values within rtol 2e-3 / atol 1e-4);
11. runs the training half of the pipeline and the render CLI on the
   same two datasets, from phase 10's SLF bakes, each CLI through its
   main(argv) on the card, in scripts/run_pipeline.sh's order and at its
   production settings (batch 8,192, SPP 128 at spp 32, the 4 x 16 x 2^19
   row-mode grid, lp 0.005 la 0.01 l_crf_weight 0.001), only the steps
   cut: extract_emitter (the zero-radiance mask), initialize (20 steps in
   chunks of 10, the first eager, the second one CUDA-graph replay;
   validation renders and a checkpoint every 10),
   extract_emitter --mode update, bake_shading on both train frames,
   train_brdf_crf (brdf0, warm from initialize), slf_refine (twice: the
   same bits), train_emitter, extract_emitter --mode update,
   refine_shading --encode stoch on both train frames, train_brdf_crf
   again on those caches (brdf1) and render on the first val frame with
   brdf1. Per CLI it prints wall seconds, steps and ms a step (CUDA events
   around each eager step and each graph replay, a replay's time split over
   its steps; the median after the first chunk), camera samples a
   second for the two path-tracing trainers, the seconds of each
   validation render, launches by kernel against the count the settings
   give, peak device memory, and render's PSNR and SSIM against the
   frame's LDR. Hard checks: every logged loss finite; every artifact
   loads back onto the card equal to its full-state file's params; on the
   flagship, initialize run for 10 steps and --resume'd to 20 gives the
   uninterrupted run's losses and checkpoint bits; slf_refine twice the
   same bits; the emitter radiance after each update finite and > 0; the
   validation PNGs at steps 0 and 10 and every file of render under the
   JAX package's names, metrics.txt finite; only the dataset's kernel
   launched. The largest trace of each trainer's steps is kept as the
   kernel received it, for phase 13;
12. times the five big-tree kernels, and trace_union's per-ray walk of
   the same tree, on the same 518,400 rays of the 102,014-face train step,
   in turns there and back, and compares their hits pairwise; then times
   every instantiated packet width of the three packet walks on those
   rays, there and back, and prints one line per kernel: W -> ms; for the
   per-ray walks trace_union, trace_ordered, trace_paired and trace_dense
   it prints the
   plain versions' pops, warp_steps and lane_busy on each path's rays and
   on the 518,400 rays, and the registers, local memory (stack and
   spills), shared memory and resident blocks per SM of the instantiation
   each path launched, as the CUDA runtime reports them;
13. holds trace_union and trace_paired_streamed on the stages' and the
   trainers' traffic: each bake's largest trace and each trainer's
   (initialize, train_brdf_crf, train_emitter: RayBatcher's spatially
   sorted batches) on each dataset, bit-equal to the plain version on
   every ray (trace_paired_streamed's on the first 131,072 of each batch),
   timed and bounded; then prints one JSON line
   {"kernels": [...]} with each kernel's launches on the main paths, its
   error against the plain version on every input compared, its time,
   the plain version's time (one run) and its roofline bound, measured on
   the largest input a main path gave the kernel (for trace_union and
   trace_paired_streamed the refine_shading trace; their train-step
   input's numbers under "train_step_input" and each stage batch's under
   "stage_traffic"; the other big-tree kernels on the train step's rays;
   the bound of the packet walks counts the per-ray walk's tests); the
   rows of the four per-ray walks add this run's pops, warp_steps and
   lane_busy on the row's input, and those four numbers of the path's
   instantiation; trace_union's row adds its time and bound on the
   518,400 rays of the 102K train step, and the rows of trace_union and
   trace_paired_streamed their numbers on phase 14's traffic under
   "relight_traffic"; last, after phase 20, the rows "encode" and "pack"
   of the hash grid's kernels: their launches on the main paths (phases
   4-19, as the kernels counted them on the card, by phase under
   "launches_by_phase"; an encode in every render round and training
   chunk of phases 11, 14, 18 and 19) and phase 20's error, times and
   bounds at the render cell's shape (the packed encode and its words) and
   the row rows under "rows" and "rows_bf16";
14. (run right after phase 11, its traffic held in phase 13) drives the
   consumers of phase 11's trained scene on both datasets, each CLI
   through its main(argv) on the card with brdf1's checkpoint (the 4 x 16
   x 2^19 row-mode grid) and the bake directory: extract_emitter_mesh
   (emitter.ply); render_video --n_interp 2 at phase 11's render settings
   (SPP 128 at spp 32, depth 5) with the AOV videos; and render_relight
   --mode traj --n_frames 2 at relight_demo.sh's SPP 32 / spp 8 on three
   configs: scripts/relight/demo_ball.yaml with --disco 1 (a sphere
   emitter, an Au conductor, depth 3, a 20-light disco ball), a
   relight_1-shaped config (the emitter swap onto that emitter.ply and
   scannetpp/bathroom2/relight_1.yaml's disco block: 40 lights and
   spots, radius 0.2; depth 7) and an insert-shaped one (an OBJ written
   here, inserted as an Au conductor and as a roughconductor; depth 7).
   Per run it prints wall seconds, ms a round (CUDA events), rays traced a
   round (the spots' S x n shadow rays counted), seconds a frame,
   launches by kernel and peak device memory. Hard checks: every PNG and
   video (an mp4 or a frames directory) under the JAX package's names;
   every relight and video frame finite, within [0, 1] and not black (the
   AOV videos' frames finite and within [0, 1]); the disco frames
   apart; each scene's BVHs built exactly once (1 + [disco ball]); the
   launches exactly (1 + D (2 + [spots])) (1 + [disco ball]) a round, the
   static soup on the dataset's kernel and the disco ball's tree on
   trace_union; and on the flagship a 16 x 16 relight (spp 4, depth 2,
   the disco ball and its 20 spots) on the card and on the CPU under the
   same samples, 95% of values within rtol 2e-3 / atol 1e-4. The
   relight_1 run's largest traces (its 40 spots' shadow rays, 24.6M on a
   240 x 320 frame at spp 8) are kept for phase 13: on the flagship's
   static tree and the disco ball's tree (trace_union), on the 102K
   soup (trace_paired_streamed);
15. (run right after phase 14, its traffic held in phase 13) drives the
   dataset-preparation tools, each CLI through its main(argv) on the card,
   on phase 11's two 240 x 320 datasets and on one new dataset per scene
   at 584 x 876 (ScanNet++'s 1752 x 1168 DSLR frame at the scene scripts'
   RES_SCALE=0.5: 511,584 rays a frame; 2 train and 1 val frames, written
   at generator spp 2, depth 1, cuts): extract_geometry, render_semantic
   with per-face labels face // 12 % 128, fuse_segmentation at 128 labels,
   hdr2ldr on train/Image and process_images --max_width 438 on hdr2ldr's
   PNGs; and the implicit MLP (models/mlps.py, the JAX defaults) forward
   on a full-size frame's 511,584 hit positions. Per CLI it prints wall
   seconds, frames, rays a second, launches by kernel and peak device
   memory. Hard checks: exactly 1 launch a frame of the dataset's kernel
   alone for extract_geometry and render_semantic, 2 for
   fuse_segmentation, none for the host tools; every frame's hit share >
   0.95, every depth finite and >= 0, a miss 0 everywhere; the fused
   labels the generator's part ids (face // 12 % 16) on > 90% of the
   observed faces and the same bits when fused again; hdr2ldr's directory
   loads back as the dataset's LDR images with its cam/ files;
   process_images' PNGs 438 wide; and on the flagship's first 240 x 320
   frame the card against the CPU: labels, fused labels and rewritten
   views equal, the geometry within atol 1e-5, the implicit MLP (float32,
   TF32 off) within rtol 1e-4 / atol 1e-5 of its largest value. The three
   ray-casting tools trace the same camera rays; on a full-size frame they
   are held in phase 13 (trace_union on the flagship's, trace_paired_streamed
   on the 102K's), under "tools_traffic";
16. (run right after phase 15) trains data-parallel: the initialize CLI
   through its main(argv) on phase 11's two datasets and bakes at phase
   11's settings (batch 8,192, SPP 128 at spp 32, the 4 x 16 x 2^19
   row-mode grid), 5 steps, three ways: with no group; as one NCCL rank
   (--coordinator file://... --num_processes 1 --process_id 0, the
   default backend on the card); and as two gloo ranks sharing cuda:0
   (--dist_backend gloo; this process is rank 0, a spawned one rank 1:
   NCCL refuses two ranks on one card, and the card's machine has one).
   It prints ms a step of each (CUDA events, the median after the first;
   the two-rank time is not a scaling figure, both ranks sharing one card
   and gloo moving the gradients over TCP), the group's backend, the
   bytes a step sends and rank 0's launches a step. Hard checks: one NCCL rank logs the losses
   of no group; the two ranks' parameters are the same bits after every
   step; their logged losses within 1e-4 relative of no group's; their
   final leaves held to no group's by the Adam rule of
   tests/torch_parity.hold_leaves (with no group's gradients for the JAX
   package's); one train_log.jsonl, one validation set and one pair of
   checkpoints written; each step's collectives exactly the gradient
   all-reduce (the parameter bytes) and one all-gather of 7 floats a
   ray (the per-ray tensors the loss's local part computes: the batch's
   own columns are read whole on every rank); only the dataset's kernel launched. A rank that fails fails the
   run;
17. (run right after phase 16, its launches counted in phase 13's line)
   drives the port's twins of the four root scripts, each through the call a user
   makes: iris_tpu_torch.bench.main([]) (the benchmark step, fwd+bwd of
   crf_forward(path_tracing_single) at 8,100 camera rays x spp 32 with no
   optimizer, on the demo's zero SLF, 24 calls a CUDA graph on the
   flagship scene and 8 on the 102,014-face scene, after one eager call:
   one warm and three timed replays); bench_components.main([]) (the
   17 components of the JAX package's bench_components.py); bench_scaling
   .main([]) (one NCCL rank on cuda:0); graft_entry.entry()'s forward and
   graft_entry.dryrun_multichip(2, backend="gloo") (two spawned gloo
   ranks sharing cuda:0). It prints every JSON line they print, bench's ms
   a call in each timed replay, bench's rates beside phase 6's (which add
   Adam and a
   seeded SLF), peak device memory of the components and the phase's
   seconds. Hard checks: bench's line holds the JAX keys but
   "vs_baseline", with "device" and "runs", finite positive rates,
   kernel_mode_102k trace_paired_streamed, and exactly 2 launches a call
   of trace_union on the flagship and of trace_paired_streamed on the
   102K scene; every component under the JAX name, in the JAX order,
   finite and positive; one scaling line, devices 1, backend nccl; the
   entry's forward (1024, 3), finite, in [0, 1]; the two ranks' loss
   within 1e-4 relative of the same step with no group;
18. (run right after phase 17, its launches counted in phase 13's line)
   one-dispatch training chunks, CUDA graphs (train.loop.make_train_chunk,
   utils.timing.bench_scan): (a) phase 6's benchmark loss with Adam
   through run_training, 40 steps on the flagship (trace_union) and on
   the 102K scene (trace_paired_streamed), once at chunk_steps 10 (the
   first chunk eager, one capture replayed at step0 10, 20 and 30) and
   once at chunk_steps 1, from the same fresh parameters, a rate cut at
   step 25 inside a replayed chunk; then a fresh chunk's eager warm-up and
   one replay under torch.profiler, and one replay of a graph that holds
   the chunk's registered generators and nothing else. It prints ms a
   step of each (CUDA events around each step and each replay), the
   launches a chunk (as the kernels count them on the card), the host's
   kernel-launch and graph-launch calls a chunk and the bare graph's,
   the device's busy time and idle share of a chunk, peak memory and the
   capture's seconds. (b) initialize.main at phase 11's settings on phase 11's
   flagship dataset and bake, 30 steps at --chunk_steps 10 and at 1,
   validation at step 0, a checkpoint every 10, each step timed as in
   phase 11. (c) bench_scan's graph of 4 bench.grad_step calls on both
   scenes, and bench.measure's ms a call by replay (phase 17's) with the
   card's name and power limit. Hard checks: in (a) the losses the same
   bits and a digest of every parameter, moment, step count and rate
   the same after every chunk, 2 launches a step of the scene's kernel
   alone in both runs, one capture and three replays, one graph launch
   for a replayed chunk and no more kernel-launch calls than the bare
   graph's, 2 a step of the kernel counted in the profiled eager chunk
   and replay alike; in (b) the losses and both checkpoint files the
   same bits; in (c) the graph's scalar the eager calls' bits;
19. (run right after phase 18, its launches counted in phase 13's line)
   one-dispatch rendering, CUDA graphs (utils.graphs.GraphedUnit, the
   JAX package's jitted render units), on the flagship (trace_union) and
   the 102K scene (trace_paired_streamed) with the 4 x 16 x 2^19 row-mode
   grid: (a) the render round (render_chunk + aov_chunk, 8,100 pixels,
   spp 8, depth 5) eager and through pipeline.render.make_render_round
   (its eager warm-up round, one capture, replays), 2 frames x 3 rounds
   and render_frame's mean; ms a round each way (CUDA events, median of
   5), one round of each under torch.profiler, capture s and peak MB;
   (b) a relight_1-shaped round (the scene's mesh with the BRDF and its
   emitters, relight_1's disco ball: 40 lights, 40 spots, D = 7; a 240 x
   320 frame at spp 8) through pipeline.render_relight.make_relight_round
   over 3 frames at 3 phases of 2 rounds, the ball turned in place
   (set_disco_phase(..., out=)), each round against relight_path_tracing
   of set_disco_phase's new scene; (c) the trainers' validation render
   (make_validation_hook: a 240 x 320 frame at spp 32, depth 5, 9 chunks
   of 8,192 rays and one of 3,072) sharing a GraphContext with a
   make_train_chunk of 2 steps of the benchmark loss with Adam, after the
   chunk's warm-up and after each of two replayed chunks (in-place
   parameter updates), against the eager render, then the hook's PNGs.
   Hard checks: every graphed round, relight round and validation image
   the eager one's bits; 8 traversal launches counted by the kernels in
   the eager and in the replayed render round; one graph launch for a
   replayed round and as many kernel-launch calls as a graph of its one
   generator alone (2); one capture a round unit, three in (c); the
   relight replays' launches (1 + 3 D) on each tree; the disco frames
   different; the parameters moved between validation renders. Phases
   4, 5, 9, 11 (render) and 14 now run and time rounds as graph replays;
20. the hash grid's exact encode kernel (models/cuda_hashgrid.py,
   csrc/hashgrid.cu) at the cells' shapes: 614,400 points x 32 levels of
   the packed 32 x 2 x 2^19 grid (a render round's encode) and 262,144
   points x 4 levels of the 4 x 16 x 2^19 row grid (a training step's
   exact encode), float32 and bfloat16 reads; each held bit for bit
   against encode_plain on the card, one launch a call counted by the
   kernel; ms a call (median of 20, L2 flushed) beside its bound (the
   bytes it cannot avoid at 3.35 TB/s: each table entry its points touch
   once, the points, the output) and encode_plain's time, the bytes of
   every corner's read printed beside; the packed words made each encode
   by the pack kernel, held against _pack_bf16, counted and timed beside
   it, its bound the float32 table read and the words written once;
21. prints the card line again and, last, the run's JSON verdict.

Any failed check raises, and the script then exits non-zero with no
verdict line. It imports nothing of JAX or of the JAX package.

--stages-only runs phases 1-2, 10 and the stage-traffic holds of 13 alone
(about two minutes on an H100) and prints no verdict line.

--pipeline-only runs phases 1-2, then phase 11 on two new datasets (their
SLF baked first) and the trainer-traffic holds of 13 alone (about three
minutes on an H100), and prints no verdict line.

--relight-only runs phases 1-2, writes the two datasets with their SLF
and emitter mask (the generator's light as its radiance) and the
production material from --seed as brdf1's checkpoint, then phase 14 and
its holds alone (no verdict line).

--tools-only runs phases 1-2, then phase 15 on two new 240 x 320 datasets
(written as --pipeline-only writes them) and the two full-size ones, and
its holds (no verdict line).

--parallel-only runs phases 1-2, writes the two datasets with their SLF
and emitter mask, then phase 16 alone (about two minutes on an H100),
and prints no verdict line.

--drivers-only runs phases 1-2, then phase 17 alone (no verdict line).

--chunks-only runs phases 1-2, builds the flagship and 102K scenes, writes
the flagship dataset with its SLF and emitter mask as phase 10 does, then
phase 18 alone, bench.measure included (no verdict line).

--renders-only runs phases 1-2, builds the flagship and 102K scenes, then
phase 19 alone (no verdict line).

--encode-only runs phases 1-2, then phase 20 alone (no verdict line).
--chunks-only and --renders-only also print the hash grid kernels'
launches in their phase and check that the encode kernel ran.

--sweep-only runs phases 1-2, builds the 102,014-face scene, takes the
518,400 rays of one train step and runs the width sweep of phase 12 alone
(about a minute); --counts adds the plain versions' counters (visits or
pops, lane slab tests, window reloads and how many of them a forward
prefetch serves, far pops) at every packet width on the camera check rays.
It prints no verdict line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

# the benchmark's train loss, its parameters and the trainers' estimator
# settings (phases 6-9), and the kernels' yardstick (median CUDA-event
# time, L2 flushed, a spin kernel first); they import torch, which this
# script otherwise imports lazily
from iris_tpu_torch.bench import bench_params, make_bench_loss, train_config
from iris_tpu_torch.utils.timing import time_ms

# H100 SXM peaks (NVIDIA data sheet) for the roofline bound
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

FLAGSHIP_CLUTTER = 32          # 398 faces
CLUTTER_102K = 8500            # 102,014 faces
CLUTTER_6K = 500               # 6,014 faces
WIDE_LEAF = 16                 # leaf row of 192 floats: past the paired layout
SPP = 8
TRAIN_SPP = 32                 # the trainers' per-round spp
STAGE_BATCH_SIDE = 64          # 4,096-pixel batch of the stage losses
KERNELS = ("trace_union", "trace_paired", "trace_paired_streamed",
           "trace_ordered", "trace_streamed", "trace_dense",
           "trace_dense_streamed")
# the production grid (pipeline/config.py:70-79 of the JAX package) and the
# reference's (HashGridConfig's default: 32 levels x 2 features, packed)
PRODUCTION_GRID = dict(hash_levels=4, hash_features=16, per_level_scale=-1.0)
REFERENCE_GRID = dict(hash_levels=32, hash_features=2, per_level_scale=1.3)
LOG2_TABLE = 19
SLF_RES = 64
INDIR_DEPTH = 5
CAMERA_SIDE = 90               # 8,100 pixels
CHECK_RAYS_SIDE = 128          # 16,384 rays per comparison set
# trace_streamed's plain version took 64.9 s on the 518,400 rays of a train
# step and 99.1 s on the first 65,536 of them (H100, two runs: it loops
# once per node the busiest packet visits, whatever the ray count). Its
# plain time and packet counts are therefore those of the 16,384 camera
# check rays, and on the path's input the kernel is held against the
# per-ray version of the same walk (trace_union_plain), whose hits are the
# same bits. Empty this tuple to run the plain version at full size.
PLAIN_ON_CHECK_SET = ("trace_streamed",)
PACKET_KERNELS = ("trace_streamed", "trace_paired_streamed",
                  "trace_dense_streamed")
# the per-ray walks whose plain versions count pops and warp steps
WALK_KERNELS = ("trace_union", "trace_ordered", "trace_paired",
                "trace_dense")
WALK_COUNTS = ("pops", "warp_steps", "lane_busy")
WALK_RESOURCES = ("registers", "local_bytes_per_thread",
                  "smem_bytes_per_block", "blocks_per_sm")
DEVICE = "cuda"
# the shading-cache stages (phase 10) on datasets the port's generator
# writes: the frame size and the frame count are cuts of a real capture;
# the reference's sample counts and chunk budgets are not cut
STAGE_HW = (240, 320)
STAGE_SPLITS = (2, 1)          # train and val frames
STAGE_GEN_SPP = 48             # the generator's render
STAGE_GEN_DEPTH = 2
STAGE_VOXELS = 256
# (label, clutter boxes, the kernel kernel_for must pick, orbit cameras):
# the 102K scene's 8,500 boxes fill the room, so that its fixed cameras sit
# inside boxes and see black; the generator's orbit search places them clear
STAGE_DATASETS = (("flagship", FLAGSHIP_CLUTTER, "trace_union", False),
                  ("clutter102k", CLUTTER_102K, "trace_paired_streamed",
                   True))
# the stage traffic each kernel is held and timed on (phases 10 and 12):
# the largest trace of each bake; trace_paired_streamed's plain version
# (~9 s per 518,400 rays) is held on the first rays of each batch
STAGE_CAPTURES = ("bake_shading", "refine_shading")
STAGE_PLAIN_RAYS = {"trace_union": None, "trace_paired_streamed": 131_072}
STAGES = ("slf_bake", "extract_emitter", "bake_shading", "refine_shading")
DET_CHECK_HITS = 1024
DET_CHECK_SPP = 4
STAGE_DIR = os.path.join("outputs", "chip_smoke_stages")
# phase 11: scripts/run_pipeline.sh's production settings, steps cut
PIPE_BATCH = 8192
PIPE_SPP = 128                 # SPP: 4 rounds of TRAIN_SPP a step
PIPE_STEPS = 20
PIPE_CHUNK = 10                # chunk_steps, val_step and save_every
PIPE_CLIS = ("initialize", "bake_shading", "train_brdf_crf", "slf_refine",
             "train_emitter", "refine_shading", "brdf1", "render")
# phase 16: the data-parallel trainer at phase 11's settings, steps cut
PAR_STEPS = 5
PAR_GATHERED = 7           # floats a ray initialize's loss gathers
PAR_DIR = os.path.join("outputs", "chip_smoke_parallel")
CHUNK_STEPS = 40               # phase 18: run_training steps a scene
CHUNK = 10                     # the trainers' default chunk_steps
CHUNK_MILESTONE = 25           # a rate cut inside the third chunk
CHUNK_INIT_STEPS = 30          # phase 18's initialize runs
CHUNK_SCAN_ITERS = 4           # bench.grad_step calls in the held graph
CHUNK_DIR = os.path.join("outputs", "chip_smoke_chunks")
# phase 19: one-dispatch rendering
RENDER_ROUNDS = 3              # rounds a frame held bit for bit
RENDER_TIMED = 5               # rounds timed each way
RELIGHT_ROUND_DEPTH = 7        # relight_1's max_depth
RELIGHT_ROUND_SPOTS = 40       # relight_1's disco lights and spots
RELIGHT_ROUND_PHASES = (0.0, 0.7, 1.9)
VAL_RENDER_STEPS = (0, 10, 20)
RENDERS_DIR = os.path.join("outputs", "chip_smoke_renders")
# phase 20: the encode kernel at the cells' grids (benchmark/configs/) and
# points (a render round's 614,400 samples; a training step's 262,144
# path-traced first hits)
ENCODE_CASES = (
    ("render", "packed", 614_400,
     dict(n_levels=32, n_features=2, log2_table_size=19, base_resolution=16,
          per_level_scale=1.3)),
    ("train", "rows", 262_144,
     dict(n_levels=4, n_features=16, log2_table_size=19, base_resolution=16,
          per_level_scale=15.045777687353615, row_gather=True)),
    ("train", "rows_bf16", 262_144,
     dict(n_levels=4, n_features=16, log2_table_size=19, base_resolution=16,
          per_level_scale=15.045777687353615, row_gather=True)),
)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
# phase 14: the consumers of phase 11's trained scene; relight_demo.sh's
# SPP 32 at spp 8, frames cut to 2
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
DEMO_BALL = os.path.join(REPO_DIR, "scripts", "relight", "demo_ball.yaml")
RELIGHT_SPP = 32
RELIGHT_SPP_ROUND = 8
RELIGHT_FRAMES = 2
VIDEO_INTERP = 2
# scripts/relight/scannetpp/bathroom2/insert.yaml:39, the emitter swap's
# radiance, and a disco position inside the room
RELIGHT_SWAP_RADIANCE = [9.040693, 9.697464, 10.583247]
RELIGHT_DISCO_POSITION = (1.0, 1.0, 0.7)
# the run whose 40-spot shadow traces phase 13 holds
RELIGHT_HELD = "relight_1"
# the small relight held card against CPU: side, spp, depth
RELIGHT_CHECK = (16, 4, 2)
# phase 15: the dataset-preparation tools, on phase 11's two datasets and
# on one per scene at ScanNet++'s 1752 x 1168 DSLR frame at the scene
# scripts' RES_SCALE=0.5 (scripts/scenes/scannetpp_*.sh): 511,584 rays a
# frame. The generator's spp and depth are cut for them: the tools read
# the geometry, the part maps and the HDR frames, not how noisy they are
TOOLS_HW = (584, 876)
TOOLS_GEN_SPP = 2
TOOLS_GEN_DEPTH = 1
TOOLS_LABELS = 128             # fuse_segmentation's default
TOOLS_MAX_WIDTH = 438          # process_images: half the full frame's width
TOOLS_DIR = os.path.join("outputs", "chip_smoke_tools")
# each ray-casting tool's traversals a frame
TOOLS_TRACES = {"extract_geometry": 1, "render_semantic": 1,
                "fuse_segmentation": 2}
TOOLS = tuple(TOOLS_TRACES) + ("hdr2ldr", "process_images")
TOOLS_MLP_SEED = 41            # the implicit MLP's weights: seed + 41
# phase 17: the root scripts' twins; the JSON keys and the components of the
# JAX package's bench.py and bench_components.py (bench's "vs_baseline"
# compares with a TPU number and has no twin)
BENCH_KEYS = ("metric", "value", "unit", "rays_per_s_102k_faces",
              "kernel_mode_102k", "device", "runs")
COMPONENTS = (
    "traversal_rays_per_s",
    "hashgrid16_fwd_queries_per_s",
    "hashgrid16_exact_fwd_bwd_queries_per_s",
    "hashgrid16_stoch_bwd_fwd_bwd_queries_per_s",
    "hashgrid16_stoch_fwd_fwd_bwd_queries_per_s",
    "hashgrid16_stoch_fwd_ls4_fwd_bwd_queries_per_s",
    "hashgrid32_fwd_queries_per_s",
    "hashgrid32_exact_fwd_bwd_queries_per_s",
    "hashgrid32_stoch_bwd_fwd_bwd_queries_per_s",
    "hashgrid32_stoch_fwd_fwd_bwd_queries_per_s",
    "hashgrid32_stoch_fwd_ls4_fwd_bwd_queries_per_s",
    "hashgrid8x8row_fwd_queries_per_s",
    "hashgrid8x8row_default_fwd_bwd_queries_per_s",
    "pts_fwd_rays_per_s",
    "pts_fwd_bwd_exact_rays_per_s",
    "pts_fwd_bwd_stoch_bwd_rays_per_s",
    "pts_fwd_bwd_stoch_fwd_ls4_rays_per_s",
)
SCALING_KEYS = ("metric", "devices", "value", "unit",
                "efficiency_vs_linear", "backend", "device")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_all():
    """Start the native builds together; returns (seconds, ptxas lines)."""
    from iris_tpu_torch.geometry import bvh_native, cuda_intersect
    from iris_tpu_torch.models import cuda_hashgrid

    results, errors = {}, []

    def run(name, fn):
        try:
            results[name] = fn()
        except Exception as e:  # re-raised below, after both joined
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(n, f)) for n, f in
               (("traverse", cuda_intersect.build), ("bvh", bvh_native.build),
                ("hashgrid", cuda_hashgrid.build))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    cuda_intersect.get_lib()
    cuda_hashgrid.get_lib()
    ptxas = [ln.strip() for name in ("traverse", "hashgrid")
             for ln in results[name][1].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    return time.perf_counter() - t0, ptxas


def compare_hits(got, want):
    """Kernel (t, u, v, face) against the plain version's, on the
    traversal bar: hit/miss equal on >= 99.9% of rays, t within 1e-5
    relative where both hit, face ids equal except at t ties (1e-6).
    Returns (max |t| error where both hit, count of bit-equal rays)."""
    import torch

    t1, u1, v1, f1 = got
    t2, u2, v2, f2 = want
    h1, h2 = f1 >= 0, f2 >= 0
    agree = (h1 == h2).float().mean().item()
    check(agree >= 0.999, f"hit/miss agreement {agree:.6f} < 0.999")
    both = h1 & h2
    err = (t1 - t2).abs()
    max_err = float(err[both].max()) if both.any() else 0.0
    rel = (err / t2.abs().clamp(min=1e-30))[both]
    check(not both.any() or float(rel.max()) <= 1e-5,
          f"t relative error {float(rel.max()) if both.any() else 0}")
    tie = err <= 1e-6 * t2.abs().clamp(min=1.0)
    check(bool((tie | (f1 == f2) | ~both).all()), "face ids differ off ties")
    same = ((t1 == t2) & (u1 == u2) & (v1 == v2) & (f1 == f2)).sum().item()
    return max_err, int(same)


def test_flops(counts):
    """FP32 operations of a walk's counted slab and triangle tests."""
    from iris_tpu_torch.geometry import cuda_intersect as ci

    return counts["slab"] * ci.SLAB_FLOPS + counts["mt"] * ci.MT_FLOPS


def roofline(tracer, counts, n_rays, paired):
    """Least time for the closest hits of this run's rays: each ray read
    and each hit written once, the tree's useful bytes read once (the pair
    records and the leaves' triangle rows for the paired and dense walks,
    whatever padding a layout adds; nodes (N, 8) and tris (P, 12) for the
    union, streamed and ordered walks), and the slab and triangle tests in
    `counts` at the FP32 peak. `counts` is the least work known to give
    these hits on this tree: the kernel's own plain walk for the per-ray
    kernels (for trace_ordered, the slab tests its kernel makes: one at
    the root and two per internal node entered, the pop-time test being a
    compare of the pushed entry distance); for a packet walk the per-ray
    walk over the same rows
    (near-first for the paired and dense packets, stackless for
    trace_streamed), which finds the same hits with fewer tests (a packet
    visits the union of its rays' paths, and that extra is the kernel's
    cost, not the function's need)."""
    from iris_tpu_torch.geometry import cuda_intersect as ci

    if paired:
        _, _, n_pairs, n_leaf_rows = ci.pack_paired_compact(tracer)
        tree = n_pairs * 16 * 4 + n_leaf_rows * tracer.leaf_size * 48
    else:
        tree = tracer.n_nodes * 32 + tracer.tris.shape[0] * 48
    nbytes = n_rays * (24 + 16) + tree
    ops = test_flops(counts)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes, ops


def reset_launches():
    """Zero the launch counts the kernels keep on the card."""
    from iris_tpu_torch.geometry import cuda_intersect as ci

    ci.reset_kernel_counts()


def read_launches():
    """Each kernel's launches since reset_launches, as the kernels counted
    them on the card (a graph's replays included: they run the kernels)."""
    from iris_tpu_torch.geometry import cuda_intersect as ci

    counts = ci.launch_counts()
    return {name: counts[name] for name in KERNELS}


def take_encode_launches():
    """The hash grid's kernels' launches since the last call (or since
    their library was loaded), as they counted them on the card, replays
    included: {"encode": n, "pack": n}; zeroes the counts."""
    from iris_tpu_torch.models import cuda_hashgrid

    counts = cuda_hashgrid.launch_counts()
    cuda_hashgrid.reset_launch_counts()
    return counts


class record_largest_trace:
    """While active, keeps the largest (origins, directions) batch that
    geometry.intersect.ray_trace is given, as the kernel receives it (after
    the spatial sort), and the tree it was traced against. Entered again,
    it goes on keeping the largest batch of every stretch it was active.
    With by_tree, it keeps the largest batch of each tree: {the tree's
    n_faces: that record}. A trace recorded into a CUDA graph capture is
    not kept: its inputs live in the graph's pool, rewritten at every
    replay (a trainer's eager first chunk holds its traces)."""

    def __init__(self, by_tree=False):
        self.by_tree = by_tree
        self.captured = {}

    def __enter__(self):
        from iris_tpu_torch.geometry import intersect

        self._intersect = intersect
        self._ray_trace = ray_trace = intersect.ray_trace
        captured, by_tree = self.captured, self.by_tree

        def recording(tr, xs, ds):
            import torch

            if torch.cuda.is_current_stream_capturing():
                return ray_trace(tr, xs, ds)
            cap = (captured.setdefault(tr.n_faces, {}) if by_tree
                   else captured)
            if xs.shape[0] > cap.get("n", 0):
                cap.update(n=xs.shape[0], tracer=tr,
                           o=xs.detach().float().contiguous().clone(),
                           d=ds.detach().float().contiguous().clone())
            return ray_trace(tr, xs, ds)

        intersect.ray_trace = recording
        return captured

    def __exit__(self, *exc):
        self._intersect.ray_trace = self._ray_trace


def timed_once(fn):
    """(CUDA-event milliseconds, result) of one run of fn."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def seed_slf(em, seed, dev):
    """The demo's SLF is all zero; nonzero cache values make the
    cache-termination branch (emitter.py:141-146) do real work."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    rad = torch.rand(em.slf.radiance.shape, generator=gen, device=dev)
    em.slf.radiance = 0.05 + 0.45 * rad


class count_traced_rays:
    """While active, counts the rays the traversal kernels trace and their
    launches, as the kernels count them on the card (so a CUDA graph's
    replays count what they run): `counted` holds {"rays", "calls"} once
    the block has ended."""

    def __enter__(self):
        from iris_tpu_torch.geometry import cuda_intersect as ci

        self._ci = ci
        self._before = ci.kernel_counts()
        self.counted = {"rays": 0, "calls": 0}
        return self.counted

    def __exit__(self, *exc):
        after = self._ci.kernel_counts()
        self.counted.update(
            calls=sum(after[k][0] - self._before[k][0] for k in after),
            rays=sum(after[k][1] - self._before[k][1] for k in after))


class time_calls:
    """While active, times every call of module.<name> on the host clock,
    the card synchronized before and after each call."""

    def __init__(self, module, name):
        self.module, self.name = module, name

    def __enter__(self):
        import torch

        orig = self.orig = getattr(self.module, self.name)
        times = self.times = []

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*a, **k)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return out

        setattr(self.module, self.name, timed)
        return times

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def run_stage(main_fn, argv, frame_fn=None):
    """One stage CLI's main(argv) on the card, launch counts set to 0 just
    before and read just after: wall seconds (the CLI's own set-up, its BVH
    build and dataset reads included), rays traced, launches by kernel,
    peak device memory; with frame_fn = (module, name) of the stage's
    per-frame function, also the seconds spent in it."""
    import contextlib

    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with count_traced_rays() as counted, (
            time_calls(*frame_fn) if frame_fn
            else contextlib.nullcontext([])) as frame_times:
        t0 = time.perf_counter()
        main_fn(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches()
    st = {"wall_s": wall, "rays": counted["rays"],
          "traces": counted["calls"], "rays_per_s": counted["rays"] / wall,
          "launches": launches,
          "peak_memory_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
    if frame_fn:
        st.update(frame_s=sum(frame_times),
                  frame_rays_per_s=counted["rays"] / sum(frame_times))
    return st


def frames_seen(tracer, mesh, root):
    """What each frame of the dataset sees: the share of pixels whose
    first hit is a surface, the share that sees the light (the last two
    faces), the mean LDR value."""
    import numpy as np
    import torch

    from iris_tpu_torch.data.datasets import load_dataset
    from iris_tpu_torch.geometry.intersect import ray_intersect

    dev = tracer.nodes.device
    seen = {}
    for split in ("train", "val"):
        ds = load_dataset("synthetic", root, split=split, img_dir="ldr",
                          load_gt=False)
        for i in range(ds.n_frames):
            fr = ds.frame(i)
            rays = torch.from_numpy(fr["rays"]).to(dev)
            _, _, _, tri, valid = ray_intersect(tracer, rays[:, :3],
                                                rays[:, 3:6])
            light = (tri >= mesh.n_faces - 2).float().mean().item()
            seen[f"{split}/{i}"] = {
                "hit_share": valid.float().mean().item(),
                "light_share": light,
                "ldr_mean": float(np.mean(fr["rgbs"]))}
    return seen


def check_exrs(out_dir, n_frames=1, n_levels=6):
    """The maps a bake wrote for its first n_frames frames: the expected
    file names, each finite and >= 0. Returns frame 0's diffuse map's
    mean."""
    import numpy as np

    from iris_tpu_torch.utils.exr import read_exr

    frames = range(n_frames)
    want = {"diffuse": [f"{i:03d}.exr" for i in frames],
            "specular": sorted(f"{i:03d}_{f}_{r}.exr" for i in frames
                               for f in (0, 1) for r in range(n_levels))}
    for sub, names in want.items():
        got = sorted(os.listdir(os.path.join(out_dir, sub)))
        check(got == names, f"{out_dir}/{sub}: files {got}")
        for name in names:
            img = read_exr(os.path.join(out_dir, sub, name))
            check(img.shape == (*STAGE_HW, 3) and bool(
                np.isfinite(img).all()) and float(img.min()) >= 0,
                f"{out_dir}/{sub}/{name}: shape {img.shape}, min "
                f"{float(np.nanmin(img))}")
    return float(read_exr(os.path.join(out_dir, "diffuse",
                                       "000.exr")).mean())


def refine_material(voxel_min, voxel_max, seed, dev):
    """The refine stage's checkpointed material: the production 4 x 16 x
    2^19 row-mode NGP BRDF from `seed`, its coarse level drawn from
    uniform(-1, 1) so that the material varies over the scene (the init
    scale of 1e-4 gives a near-constant field)."""
    import torch

    from iris_tpu_torch.models.brdf import init_ngp_brdf
    from iris_tpu_torch.models.hashgrid import HashGridConfig

    levels, feats = PRODUCTION_GRID["hash_levels"], PRODUCTION_GRID[
        "hash_features"]
    cfg = HashGridConfig(n_levels=levels, n_features=feats,
                         log2_table_size=LOG2_TABLE,
                         per_level_scale=1.3 ** (31.0 / (levels - 1)),
                         row_gather=True)
    ngp = init_ngp_brdf(seed, voxel_min, voxel_max, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    rows = 1 << LOG2_TABLE
    ngp.table[:rows] = torch.rand((rows, feats), generator=gen,
                                  device=dev) * 2 - 1
    return ngp


def shading_cache_stages(label, n_clutter, kernel, orbit, dev, seed):
    """Phase 10 on one dataset: the port's generator writes it, then the
    four stage CLIs run on it through main(argv) on the card, each with
    the launches, rays, wall time and peak memory it took; the hard checks
    of the phase. Returns (stats, what the card-vs-CPU check needs, the
    largest trace of each bake as record_largest_trace keeps it)."""
    import numpy as np
    import torch

    from iris_tpu_torch.data.make_demo_dataset import (
        GT_RADIANCE, make_dataset,
    )
    from iris_tpu_torch.geometry.intersect import kernel_for
    from iris_tpu_torch.pipeline import (
        bake_shading, extract_emitter, refine_shading, slf_bake,
    )
    from iris_tpu_torch.pipeline.common import load_scene, stage_dataset
    from iris_tpu_torch.train.checkpoint import save_pytree

    root = os.path.join(STAGE_DIR, label)
    out = root + "_out"
    for d in (root, out):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    make_dataset(root, img_hw=STAGE_HW, n_train=STAGE_SPLITS[0],
                 n_val=STAGE_SPLITS[1], spp=STAGE_GEN_SPP,
                 indir_depth=STAGE_GEN_DEPTH, n_clutter=n_clutter,
                 seed=seed, orbit=orbit, device=dev)
    torch.cuda.synchronize()
    stats = {"dataset_s": time.perf_counter() - t0}
    mesh, tracer = load_scene("synthetic", root, device=dev)
    check(kernel_for(tracer).__name__ == kernel,
          f"{label} dataset: kernel_for gives "
          f"{kernel_for(tracer).__name__}, not {kernel}")
    seen = frames_seen(tracer, mesh, root)
    stats.update(faces=mesh.n_faces, kernel=kernel, orbit=orbit,
                 frames_seen=seen)
    # every frame sees lit surfaces, and a train frame sees the light
    check(all(v["ldr_mean"] > 0 for v in seen.values())
          and any(v["light_share"] > 0 for k, v in seen.items()
                  if k.startswith("train")),
          f"{label} frames see {seen}")
    n_px = STAGE_HW[0] * STAGE_HW[1]
    args = ["--dataset", "synthetic", "--scene", root, "--ldr_img_dir",
            "ldr", "--device", str(dev)]
    art = ["--slf_path", os.path.join(out, "vslf.npz"), "--emitter_path",
           os.path.join(out, "emitter.npz")]

    # stage 1 twice: the same bits
    stats["slf_bake"] = run_stage(slf_bake.main, args + [
        "--output", out, "--voxel_num", str(STAGE_VOXELS)])
    slf_bake.main(args + ["--output", out + "_again", "--voxel_num",
                          str(STAGE_VOXELS)])
    z1 = np.load(os.path.join(out, "vslf.npz"))
    z2 = np.load(os.path.join(out + "_again", "vslf.npz"))
    for k in z1.files:
        check(np.array_equal(z1[k], z2[k]), f"{label} slf_bake twice: "
              f"{k} differs")
    check(z1["mask"].any() and bool(np.isfinite(z1["radiance"]).all())
          and float(z1["radiance"].max()) > 0,
          f"{label} SLF: {int(z1['mask'].sum())} voxels, radiance max "
          f"{float(z1['radiance'].max())}")
    stats["slf_voxels"] = int(z1["mask"].sum())

    # stage 2, and its per-face mean twice: the same bits
    stats["extract_emitter"] = run_stage(extract_emitter.main, args + [
        "--output", out, "--threshold", "0.99"])
    _, dataset = stage_dataset(argparse.Namespace(
        dataset="synthetic", scene=root, dataset_root=None,
        ldr_img_dir="ldr", res_scale=1.0))
    m1, m2 = (extract_emitter.face_means(tracer, mesh.n_faces, dataset)
              for _ in range(2))
    check(np.array_equal(m1, m2), f"{label} face means differ run to run")
    is_em = np.load(os.path.join(out, "emitter.npz"))["is_emitter"]
    found = np.flatnonzero(is_em).tolist()
    stats["emitter_faces"] = found
    if label == "flagship":
        check(mesh.n_faces - 2 in found and mesh.n_faces - 1 in found
              and len(found) <= 8, f"flagship emitter faces {found}")
    # stage 4's update, with the generator's light in place of a trained
    # radiance, so that the bakes see the light as well as the SLF
    # (extract_emitter writes one zero row where it finds no face)
    ckpt = os.path.join(out, "emitter_ckpt.pkl")
    save_pytree(ckpt, {"radiance": torch.full((max(len(found), 1), 3),
                                              GT_RADIANCE)})
    extract_emitter.main(args + ["--output", out, "--mode", "update",
                                 "--ckpt", ckpt])

    # stage 5
    captured = {}
    with record_largest_trace() as captured["bake_shading"]:
        stats["bake_shading"] = run_stage(
            bake_shading.main, args + art + [
                "--output", os.path.join(out, "bake"), "--max_frames", "1"],
            (bake_shading, "_bake_maps_for_frame"))
    plan = bake_shading.chunk_plan(n_px)
    chunks = sum(c for _, _, c in plan)
    stats["bake_shading"].update(
        chunks=chunks, launches_expected=1 + chunks,
        ms_per_chunk=stats["bake_shading"]["frame_s"] * 1e3 / chunks,
        diffuse_mean=check_exrs(os.path.join(out, "bake")))

    # stage 9-prep, on the production material from the seed
    ngp = refine_material(float(z1["voxel_min"]), float(z1["voxel_max"]),
                          seed, dev)
    mat_ckpt = os.path.join(out, "material.pkl")
    save_pytree(mat_ckpt, {"material": ngp})
    with record_largest_trace() as captured["refine_shading"]:
        stats["refine_shading"] = run_stage(
            refine_shading.main, args + art + [
                "--output", os.path.join(out, "refine"), "--max_frames",
                "1", "--ckpt", mat_ckpt],
            (refine_shading, "refine_frame"))
    depth = 5
    chunks = (-(-n_px // refine_shading.chunk_pixels(n_px, 128))
              + 6 * -(-n_px // refine_shading.chunk_pixels(n_px, 64)))
    stats["refine_shading"].update(
        chunks=chunks, launches_expected=1 + chunks * (1 + depth),
        ms_per_chunk=stats["refine_shading"]["frame_s"] * 1e3 / chunks,
        diffuse_mean=check_exrs(os.path.join(out, "refine")))
    for stage in STAGES:
        check(only_launched(stats[stage]["launches"], kernel),
              f"{label} {stage}: launches {stats[stage]['launches']}, "
              f"only {kernel} expected")
    for stage in STAGE_CAPTURES:
        check(stats[stage]["diffuse_mean"] > 0,
              f"{label} {stage}: the diffuse map is all zero")
        stats[stage]["largest_trace_rays"] = captured[stage]["n"]
    return stats, (mesh, tracer, out, ngp), captured


def det_card_vs_cpu(mesh, tracer, out, ngp, seed):
    """path_tracing_det_diff and path_tracing_det_spec on 1,024 first hits
    of the dataset's first frame, on the card and on the CPU under the
    same samples (spp 4, depth 5), with the stage's SLF and emitter.
    ConstantBRDF: 1e-5 (its roughness 0.45 stays under the cache gate, so
    no path reads the SLF, where an ulp in a direction could move a hit
    into the next voxel); the NGP material: 95% of values within rtol
    2e-3 / atol 1e-4 (bf16 MLP sums, ROADMAP Queue 3)."""
    import functools

    import numpy as np
    import torch

    from iris_tpu_torch.data.datasets import load_dataset
    from iris_tpu_torch.geometry.bvh import build_bvh
    from iris_tpu_torch.geometry.intersect import ray_intersect
    from iris_tpu_torch.models import brdf as B
    from iris_tpu_torch.pipeline.common import load_emitter, load_vslf
    from iris_tpu_torch.render.integrator import (
        path_tracing_det_diff, path_tracing_det_spec,
    )

    dev = tracer.nodes.device
    root = out[: -len("_out")]
    rays = load_dataset("synthetic", root, split="train", img_dir="ldr",
                        load_gt=False).frame(0)["rays"]
    pos, nrm, uv, tri, valid = ray_intersect(
        tracer, torch.from_numpy(rays[:, :3]).to(dev),
        torch.from_numpy(rays[:, 3:6]).to(dev))
    rows = torch.nonzero(valid)[:DET_CHECK_HITS, 0]
    hits = [x[rows].cpu() for x in (pos, nrm, uv, tri)]
    wis = torch.nn.functional.normalize(
        torch.from_numpy(rays[:, 3:6])[rows.cpu()], dim=-1)
    n, depth = rows.shape[0] * DET_CHECK_SPP, 5
    rng = np.random.default_rng(seed)

    def u(*shape):
        return torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))

    samples = {"det_s2": u(n, 2),
               "indirect": {"s1": u(depth, n), "s2": u(depth, n, 2),
                            "s1b": u(depth, n), "s2b": u(depth, n, 2)}}
    const = B.ConstantBRDF(torch.tensor([0.6, 0.5, 0.4]),
                           torch.tensor([0.45]), torch.tensor([0.1]))
    trees = {dev.type: tracer, "cpu": build_bvh(mesh.triangles(),
                                                device="cpu")}
    results = {}
    for d in (dev, torch.device("cpu")):
        slf, _ = load_vslf(os.path.join(out, "vslf.npz"), device=d)
        em = load_emitter(os.path.join(out, "emitter.npz"), mesh, slf=slf,
                          device=d)
        p, nr, uv_, tr_ = (x.to(d) for x in hits)
        smp = move(samples, d)
        for name, mat_fn in (
                ("const", functools.partial(B.constant_brdf_apply,
                                            move(const, d))),
                ("ngp", functools.partial(B.ngp_brdf_apply, move(ngp, d)))):
            with torch.no_grad():
                dif = path_tracing_det_diff(
                    None, trees[d.type], em, mat_fn, p, wis.to(d), nr, uv_,
                    tr_, DET_CHECK_SPP, depth, samples=smp)
                s0, s1 = path_tracing_det_spec(
                    None, trees[d.type], em, mat_fn, 0.412, p, wis.to(d), nr,
                    uv_, tr_, DET_CHECK_SPP, depth, samples=smp)
            results[d.type, name] = [x.cpu().numpy() for x in (dif, s0, s1)]
    report = {}
    for name in ("const", "ngp"):
        card, cpu = results[dev.type, name], results["cpu", name]
        for kind, a, c in zip(("diff", "spec0", "spec1"), card, cpu):
            check(bool(np.isfinite(a).all()) and float(np.abs(c).max()) > 0,
                  f"det {name} {kind}: non-finite or all-zero")
            if name == "const":
                ok = np.allclose(a, c, rtol=1e-5, atol=1e-6)
                share = float(np.isclose(a, c, rtol=1e-5, atol=1e-6).mean())
            else:
                share = float((np.abs(a - c) <= 1e-4 + 2e-3 * np.abs(c))
                              .mean())
                ok = share >= 0.95
            check(ok, f"det {name} {kind} card vs CPU: {share:.4f} close, "
                  f"max |diff| {float(np.abs(a - c).max()):.3e}")
            report[f"{name}_{kind}"] = {
                "share_close": share,
                "max_abs_diff": float(np.abs(a - c).max())}
    return report


def stage_phase(dev, seed):
    """Phase 10 on both datasets, printed; returns the stats by dataset
    and, for each, (label, kernel name, the bakes' largest traces). The datasets and the SLF bakes stay under STAGE_DIR for phase
    11, which removes them."""
    print(f"stages: datasets of {STAGE_HW[0]} x {STAGE_HW[1]} pixels, "
          f"{STAGE_SPLITS[0]} train + {STAGE_SPLITS[1]} val frames (cuts "
          f"of the frame size and frame count), generator spp "
          f"{STAGE_GEN_SPP} depth {STAGE_GEN_DEPTH}; slf_bake at "
          f"{STAGE_VOXELS}^3, bake_shading and refine_shading on one frame "
          f"at the reference's spp and chunk budgets")
    stage_stats, traffic = {}, []
    for label, n_clutter, kernel, orbit in STAGE_DATASETS:
        st, ctx, captured = shading_cache_stages(label, n_clutter, kernel,
                                                 orbit, dev, seed)
        print(f"stages {label}: {st['faces']} faces -> {kernel}; "
              f"{'orbit' if orbit else 'fixed'} cameras; dataset "
              f"written in {st['dataset_s']:.1f} s; frames see "
              + ", ".join(f"{k}: hit {v['hit_share']:.3f}, light "
                          f"{v['light_share']:.4f}, LDR mean "
                          f"{v['ldr_mean']:.3f}"
                          for k, v in st["frames_seen"].items())
              + f"; SLF {st['slf_voxels']} voxels; emitter faces "
              f"{st['emitter_faces']}")
        for stage in STAGES:
            report_stage(label, stage, st[stage])
        if label == "flagship":
            st["det_card_vs_cpu"] = det_card_vs_cpu(*ctx, seed)
            print("det integrators card vs CPU (flagship, 1,024 first "
                  "hits, spp 4, depth 5): " + ", ".join(
                      f"{k} {v['share_close']:.4f} close, max |diff| "
                      f"{v['max_abs_diff']:.3e}"
                      for k, v in st["det_card_vs_cpu"].items()))
        stage_stats[label] = st
        traffic.append((label, kernel, captured))
        del ctx
    return stage_stats, traffic


def hold_stage_traffic(traffic, flush):
    """Each stage kernel on the largest trace of each bake (phase 10) or of
    each trainer's steps (phase 11), as the kernel received it: held
    against its plain version (every ray compared bit-equal;
    trace_paired_streamed on the first STAGE_PLAIN_RAYS rays), timed
    (median of 20, L2 flushed) and bounded from the work this batch needs
    (for trace_union its own walk's tests; for the packet walk the per-ray
    near-first walk's on the whole batch, as roofline says). traffic holds
    (dataset label, kernel name, {stage: record_largest_trace's capture});
    each capture's own tree is the one held. Returns {kernel name:
    [measurement, ...]}, printed."""
    import torch

    from iris_tpu_torch.geometry import cuda_intersect as ci

    held = {}
    for label, name, captured in traffic:
        kernel, plain = getattr(ci, name), getattr(ci, name + "_plain")
        paired = name != "trace_union"
        for stage, cap in captured.items():
            o, d = cap["o"], cap["d"]
            tracer = cap["tracer"]
            n = o.shape[0]
            n_plain = min(n, STAGE_PLAIN_RAYS[name] or n)
            got = kernel(tracer, o, d)
            torch.cuda.synchronize()
            counts = {}
            plain_ms, want = timed_once(lambda: plain(
                tracer, o[:n_plain], d[:n_plain], counts=counts))
            err, same = compare_hits(tuple(x[:n_plain] for x in got), want)
            check(same == n_plain, f"{name} on {label} {stage}'s {n}-ray "
                  f"trace: {same}/{n_plain} rays bit-equal to plain")
            ms = time_ms(lambda: kernel(tracer, o, d), 20, flush)
            need = counts
            if paired:
                need = {}
                ci.trace_paired_plain(tracer, o, d, counts=need)
            bound_ms, bound_by, nbytes, ops = roofline(tracer, need, n,
                                                       paired)
            m = {"dataset": label, "stage": stage, "rays": n, "ms": ms,
                 "plain_ms": plain_ms, "plain_rays": n_plain,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "max_abs_err": err, "bit_equal_rays": same}
            if not paired:
                m.update({k: counts[k] for k in WALK_COUNTS})
            held.setdefault(name, []).append(m)
            print(f"{name} on {label} {stage}'s largest trace ({n} rays, "
                  f"{tracer.n_faces} faces): {ms:.4f} ms (bound "
                  f"{bound_ms:.5f} ms by {bound_by}: {nbytes} B, {ops} FP32 "
                  f"ops from {need['slab']} slab + {need['mt']} triangle "
                  f"tests); plain {plain_ms:.1f} ms on {n_plain} rays, "
                  f"bit-equal {same}/{n_plain}, max |t| error {err:.3e}")
    return held


def report_stage(label, stage, st):
    launched = {k: v for k, v in st["launches"].items() if v}
    extra = ""
    if "chunks" in st:
        extra = (f"; the frame {st['frame_s']:.2f} s, "
                 f"{st['frame_rays_per_s']:.0f} rays/s, {st['chunks']} "
                 f"chunks, {st['ms_per_chunk']:.2f} ms/chunk (the frame's "
                 f"time over its chunks: first hit, denoise and host copies "
                 f"included), launches expected {st['launches_expected']}")
    print(f"stage {label} {stage}: {st['wall_s']:.2f} s, {st['rays']} rays "
          f"in {st['traces']} traces, {st['rays_per_s']:.0f} rays/s; "
          f"launches {launched}; peak memory {st['peak_memory_mb']:.0f} MB"
          + extra)


class time_train_steps:
    """While active, times the steps of run_training on the card, read
    after the run (no host sync inside it): an eager step (the step that
    train.loop.make_train_step makes) between two CUDA events, and a chunk
    that is one CUDA-graph replay (utils.graphs.Graph.replay of a graph
    named "train_chunk", not a validation chunk's) between two events,
    its time split evenly over its K steps (the step inside a
    capture is not timed: it runs nothing then). Keeps the largest
    traversal input of the eager steps alone (record_largest_trace), not
    of the hooks between them. A data-parallel step's collectives are
    counted too (parallel.comms_report.counting): `collectives` holds each
    step's (kind, bytes) list, `groups` the RankGroup of each run."""

    def __enter__(self):
        import contextlib

        import torch

        from iris_tpu_torch.parallel.comms_report import counting
        from iris_tpu_torch.train import loop
        from iris_tpu_torch.utils import graphs

        self._loop, self._make = loop, loop.make_train_step
        make, events = self._make, []
        self.events = events          # (start, end, steps it timed)
        self.collectives, self.groups = [], []
        recorder = record_largest_trace()
        self.captured = recorder.captured

        def bracket(run, k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = run()
            end.record()
            events.append((start, end, k))
            return out

        def make_timed(loss_fn, optimizer, group=None):
            step = make(loss_fn, optimizer, group)
            if group is not None:
                self.groups.append(group)

            def timed(*a, **k):
                if torch.cuda.is_current_stream_capturing():
                    return step(*a, **k)

                def run():
                    with recorder, (counting(group) if group is not None
                                    else contextlib.nullcontext()) as calls:
                        out = step(*a, **k)
                    if group is not None:
                        self.collectives.append(list(calls))
                    return out
                return bracket(run, 1)
            return timed

        class ReplayTimer:
            def captured(self, graph):
                pass

            def replayed(self, graph, seeds, start, end):
                if graph.name == "train_chunk":     # not a validation chunk
                    events.append((start, end, len(graph.generators)))

        loop.make_train_step = make_timed
        self._observing = graphs.observing(ReplayTimer())
        self._observing.__enter__()
        return self

    def __exit__(self, *exc):
        self._loop.make_train_step = self._make
        self._observing.__exit__(*exc)

    def step_ms(self):
        """Milliseconds of each step in order: an eager step's own, a
        replayed chunk's divided over its K steps."""
        import torch

        torch.cuda.synchronize()
        out = []
        for a, b, k in self.events:
            out += [a.elapsed_time(b) / k] * k
        return out

    def graphed_ms(self):
        """Milliseconds a step of each replayed chunk."""
        import torch

        torch.cuda.synchronize()
        return [a.elapsed_time(b) / k for a, b, k in self.events if k > 1]


class time_validation:
    """While active, the validation hooks that a trainer module builds
    (its make_validation_hook) are timed at each validation step, the card
    synchronized before and after."""

    def __init__(self, module):
        self.module = module

    def __enter__(self):
        import torch

        orig = self.orig = self.module.make_validation_hook
        times = self.times = []

        def make(*a, val_step=250, **k):
            hook = orig(*a, val_step=val_step, **k)

            def timed(step, params, loss, aux):
                if step % val_step:
                    return hook(step, params, loss, aux)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                hook(step, params, loss, aux)
                torch.cuda.synchronize()
                times.append((step, time.perf_counter() - t0))
            return timed

        self.module.make_validation_hook = make
        return times

    def __exit__(self, *exc):
        self.module.make_validation_hook = self.orig


def train_log(path):
    """The loss records of a trainer's train_log.jsonl (the scalar log's
    lines; the diag hook's lines carry no loss), wall time dropped."""
    recs = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if "loss" in rec:
                recs.append({k: v for k, v in rec.items() if k != "wall_s"})
    return recs


def same_pickle(a, b):
    """Two checkpoint files hold the same tree, bit for bit."""
    import pickle

    import numpy as np

    def eq(x, y):
        if isinstance(x, np.ndarray):
            return (isinstance(y, np.ndarray) and x.dtype == y.dtype
                    and x.shape == y.shape
                    and x.tobytes() == y.tobytes())
        if isinstance(x, dict):
            return (isinstance(y, dict) and x.keys() == y.keys()
                    and all(eq(x[k], y[k]) for k in x))
        if isinstance(x, (list, tuple)):
            return (isinstance(y, (list, tuple)) and len(x) == len(y)
                    and all(eq(p, q) for p, q in zip(x, y)))
        return x == y

    with open(a, "rb") as f, open(b, "rb") as g:
        return eq(pickle.load(f), pickle.load(g))


def check_checkpoint(label, path, state_path, dev):
    """A trainer's artifact and its full-state file load back onto the card
    with every leaf finite, and the artifact's leaves equal the state's
    params (both were saved from the same final parameters)."""
    import torch

    from iris_tpu_torch.train.checkpoint import load_pytree
    from iris_tpu_torch.train.optim import named_leaves

    art = named_leaves(load_pytree(path, dev))
    st = load_pytree(state_path, dev)
    params = named_leaves(st["params"])
    check(len(art) == len(params) and all(
        n1 == n2 and t1.device.type == dev.type
        and bool(torch.isfinite(t1).all()) and torch.equal(t1, t2)
        for (n1, t1), (n2, t2) in zip(art, params)),
        f"{label}: {path} does not load back equal to {state_path}")
    check(st["opt_state"]["opt"]["state"] != {},
          f"{label}: {state_path} holds no optimizer state")


def check_val_pngs(label, val_dir, steps):
    want = sorted(f"{s:05d}_{n}.png" for s in steps
                  for n in ("L_train", "L_full", "L_gt", "crfs"))
    got = sorted(os.listdir(val_dir))
    check(got == want, f"{label}: validation files {got}, want {want}")


def emitter_radiance_ok(label, bake):
    import numpy as np

    rad = np.load(os.path.join(bake, "emitter.npz"))["emitter_radiance"]
    check(bool(np.isfinite(rad).all()) and float(rad.min()) > 0,
          f"{label}: emitter radiance {rad.tolist()} not finite and > 0")
    return rad.tolist()


def run_trainer(module, argv, n_steps, samples_per_step=None):
    """One trainer CLI's main(argv) through run_stage, with its steps
    timed (time_train_steps: CUDA events around each eager step and each
    graph replay of a chunk; ms a step = the median of the steps after the
    first chunk, which are replays at chunk_steps > 1; eager_ms_per_step
    the first chunk's median), its validation renders timed, and the
    largest traversal input of its eager steps kept."""
    with time_train_steps() as steps, time_validation(module) as val:
        st = run_stage(module.main, argv)
    ms = steps.step_ms()
    check(len(ms) == n_steps, f"{module.__name__}: {len(ms)} steps timed, "
          f"{n_steps} expected")
    after = ms[PIPE_CHUNK:] or ms
    st.update(steps=len(ms), ms_per_step=statistics.median(after),
              step_ms=ms, val_render_s=val, replays=len(steps.graphed_ms()),
              eager_ms_per_step=statistics.median(ms[:PIPE_CHUNK]))
    if samples_per_step:
        st["camera_samples_per_s"] = samples_per_step / (
            st["ms_per_step"] / 1e3)
    return st, steps.captured


def pipeline_chain(label, kernel, root, bake, dev, resume_check):
    """Phase 11 on one dataset: the training half of the pipeline and the
    render CLI in scripts/run_pipeline.sh's order, each through main(argv)
    on the card. Runs in the chain's own directory (the CLIs write
    outputs/<experiment>/ and checkpoints/<experiment>/ relative to it),
    `bake` holding phase 10's SLF (stage 1); stage 2 runs again here, so
    that the emitter starts from the extracted zero radiance as in a
    capture. Returns (stats by CLI, {trainer: its steps' largest
    trace})."""
    import numpy as np

    from iris_tpu_torch.pipeline import (
        bake_shading, extract_emitter, initialize, refine_shading, render,
        slf_refine, train_brdf_crf, train_emitter,
    )

    stats, captured = {}, {}
    common = ["--dataset", "synthetic", "--scene", root, "--ldr_img_dir",
              "ldr", "--device", str(dev)]
    train = (["--dataset", "synthetic", root, "--ldr_img_dir", "ldr",
              "--device", str(dev), "--crf_basis", "3", "--has_part", "1",
              "--batch_size", str(PIPE_BATCH), "--chunk_steps",
              str(PIPE_CHUNK),
              "--val_step", str(PIPE_CHUNK), "--save_every",
              str(PIPE_CHUNK), "--hash_levels",
              str(PRODUCTION_GRID["hash_levels"]), "--hash_features",
              str(PRODUCTION_GRID["hash_features"]), "--log2_hashmap_size",
              str(LOG2_TABLE)])
    render_spp = ["--SPP", str(PIPE_SPP), "--spp", str(TRAIN_SPP)]
    brdf_loss = ["--lp", "0.005", "--la", "0.01", "--l_crf_weight", "0.001"]
    vslf, vslf0, emitter = (os.path.join(bake, n) for n in (
        "vslf.npz", "vslf_0.npz", "emitter.npz"))
    rounds = PIPE_SPP // TRAIN_SPP
    camera_samples = PIPE_BATCH * TRAIN_SPP * rounds
    val_chunks = -(-STAGE_HW[0] * STAGE_HW[1] // 8192)
    n_val = PIPE_STEPS // PIPE_CHUNK
    val_launches = n_val * val_chunks * (2 + 2 + INDIR_DEPTH)
    val_steps = range(0, PIPE_STEPS, PIPE_CHUNK)

    # 2. the emitter mask (zero radiance)
    extract_emitter.main(common + ["--output", bake, "--threshold", "0.99"])
    # 3. initialize
    init_args = train + render_spp + [
        "--voxel_path", vslf, "--emitter_path", emitter]
    steps = ["--max_steps", str(PIPE_STEPS)]
    stats["initialize"], captured["initialize"] = run_trainer(
        initialize, init_args + steps + ["--experiment_name", "init"],
        PIPE_STEPS, camera_samples)
    stats["initialize"]["launches_expected"] = (
        PIPE_STEPS * (2 * rounds + 1) + val_launches + val_chunks)
    if resume_check:
        # the same 20 steps as 10, then --resume to 20: the same losses
        # and the same checkpoint bits
        initialize.main(init_args + ["--max_steps", str(PIPE_STEPS // 2),
                                     "--experiment_name", "init_rs"])
        initialize.main(init_args + steps + ["--experiment_name", "init_rs",
                                             "--resume"])
        a, b = (train_log(os.path.join("outputs", e, "train_log.jsonl"))
                for e in ("init", "init_rs"))
        check(a == b, f"{label} initialize resumed at {PIPE_STEPS // 2}: "
              f"losses {b} differ from the uninterrupted run's {a}")
        for f in ("last.pkl", "last_state.pkl"):
            check(same_pickle(os.path.join("checkpoints", "init", f),
                              os.path.join("checkpoints", "init_rs", f)),
                  f"{label} initialize resumed: {f} differs from the "
                  "uninterrupted run's")
        stats["initialize"]["resume_same_bits"] = True
    # 4. the learned radiance into emitter.npz
    extract_emitter.main(common + ["--output", bake, "--mode", "update",
                                   "--ckpt", "checkpoints/init/last.pkl"])
    stats["emitter_after_initialize"] = emitter_radiance_ok(label, bake)
    # 5. the shading caches of both train frames
    stats["bake_shading"] = run_stage(bake_shading.main, common + [
        "--slf_path", vslf, "--emitter_path", emitter, "--output",
        "shading"])
    n_px = STAGE_HW[0] * STAGE_HW[1]
    chunks = sum(c for _, _, c in bake_shading.chunk_plan(n_px))
    stats["bake_shading"]["launches_expected"] = STAGE_SPLITS[0] * (
        1 + chunks)
    # 6. brdf0
    brdf = train + steps + brdf_loss + [
        "--ckpt_path", "checkpoints/init/last.pkl", "--emitter_path",
        emitter]
    stats["train_brdf_crf"], captured["train_brdf_crf"] = run_trainer(
        train_brdf_crf, brdf + ["--experiment_name", "brdf0",
                                "--voxel_path", vslf, "--cache_dir",
                                "shading"], PIPE_STEPS)
    stats["train_brdf_crf"]["launches_expected"] = (
        PIPE_STEPS + val_launches + val_chunks)
    # 7. the SLF again with the learned CRF, twice: the same bits
    refine = common + ["--output", bake, "--ckpt",
                       "checkpoints/brdf0/last.pkl", "--crf_basis", "3"]
    stats["slf_refine"] = run_stage(slf_refine.main, refine)
    stats["slf_refine"]["launches_expected"] = STAGE_SPLITS[0]
    slf_refine.main(refine + ["--save", "vslf_0_again.npz"])
    z1, z2 = (np.load(os.path.join(bake, n)) for n in (
        "vslf_0.npz", "vslf_0_again.npz"))
    check(z1.files == z2.files and all(
        np.array_equal(z1[k], z2[k]) for k in z1.files),
        f"{label} slf_refine twice: the bits differ")
    check(bool(np.isfinite(z1["radiance"]).all())
          and float(z1["radiance"].max()) > 0,
          f"{label} slf_refine: radiance max {float(z1['radiance'].max())}")
    # 8. the emitter
    stats["train_emitter"], captured["train_emitter"] = run_trainer(
        train_emitter, train + steps + render_spp + [
            "--experiment_name", "emitter", "--ckpt_path",
            "checkpoints/brdf0/last.pkl", "--voxel_path", vslf0,
            "--emitter_path", emitter], PIPE_STEPS, camera_samples)
    stats["train_emitter"]["launches_expected"] = (
        PIPE_STEPS * 2 * rounds + val_launches)
    extract_emitter.main(common + [
        "--output", bake, "--mode", "update", "--ckpt",
        "checkpoints/emitter/emitter_last.pkl"])
    stats["emitter_after_train_emitter"] = emitter_radiance_ok(label, bake)
    # 9. the shading caches again with brdf0, stochastic encode, then brdf1
    stats["refine_shading"] = run_stage(
        refine_shading.main, common + [
            "--slf_path", vslf0, "--emitter_path", emitter, "--ckpt",
            "checkpoints/brdf0/last.pkl", "--output", "shading_1",
            "--spp_diffuse", "128", "--spp_specular", "64", "--indir_depth",
            str(INDIR_DEPTH), "--encode", "stoch"],
        (refine_shading, "refine_frame"))
    chunks = (-(-n_px // refine_shading.chunk_pixels(n_px, 128))
              + 6 * -(-n_px // refine_shading.chunk_pixels(n_px, 64)))
    stats["refine_shading"].update(
        launches_expected=STAGE_SPLITS[0] * (1 + chunks * (1 + INDIR_DEPTH)),
        s_per_frame=stats["refine_shading"]["frame_s"] / STAGE_SPLITS[0])
    for d in ("shading", "shading_1"):
        check(check_exrs(d, STAGE_SPLITS[0]) > 0,
              f"{label} {d}: the diffuse map is all zero")
    stats["brdf1"], _ = run_trainer(
        train_brdf_crf, brdf + ["--experiment_name", "brdf1",
                                "--voxel_path", vslf0, "--cache_dir",
                                "shading_1"], PIPE_STEPS)
    stats["brdf1"]["launches_expected"] = stats["train_brdf_crf"][
        "launches_expected"]
    # 10. render a val frame with brdf1
    stats["render"] = run_stage(render.main, train + render_spp + [
        "--experiment_name", "brdf1", "--emitter_path", bake,
        "--output_path", "render", "--split", "val", "--max_frames", "1"])
    stats["render"]["launches_expected"] = rounds * (2 + INDIR_DEPTH + 1)
    stats["render"].update(render_outputs("render"))

    for name, sub, art, st_file in (
            ("initialize", "init", "last.pkl", "last_state.pkl"),
            ("train_brdf_crf", "brdf0", "last.pkl", "last_state.pkl"),
            ("train_emitter", "emitter", "emitter_last.pkl",
             "emitter_last_state.pkl"),
            ("brdf1", "brdf1", "last.pkl", "last_state.pkl")):
        recs = train_log(os.path.join("outputs", sub, "train_log.jsonl"))
        check(len(recs) == PIPE_STEPS and all(
            np.isfinite(v) for r in recs for k, v in r.items()
            if k != "step"), f"{label} {name}: logged losses {recs}")
        stats[name]["first_loss"], stats[name]["last_loss"] = (
            recs[0]["loss"], recs[-1]["loss"])
        check_checkpoint(f"{label} {name}", os.path.join(
            "checkpoints", sub, art), os.path.join("checkpoints", sub,
                                                   st_file), dev)
        check_val_pngs(f"{label} {name}", os.path.join("outputs", sub, "val"),
                       val_steps)
    for name in PIPE_CLIS:
        st = stats[name]
        check(only_launched(st["launches"], kernel)
              and st["launches"][kernel] == st["launches_expected"],
              f"{label} {name}: launches {st['launches']}, "
              f"{st['launches_expected']} of {kernel} alone expected")
    return stats, captured


def render_outputs(out):
    """render.main's files for val frame 0, each under its JAX name, and
    metrics.txt's PSNR and SSIM, finite."""
    import numpy as np

    want = {"rgb": ["00000_rgb_full.exr", "00000_rgb_full.png",
                    "metrics.txt"],
            "diffuse": ["00000_diffuse.exr", "00000_diffuse.png"],
            "a_prime": ["00000_a_prime.exr", "00000_a_prime.png"],
            "roughness": ["00000_roughness.exr",
                          "00000_roughness_color.png"],
            "metallic": ["00000_metallic.exr", "00000_metallic_color.png"],
            "emission": ["00000.png", "00000_emission.exr"],
            "slf": ["00000_slf.exr"], "merge": ["00000_merge.png"]}
    for sub, names in want.items():
        got = sorted(os.listdir(os.path.join(out, "val", sub)))
        check(got == sorted(names), f"render {sub}: files {got}")
    with open(os.path.join(out, "val", "rgb", "metrics.txt")) as f:
        lines = f.read().splitlines()
    check(lines[0] == "Name, PSNR, SSIM" and len(lines) == 3,
          f"metrics.txt: {lines}")
    p, q = (float(x) for x in lines[1].split(",")[1:])
    pm, qm = (float(x) for x in lines[2].split(",")[1:])
    check(all(np.isfinite(v) for v in (p, q, pm, qm)),
          f"metrics.txt: {lines}")
    return {"psnr": p, "ssim": q}


def report_pipeline(label, stats):
    for name in PIPE_CLIS:
        st = stats[name]
        launched = {k: v for k, v in st["launches"].items() if v}
        extra = ""
        if "ms_per_step" in st:
            extra += (f"; {st['steps']} steps, {st['ms_per_step']:.2f} "
                      f"ms/step (median after the first chunk, "
                      f"{st['replays']} graph replays; the eager first "
                      f"chunk {st['eager_ms_per_step']:.2f}), loss "
                      f"{st['first_loss']:.6f} -> {st['last_loss']:.6f}, "
                      f"validation renders "
                      + ", ".join(f"step {s}: {t:.2f} s"
                                  for s, t in st["val_render_s"]))
        if "camera_samples_per_s" in st:
            extra += (f", {st['camera_samples_per_s']:.0f} camera "
                      "samples/s")
        if "psnr" in st:
            extra += f"; PSNR {st['psnr']:.3f}, SSIM {st['ssim']:.4f}"
        if "s_per_frame" in st:
            extra += f"; {st['s_per_frame']:.2f} s a frame"
        print(f"pipeline {label} {name}: {st['wall_s']:.2f} s, "
              f"launches {launched} (expected {st['launches_expected']}), "
              f"peak memory {st['peak_memory_mb']:.0f} MB" + extra)
    print(f"pipeline {label}: emitter radiance after initialize "
          f"{stats['emitter_after_initialize']}, after train_emitter "
          f"{stats['emitter_after_train_emitter']}"
          + ("; initialize resumed at step "
             f"{PIPE_STEPS // 2}: the same losses and checkpoint bits"
             if stats["initialize"].get("resume_same_bits") else "")
          + "; slf_refine twice: the same bits")


def pipeline_phase(dev, seed, new_datasets=True):
    """Phase 11 on both datasets, printed: the chain on phase 10's
    datasets and SLF bakes, or with new_datasets on new ones with their
    SLF baked here (--pipeline-only). Returns the stats by dataset and the
    trainers' traffic for hold_stage_traffic. The work directories stay
    under STAGE_DIR for phase 14."""
    from iris_tpu_torch.pipeline import slf_bake

    print(f"pipeline: the training stages and the render CLI on the "
          f"{STAGE_HW[0]} x {STAGE_HW[1]} datasets, batch {PIPE_BATCH}, SPP "
          f"{PIPE_SPP}, spp {TRAIN_SPP}, {PIPE_STEPS} steps a trainer in "
          f"chunks of {PIPE_CHUNK} (validation and a checkpoint every "
          f"{PIPE_CHUNK}), the 4 x 16 x 2^19 row-mode grid")
    stats, traffic = {}, []
    for label, n_clutter, kernel, orbit in STAGE_DATASETS:
        root = os.path.join(STAGE_DIR, label)
        slf_dir = root + "_out"
        if new_datasets:
            from iris_tpu_torch.data.make_demo_dataset import make_dataset

            shutil.rmtree(root, ignore_errors=True)
            make_dataset(root, img_hw=STAGE_HW, n_train=STAGE_SPLITS[0],
                         n_val=STAGE_SPLITS[1], spp=STAGE_GEN_SPP,
                         indir_depth=STAGE_GEN_DEPTH, n_clutter=n_clutter,
                         seed=seed, orbit=orbit, device=dev)
            slf_bake.main(["--dataset", "synthetic", "--scene", root,
                           "--ldr_img_dir", "ldr", "--device", str(dev),
                           "--output", slf_dir, "--voxel_num",
                           str(STAGE_VOXELS)])
        work = os.path.abspath(os.path.join(STAGE_DIR, label + "_pipeline"))
        shutil.rmtree(work, ignore_errors=True)
        bake = os.path.join(work, "bake")
        os.makedirs(bake)
        shutil.copy(os.path.join(slf_dir, "vslf.npz"), bake)
        here = os.getcwd()
        t0 = time.perf_counter()
        os.chdir(work)
        try:
            st, captured = pipeline_chain(label, kernel, os.path.abspath(
                os.path.join(here, root)), bake, dev,
                resume_check=label == "flagship")
        finally:
            os.chdir(here)
        st["total_s"] = time.perf_counter() - t0
        report_pipeline(label, st)
        print(f"pipeline {label}: {st['total_s']:.1f} s in all")
        stats[label] = st
        traffic.append((label, kernel, captured))
    return stats, traffic


class watch_updates:
    """While active, every optimizer update (train.optim.Optimizer.update)
    is watched on the device, with no host sync: with digests, after it,
    one int64 digest of each parameter leaf's bits
    (parallel.distributed.bits_digest; `digests()`, one list a step); with
    masks, before it, the gradient rule of tests/torch_parity.
    jax_noise_bound is applied to its gradients (`bound`: entries nonzero
    and below 0.15 of their leaf's largest at some step; `touched`:
    nonzero at some step) and the starting leaves are kept (`start`).
    Either adds about a millisecond of device work to a step."""

    def __init__(self, digests=False, masks=False):
        self.want_digests, self.masks = digests, masks

    def __enter__(self):
        import torch

        from iris_tpu_torch.parallel.distributed import bits_digest
        from iris_tpu_torch.train import optim

        self._cls, self._update = optim.Optimizer, optim.Optimizer.update
        real = self._update
        self._digests, self.bound, self.touched, self.start = [], {}, {}, {}
        watch = self

        def update(opt, params, grads, opt_state):
            leaves = optim.named_leaves(params)
            if watch.masks:
                if not watch.start:
                    watch.start = {n: t.detach().clone() for n, t in leaves}
                for n, g in grads.items():
                    a = g.abs()
                    weak = (a > 0) & (a < 0.15 * a.max())
                    watch.bound[n] = watch.bound.get(n, False) | weak
                    watch.touched[n] = watch.touched.get(n, False) | (a > 0)
            real(opt, params, grads, opt_state)
            if watch.want_digests:
                watch._digests.append(torch.cat(
                    [bits_digest(t) for _, t in leaves]))

        optim.Optimizer.update = update
        return self

    def __exit__(self, *exc):
        self._cls.update = self._update

    def digests(self):
        return [d.tolist() for d in self._digests]


def hold_adam_leaves(label, got, ref, start, bound, touched, lr_sum):
    """tests/torch_parity.hold_leaves, the rule the CLI parity tests hold
    Adam's leaves to, here with the one-rank run's gradients in place of
    the JAX package's: every entry that is not noise-bound within rtol
    1e-4 / atol 2e-4 but 0.5% of the reached ones; >= 80% of the
    noise-bound ones within it; none further than 2 * sum(lr); the firm
    entries' movement at cosine >= 0.99."""
    import numpy as np

    for name, g in got.items():
        r = ref[name]
        weak = bound[name].reshape(g.shape)
        reached = touched[name].reshape(g.shape)
        close = np.isclose(g, r, rtol=1e-4, atol=2e-4)
        off = int((~weak & ~close).sum())
        check(off <= 0.005 * reached.sum(),
              f"{label} {name}: {off} firm entries off of "
              f"{int(reached.sum())} reached")
        frac = float(close[weak].mean()) if weak.any() else 1.0
        check(frac >= 0.8, f"{label} {name}: {frac:.3f} of the noise-bound "
              "entries close")
        check(float(np.abs(g - r).max()) <= 2 * lr_sum,
              f"{label} {name}: max |diff| {np.abs(g - r).max():.3e} past "
              f"2 * sum(lr) = {2 * lr_sum}")
        firm = reached & ~weak
        moved = (r - start[name])[firm]
        if np.abs(moved).max(initial=0) > 0:
            a = (g - start[name])[firm].astype(np.float64)
            b = moved.astype(np.float64)
            cos = float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b),
                                    1e-300))
            check(cos >= 0.99, f"{label} {name}: movement cosine {cos:.5f}")


def parallel_rank(i, argv, out_path):
    """Rank 1 of phase 16's two-rank run, in a spawned process: the
    initialize CLI with the rank's flags, its parameters' digest kept after
    every step and written to out_path."""
    from iris_tpu_torch.pipeline import initialize

    with watch_updates(digests=True) as w:
        initialize.main(argv)
    with open(out_path, "w") as f:
        json.dump({"digests": w.digests()}, f)


def parallel_run(label, argv, n_steps, **watch):
    """One initialize run through run_stage with its steps timed and its
    updates watched (watch_updates(**watch)): (stats, watch_updates,
    time_train_steps of the run)."""
    from iris_tpu_torch.pipeline import initialize

    with watch_updates(**watch) as w, time_train_steps() as steps:
        st = run_stage(initialize.main, argv)
    ms = steps.step_ms()
    check(len(ms) == n_steps, f"{label}: {len(ms)} steps timed, {n_steps} "
          "expected")
    st.update(steps=n_steps, step_ms=ms, ms_per_step=statistics.median(
        ms[1:]))
    st["launches_per_step"] = {k: v / n_steps
                               for k, v in st["launches"].items() if v}
    print(f"parallel {label}: {n_steps} steps, {st['ms_per_step']:.2f} "
          f"ms/step (median after the first), step ms "
          f"{[round(x, 2) for x in ms]}, launches {st['launches']}, "
          f"peak memory {st['peak_memory_mb']:.0f} MB")
    return st, w, steps


def parallel_chain(label, kernel, root, bake, dev):
    """Phase 16 on one dataset, in its own directory: the initialize CLI at
    phase 11's settings for PAR_STEPS steps with no group, as one NCCL rank
    and as two gloo ranks sharing the card (this process rank 0, a spawned
    one rank 1), with the hard checks of the data-parallel path."""
    import torch

    from iris_tpu_torch.parallel.comms_report import summarize
    from iris_tpu_torch.train.checkpoint import load_pytree
    from iris_tpu_torch.train.optim import named_leaves

    argv = ["--dataset", "synthetic", root, "--ldr_img_dir", "ldr",
            "--crf_basis", "3", "--has_part", "1",
            "--batch_size", str(PIPE_BATCH), "--chunk_steps", "1",
            "--val_step", str(PAR_STEPS), "--save_every", str(PAR_STEPS),
            "--hash_levels", str(PRODUCTION_GRID["hash_levels"]),
            "--hash_features", str(PRODUCTION_GRID["hash_features"]),
            "--log2_hashmap_size", str(LOG2_TABLE),
            "--SPP", str(PIPE_SPP), "--spp", str(TRAIN_SPP),
            "--voxel_path", os.path.join(bake, "vslf.npz"),
            "--emitter_path", os.path.join(bake, "emitter.npz"),
            "--max_steps", str(PAR_STEPS)]
    on = f"{dev.type}:0" if dev.type == "cuda" else str(dev)
    stats = {}
    # no group
    stats["no_group"], one, _ = parallel_run(
        f"{label} no group", argv + ["--experiment_name", "one", "--device",
                                     str(dev)], PAR_STEPS, masks=True)
    # one NCCL rank on the card: the NCCL path, the bits of no group
    rv = os.path.abspath("rendezvous")
    stats["nccl_1"], _, st = parallel_run(
        f"{label} one NCCL rank", argv + [
            "--experiment_name", "nccl", "--device", on,
            "--coordinator", f"file://{rv}_nccl", "--num_processes", "1",
            "--process_id", "0"], PAR_STEPS)
    want = "nccl" if dev.type == "cuda" else "gloo"
    check(len(st.groups) == 1 and st.groups[0].backend == want,
          f"{label}: one {want} rank ran on "
          f"{[g.backend for g in st.groups]}")
    a, b = (train_log(os.path.join("outputs", e, "train_log.jsonl"))
            for e in ("one", "nccl"))
    check([r["loss"] for r in a] == [r["loss"] for r in b],
          f"{label}: one NCCL rank's losses {b} are not no group's {a}")
    # two gloo ranks on cuda:0
    rank = ["--experiment_name", "two", "--device", on,
            "--coordinator", f"file://{rv}_gloo", "--num_processes", "2",
            "--dist_backend", "gloo"]
    digests_1 = os.path.abspath("rank1.json")
    child = torch.multiprocessing.start_processes(
        parallel_rank, args=(argv + rank + ["--process_id", "1"],
                             digests_1),
        nprocs=1, join=False, start_method="spawn")
    try:
        stats["gloo_2"], w0, st = parallel_run(
            f"{label} two gloo ranks (rank 0)",
            argv + rank + ["--process_id", "0"], PAR_STEPS, digests=True)
        while not child.join():
            pass
    finally:
        for p in child.processes:
            if p.is_alive():
                p.terminate()
    with open(digests_1) as f:
        w1 = json.load(f)["digests"]
    group = st.groups[0]
    stats["gloo_2"]["backend"] = group.backend
    w0 = w0.digests()
    check(len(w0) == PAR_STEPS and w0 == w1,
          f"{label}: the two ranks' parameters differ after a step")
    two = train_log(os.path.join("outputs", "two", "train_log.jsonl"))
    check(len(two) == PAR_STEPS and [r["step"] for r in two]
          == list(range(PAR_STEPS)), f"{label}: two ranks logged {two}")
    rel = [abs(x["loss"] - y["loss"]) / abs(y["loss"])
           for x, y in zip(two, a)]
    check(max(rel) <= 1e-4, f"{label}: two ranks' losses {two} against "
          f"one rank's {a}: relative {rel}")
    for e in ("one", "two"):
        got = (sorted(os.listdir(os.path.join("checkpoints", e))),
               sorted(os.listdir(os.path.join("outputs", e))))
        check(got == (["last.pkl", "last_state.pkl"],
                      ["train_log.jsonl", "val"]),
              f"{label} {e}: wrote {got}")
        check(len(os.listdir(os.path.join("outputs", e, "val"))) == 4,
              f"{label} {e}: validation files "
              f"{os.listdir(os.path.join('outputs', e, 'val'))}")
    final = {e: {n: t.numpy() for n, t in named_leaves(load_pytree(
        os.path.join("checkpoints", e, "last.pkl"), "cpu"))}
        for e in ("one", "two")}
    lr_sum = PAR_STEPS * 1e-3
    hold_adam_leaves(f"{label} two ranks", final["two"], final["one"],
                     {n: t.cpu().numpy() for n, t in one.start.items()},
                     {n: m.cpu().numpy() for n, m in one.bound.items()},
                     {n: m.cpu().numpy() for n, m in one.touched.items()},
                     lr_sum)
    # what each step sent: the gradient all-reduce (the parameter bytes)
    # and one all-gather of the loss's per-ray rows
    params = load_pytree(os.path.join("checkpoints", "two", "last.pkl"),
                         "cpu")
    param_bytes = sum(t.numel() * t.element_size()
                      for _, t in named_leaves(params))
    gathered = 4 * PIPE_BATCH * PAR_GATHERED
    sent = [summarize(c)["bytes_by_kind"] for c in st.collectives]
    check(len(sent) == PAR_STEPS and all(
        k == {"all_reduce": param_bytes, "all_gather": gathered}
        for k in sent), f"{label}: a step sent {sent}, expected "
        f"{param_bytes} B of all-reduce and {gathered} B of all-gather")
    stats["gloo_2"].update(allreduce_bytes_per_step=param_bytes,
                           gather_bytes_per_step=gathered,
                           max_rel_loss_diff=max(rel),
                           losses_two=[r["loss"] for r in two],
                           losses_one=[r["loss"] for r in a])
    for st_run in stats.values():
        check(only_launched(st_run["launches"], kernel),
              f"{label}: launches {st_run['launches']}, {kernel} alone "
              "expected")
    print(f"parallel {label}: ms/step no group "
          f"{stats['no_group']['ms_per_step']:.2f}, one NCCL rank "
          f"{stats['nccl_1']['ms_per_step']:.2f}, two gloo ranks on one card "
          f"{stats['gloo_2']['ms_per_step']:.2f} (rank 0; not a scaling "
          "figure: both ranks share one card, and gloo moves the "
          f"{param_bytes} B of gradients over TCP on one host); backend "
          f"{group.backend}; a step sends {param_bytes} B of all-reduce and "
          f"{gathered} B of all-gather; rank 0's launches a step (the "
          "step-0 validation render spread over the steps) "
          f"{stats['gloo_2']['launches_per_step']}; losses two ranks vs one "
          f"within {max(rel):.2e} relative; the ranks' parameters the same "
          "bits after every step; the final leaves held to one rank's by "
          "the Adam rule; card "
          + card_line())
    return stats


def parallel_phase(dev, seed, new_datasets=False):
    """Phase 16 on both datasets, printed: on phase 11's datasets and
    bakes, or with new_datasets (--parallel-only) on new ones with their
    SLF and emitter mask made here. Returns the stats by dataset."""
    from iris_tpu_torch.pipeline import extract_emitter, slf_bake

    print(f"parallel: initialize data-parallel on the {STAGE_HW[0]} x "
          f"{STAGE_HW[1]} datasets, batch {PIPE_BATCH}, SPP {PIPE_SPP}, spp "
          f"{TRAIN_SPP}, {PAR_STEPS} steps; no group, one NCCL rank, and "
          "two gloo ranks on cuda:0 (NCCL refuses two ranks on one card)")
    stats = {}
    for label, n_clutter, kernel, orbit in STAGE_DATASETS:
        root = os.path.abspath(os.path.join(STAGE_DIR, label))
        bake = os.path.abspath(os.path.join(STAGE_DIR, label + "_pipeline",
                                            "bake"))
        if new_datasets:
            from iris_tpu_torch.data.make_demo_dataset import make_dataset

            shutil.rmtree(root, ignore_errors=True)
            make_dataset(root, img_hw=STAGE_HW, n_train=STAGE_SPLITS[0],
                         n_val=STAGE_SPLITS[1], spp=STAGE_GEN_SPP,
                         indir_depth=STAGE_GEN_DEPTH, n_clutter=n_clutter,
                         seed=seed, orbit=orbit, device=dev)
            common = ["--dataset", "synthetic", "--scene", root,
                      "--ldr_img_dir", "ldr", "--device", str(dev),
                      "--output", bake]
            slf_bake.main(common + ["--voxel_num", str(STAGE_VOXELS)])
            extract_emitter.main(common + ["--threshold", "0.99"])
        work = os.path.abspath(os.path.join(PAR_DIR, label))
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        here = os.getcwd()
        t0 = time.perf_counter()
        os.chdir(work)
        try:
            st = parallel_chain(label, kernel, root, bake, dev)
        finally:
            os.chdir(here)
        st["total_s"] = time.perf_counter() - t0
        print(f"parallel {label}: {st['total_s']:.1f} s in all")
        stats[label] = st
    shutil.rmtree(PAR_DIR, ignore_errors=True)
    return stats


class watch_relight:
    """While active, a render_relight run is watched: each round (a call
    of the unit make_relight_round makes: the eager warm-up, the capture
    with its first replay, then replays) bracketed by CUDA events, every
    BVH build counted, the scene it builds kept, and every frame it saves
    kept with its statistics."""

    def __enter__(self):
        import numpy as np
        import torch

        from iris_tpu_torch.pipeline import render_relight
        from iris_tpu_torch.render import relight

        self._saved = [(render_relight, n) for n in (
            "make_relight_round", "build_relight_scene", "save_image")]
        self._saved.append((relight, "build_bvh"))
        self._orig = [getattr(m, n) for m, n in self._saved]
        make_round, build_scene, save, build_bvh = self._orig
        self.events, self.builds, self.frames, self.scenes = [], [], [], []

        def timed(*a, **k):
            unit = make_round(*a, **k)

            def round_(*args, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = unit(*args, **kw)
                end.record()
                self.events.append((start, end))
                return out
            return round_

        def keep_scene(*a, **k):
            scene = build_scene(*a, **k)
            self.scenes.append(scene)
            return scene

        def keep_frame(img, path, **k):
            self.frames.append(np.asarray(img, np.float32).copy())
            return save(img, path, **k)

        def counted(tris, **k):
            self.builds.append(len(tris))
            return build_bvh(tris, **k)

        for (m, n), f in zip(self._saved, (timed, keep_scene, keep_frame,
                                           counted)):
            setattr(m, n, f)
        return self

    def __exit__(self, *exc):
        for (m, n), f in zip(self._saved, self._orig):
            setattr(m, n, f)

    def round_ms(self):
        """Each round's ms; the first two hold the warm-up and the
        capture."""
        import torch

        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def relight_yamls(work, emitter_ply):
    """The phase's two written configs: relight_1-shaped (the emitter swap
    onto `emitter_ply` with the radiance of
    scripts/relight/scannetpp/bathroom2/insert.yaml:39, and the disco_ball
    block of scannetpp/bathroom2/relight_1.yaml placed inside the room,
    D = 7) and insert-shaped (an OBJ written here, inserted twice: Au
    conductor and roughconductor, D = 7, tests/test_relight_configs.py's
    shape). Returns {name: path}."""
    obj = os.path.join(work, "asset.obj")
    with open(obj, "w") as f:      # an octahedron
        f.write("v 1 0 0\nv -1 0 0\nv 0 1 0\nv 0 -1 0\nv 0 0 1\nv 0 0 -1\n"
                "f 1 3 5\nf 3 2 5\nf 2 4 5\nf 4 1 5\n"
                "f 3 1 6\nf 2 3 6\nf 4 2 6\nf 1 4 6\n")
    main = ("type: scene\nIntegrator: {type: path, max_depth: 7}\n"
            "main_scene:\n  type: ply\n  filename: ''\n  bsdf:\n"
            "    type: twosided\n    fipt_bsdf: {type: fipt}\n")
    relight_1 = main + f"""new_emitter:
  type: ply
  filename: {emitter_ply}
  bsdf: {{type: diffuse, reflectance: {{type: rgb, value: [0, 0, 0]}}}}
  emitter:
    type: area
    radiance: {{type: rgb, value: {RELIGHT_SWAP_RADIANCE}}}
disco_ball:
  T: 60
  position: {list(RELIGHT_DISCO_POSITION)}
  radius: 0.2
  light_intensity: 40
  light_num: 40
  light_radius_rate: 0.1
  spot_intensity: 0.5
  spot_cutoff_angle: 20.0
"""
    insert = main + f"""light_ball:
  type: sphere
  to_world:
  - {{type: translate, value: [0.6, 0.6, 1.2]}}
  - {{type: scale, value: [0.1, 0.1, 0.1]}}
  bsdf: {{type: diffuse, reflectance: {{type: rgb, value: [0, 0, 0]}}}}
  emitter: {{type: area, radiance: {{type: rgb, value: [25, 25, 25]}}}}
spot:
  type: obj
  filename: {obj}
  to_world:
  - {{type: translate, value: [1.3, 1.2, 0.25]}}
  - {{type: scale, value: [0.2, 0.2, 0.2]}}
  - {{type: rotate, axis: [0, 0, 1], angle: -90}}
  bsdf: {{type: conductor, material: Au}}
andersen:
  type: obj
  filename: {obj}
  to_world:
  - {{type: translate, value: [0.5, 1.3, 0.25]}}
  - {{type: scale, value: [0.2, 0.2, 0.2]}}
  bsdf:
    type: roughconductor
    alpha_u: 0.05
    alpha_v: 0.3
    eta: {{type: rgb, value: [0.47, 0.35, 0.29]}}
    k: {{type: rgb, value: [0.332, 0.239, 0.235]}}
"""
    paths = {}
    for name, body in (("relight_1", relight_1), ("insert", insert)):
        paths[name] = os.path.join(work, f"{name}.yaml")
        with open(paths[name], "w") as f:
            f.write(body)
    return paths


class keep_videos:
    """While active, keeps the frames that module.write_video is given:
    {the video's file name: its frames}."""

    def __init__(self, module):
        self.module = module

    def __enter__(self):
        orig = self.orig = self.module.write_video
        videos = self.videos = {}

        def keep(path, frames, *a, **k):
            videos[os.path.basename(path)] = [f.copy() for f in frames]
            return orig(path, frames, *a, **k)

        self.module.write_video = keep
        return videos

    def __exit__(self, *exc):
        self.module.write_video = self.orig


def frames_ok(label, frames, n):
    """n frames, each finite, within [0, 1] and not black; returns their
    means."""
    import numpy as np

    check(len(frames) == n, f"{label}: {len(frames)} frames, {n} expected")
    for i, f in enumerate(frames):
        check(bool(np.isfinite(f).all()) and f.min() >= 0 and f.max() <= 1
              and f.mean() > 1e-3, f"{label} frame {i}: min {f.min()}, max "
              f"{f.max()}, mean {f.mean()}")
    return [float(f.mean()) for f in frames]


def video_written(out, base, n):
    """`base`.mp4, or its frames directory holding n PNGs."""
    if os.path.exists(os.path.join(out, base + ".mp4")):
        return "mp4"
    names = sorted(os.listdir(os.path.join(out, base + "_frames")))
    check(names == [f"{i:05d}.png" for i in range(n)] + ["INDEX.txt"],
          f"{out}/{base}_frames: {names}")
    return "frames"


def relight_card_vs_cpu(root, work, seed):
    """The small relight of phase 14 on the card and on the CPU under the
    same samples: the flagship dataset's mesh with demo_ball.yaml's shapes
    and a 20-light disco ball at a phase, the trained material; 16 x 16
    pixels, spp 4, depth 2. Bar: 95% of values within rtol 2e-3 / atol
    1e-4 (bf16 MLP sums in another order, ROADMAP Queue 3)."""
    import numpy as np
    import torch
    import yaml

    from iris_tpu_torch.geometry.procedural import camera_rays
    from iris_tpu_torch.pipeline.render_relight import shapes_from_yaml
    from iris_tpu_torch.render import relight as R
    from iris_tpu_torch.train.checkpoint import load_pytree

    with open(DEMO_BALL) as f:
        shapes, *_ = shapes_from_yaml(yaml.safe_load(f),
                                      os.path.join(root, "scene.obj"))
    ez = np.load(os.path.join(work, "bake", "emitter.npz"))
    side, spp, depth = RELIGHT_CHECK
    b, n = side * side, side * side * spp
    rng = np.random.default_rng(seed)

    def u(*shape):
        return torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))

    samples = {"dudv": u(2, b, spp, 1) - 0.5, "s1": u(depth, n),
               "s2": u(depth, n, 2), "s1b": u(depth, n),
               "s2b": u(depth, n, 2)}
    rays = camera_rays(side)
    out = []
    for dev in (torch.device(DEVICE), torch.device("cpu")):
        ngp = load_pytree(os.path.join(work, "checkpoints", "brdf1",
                                       "last.pkl"), dev)["material"]
        disco, spots = R.make_disco_ball([1.0, 1.0, 0.7], 0.15, 20.0,
                                         device=dev)
        scene = R.build_relight_scene(
            shapes, ngp=ngp, main_is_emitter=ez["is_emitter"],
            main_emitter_radiance=ez["emitter_radiance"],
            dynamic_shapes=disco, dynamic_center=[1.0, 1.0, 0.7], device=dev)
        scene = R.set_disco_phase(scene, spots, 0.4)
        r = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in rays]
        out.append(R.relight_path_tracing(
            None, scene, *r, spp, depth,
            samples={k: v.to(dev) for k, v in samples.items()}).cpu().numpy())
    card, cpu = out
    close = np.abs(card - cpu) <= 1e-4 + 2e-3 * np.abs(cpu)
    check(bool(np.isfinite(card).all()) and float(cpu.max()) > 0
          and close.mean() >= 0.95,
          f"relight card vs CPU: {close.mean():.4f} of values close")
    return {"share_close": float(close.mean()),
            "max_abs_diff": float(np.abs(card - cpu).max())}


def run_relight(label, kernel, name, argv, depth, n_spots, disco):
    """One render_relight run through main(argv), watched: wall s, ms a
    round, rays a round (spot rays counted), launches by kernel against
    (1 + D (2 + [spots])) (1 + [disco]) a round, BVH builds (1 + [disco]),
    peak memory, frames; and the largest trace on each tree."""
    import torch

    from iris_tpu_torch.geometry.intersect import kernel_for
    from iris_tpu_torch.pipeline import render_relight

    with watch_relight() as w, record_largest_trace(True) as captured:
        st = run_stage(render_relight.main, argv)
    rounds = len(w.events)
    check(rounds == RELIGHT_FRAMES * RELIGHT_SPP // RELIGHT_SPP_ROUND,
          f"{label} {name}: {rounds} rounds")
    per_round = 1 + depth * (2 + int(n_spots > 0))
    scene = w.scenes[0]
    want = dict.fromkeys(KERNELS, 0)
    want[kernel] += rounds * per_round
    trees = [scene.tracer]
    if disco:
        want["trace_union"] += rounds * per_round
        trees.append(scene.dyn_tracer)
    check(kernel_for(scene.tracer).__name__ == kernel
          and (not disco or kernel_for(scene.dyn_tracer).__name__
               == "trace_union"),
          f"{label} {name}: the scene's trees go to "
          f"{[kernel_for(t).__name__ for t in trees]}")
    check(st["launches"] == want, f"{label} {name}: launches "
          f"{st['launches']}, {want} expected")
    check(len(w.scenes) == 1 and sorted(w.builds) == sorted(
        t.n_faces for t in trees), f"{label} {name}: BVH builds {w.builds}")
    ms = w.round_ms()
    st.update(rounds=rounds, depth=depth, spots=n_spots,
              launches_expected=want, bvh_builds=w.builds,
              static_faces=scene.tracer.n_faces,
              sub_scene_faces=scene.dyn_tracer.n_faces if disco else 0,
              # the replays: past the warm-up and the capture
              ms_per_round=statistics.median(ms[2:]), round_ms=ms,
              rays_per_round=st["rays"] // rounds,
              frame_means=frames_ok(f"{label} {name}", w.frames,
                                    RELIGHT_FRAMES),
              largest_trace_rays={str(k): v["n"] for k, v in
                                  captured.items()})
    st.update(frames=RELIGHT_FRAMES, s_per_frame=st["wall_s"]
              / RELIGHT_FRAMES)
    if disco:
        check(not all((a == b).all() for a, b in zip(w.frames,
                                                     w.frames[1:])),
              f"{label} {name}: the disco frames do not differ")
    del w
    torch.cuda.empty_cache()
    return st, captured


def relight_phase_on(label, kernel, root, work, dev, seed):
    """Phase 14 on one dataset, in its work directory (phase 11's, or the
    one --relight-only makes): extract_emitter_mesh, render_video and
    render_relight on three configs, each through main(argv) on the card.
    Returns (stats by run, {trace: RELIGHT_HELD's largest trace on the
    static tree and on the sub-scene's})."""
    import numpy as np

    from iris_tpu_torch.geometry.mesh import load_mesh
    from iris_tpu_torch.pipeline import render_relight, render_video
    from iris_tpu_torch.utils import extract_emitter_mesh

    bake = os.path.join(work, "bake")
    stats, traffic = {}, {}
    ply = os.path.join(bake, "emitter.ply")
    stats["extract_emitter_mesh"] = run_stage(extract_emitter_mesh.main, [
        "--emitter", os.path.join(bake, "emitter.npz"), "--output", ply])
    ez = np.load(os.path.join(bake, "emitter.npz"))
    n_em = int(ez["is_emitter"].sum())
    check(load_mesh(ply).n_faces == n_em, f"{label} emitter.ply: "
          f"{load_mesh(ply).n_faces} faces, {n_em} emitter faces")
    stats["extract_emitter_mesh"]["faces"] = n_em

    ds = ["--dataset", "synthetic", root, "--ldr_img_dir", "ldr",
          "--device", str(dev), "--checkpoint_path",
          os.path.join(work, "checkpoints"), "--experiment_name", "brdf1",
          "--emitter_path", bake]
    # render_video at phase 11's render settings
    out = os.path.join(work, "video")
    with time_calls(render_video, "render_frame") as frame_s, \
            keep_videos(render_video) as videos:
        st = run_stage(render_video.main, ds + [
            "--output_path", out, "--SPP", str(PIPE_SPP), "--spp",
            str(TRAIN_SPP), "--indir_depth", str(INDIR_DEPTH),
            "--n_interp", str(VIDEO_INTERP)])
    n_frames = VIDEO_INTERP * (STAGE_SPLITS[0] - 1)
    # the rendered frames not black; the AOVs (an emission frame may well
    # be all zero) finite and within [0, 1]
    st["frame_means"] = frames_ok(f"{label} render_video",
                                  videos.pop("video.mp4"), 2 * n_frames)
    for name, frames in videos.items():
        check(all(bool(np.isfinite(f).all()) and f.min() >= 0
                  and f.max() <= 1 for f in frames),
              f"{label} render_video {name}: values out of [0, 1]")
    rounds = n_frames * (PIPE_SPP // TRAIN_SPP)
    want = dict.fromkeys(KERNELS, 0)
    want[kernel] = rounds * (2 + INDIR_DEPTH + 1)
    check(st["launches"] == want, f"{label} render_video: launches "
          f"{st['launches']}, {want} expected")
    st.update(frames=n_frames, rounds=rounds, launches_expected=want,
              s_per_frame=st["wall_s"] / n_frames,
              # the frames past the first (its warm-up and capture): replays
              ms_per_round=1e3 * statistics.median(frame_s[1:])
              * TRAIN_SPP / PIPE_SPP, rays_per_round=st["rays"] // rounds,
              videos={b: video_written(out, b, 2 * n_frames) for b in
                      ("video",) + render_video.AOV_VIDEOS})
    stats["render_video"] = st

    cfgs = relight_yamls(work, ply)
    relight = ["--mode", "traj", "--n_frames", str(RELIGHT_FRAMES),
               "--SPP", str(RELIGHT_SPP), "--spp", str(RELIGHT_SPP_ROUND)]
    runs = (("demo_ball", DEMO_BALL, ["--disco", "1"], 3, 20, True),
            ("relight_1", cfgs["relight_1"], [], 7, 40, True),
            ("insert", cfgs["insert"], [], 7, 0, False))
    for name, cfg, extra, depth, n_spots, disco in runs:
        out = os.path.join(work, "relight_" + name)
        st, captured = run_relight(
            label, kernel, name, ds + relight + extra + [
                "--light_cfg", cfg, "--output_path", out],
            depth, n_spots, disco)
        names = sorted(os.listdir(out))
        check([n for n in names if n.endswith(".png")]
              == [f"{i:05d}.png" for i in range(RELIGHT_FRAMES)],
              f"{label} {name}: files {names}")
        st["video"] = video_written(out, "relight", RELIGHT_FRAMES)
        stats["relight_" + name] = st
        if name == RELIGHT_HELD:
            # the static tree's and the sub-scene's largest traces: the
            # spots' S x n shadow rays on each
            traffic = {f"{name} static": captured[st["static_faces"]],
                       f"{name} sub-scene": captured[st["sub_scene_faces"]]}
        del captured
    if label == "flagship":
        stats["relight_card_vs_cpu"] = relight_card_vs_cpu(root, work, seed)
    return stats, traffic


def relight_datasets(dev, seed):
    """--relight-only's set-up on both datasets: the dataset, its SLF and
    emitter mask (with the generator's light as the radiance, as phase 10
    updates it) under the work directory's bake/, and the production
    material from the seed (refine_material) as checkpoints/brdf1."""
    import numpy as np
    import torch

    from iris_tpu_torch.data.make_demo_dataset import (
        GT_RADIANCE, make_dataset,
    )
    from iris_tpu_torch.pipeline import extract_emitter, slf_bake
    from iris_tpu_torch.train.checkpoint import save_pytree

    for label, n_clutter, _, orbit in STAGE_DATASETS:
        root = os.path.join(STAGE_DIR, label)
        work = os.path.abspath(os.path.join(STAGE_DIR, label + "_pipeline"))
        for d in (root, work):
            shutil.rmtree(d, ignore_errors=True)
        bake = os.path.join(work, "bake")
        make_dataset(root, img_hw=STAGE_HW, n_train=STAGE_SPLITS[0],
                     n_val=STAGE_SPLITS[1], spp=STAGE_GEN_SPP,
                     indir_depth=STAGE_GEN_DEPTH, n_clutter=n_clutter,
                     seed=seed, orbit=orbit, device=dev)
        args = ["--dataset", "synthetic", "--scene", root, "--ldr_img_dir",
                "ldr", "--device", str(dev), "--output", bake]
        slf_bake.main(args + ["--voxel_num", str(STAGE_VOXELS)])
        extract_emitter.main(args + ["--threshold", "0.99"])
        n_em = int(np.load(os.path.join(bake, "emitter.npz"))[
            "is_emitter"].sum())
        ckpt = os.path.join(work, "emitter_ckpt.pkl")
        save_pytree(ckpt, {"radiance": torch.full((max(n_em, 1), 3),
                                                  GT_RADIANCE)})
        extract_emitter.main(args + ["--mode", "update", "--ckpt", ckpt])
        z = np.load(os.path.join(bake, "vslf.npz"))
        os.makedirs(os.path.join(work, "checkpoints", "brdf1"))
        save_pytree(os.path.join(work, "checkpoints", "brdf1", "last.pkl"),
                    {"material": refine_material(float(z["voxel_min"]),
                                                 float(z["voxel_max"]),
                                                 seed, dev)})


def relight_phase(dev, seed):
    """Phase 14 on both datasets, printed, from the work directories under
    STAGE_DIR (phase 11's, or relight_datasets'). Returns the stats by
    dataset and the relight traffic for hold_stage_traffic: #1 on the
    flagship's and the sub-scene's spot shadow traces, #5 on the 102K
    soup's."""
    print(f"relight: render_video --n_interp {VIDEO_INTERP} at SPP "
          f"{PIPE_SPP} / spp {TRAIN_SPP}, depth {INDIR_DEPTH}; render_relight "
          f"--mode traj --n_frames {RELIGHT_FRAMES} at SPP {RELIGHT_SPP} / "
          f"spp {RELIGHT_SPP_ROUND} on demo_ball.yaml --disco 1, a "
          f"relight_1-shaped and an insert-shaped config; the trained "
          f"material of checkpoints/brdf1")
    stats, traffic = {}, []
    for label, _, kernel, _ in STAGE_DATASETS:
        t0 = time.perf_counter()
        root = os.path.abspath(os.path.join(STAGE_DIR, label))
        work = os.path.abspath(os.path.join(STAGE_DIR, label + "_pipeline"))
        st, captured = relight_phase_on(label, kernel, root, work, dev,
                                        seed)
        st["total_s"] = time.perf_counter() - t0
        report_relight(label, st)
        stats[label] = st
        if kernel == "trace_union":
            traffic.append((label, kernel, captured))
        else:
            traffic.append((label, kernel, {
                k: v for k, v in captured.items() if k.endswith("static")}))
    return stats, traffic


def report_relight(label, stats):
    for name, st in stats.items():
        if not isinstance(st, dict) or "wall_s" not in st:
            continue
        launched = {k: v for k, v in st["launches"].items() if v}
        extra = ""
        if "rounds" in st:
            extra = (f"; {st['rounds']} rounds, {st['ms_per_round']:.2f} ms "
                     f"a round (median of the graph replays), "
                     f"{st['rays_per_round']} rays a "
                     f"round, {st['s_per_frame']:.2f} s a frame")
        if "depth" in st:
            extra += (f"; depth {st['depth']}, {st['spots']} spots, trees "
                      f"{st['static_faces']} + {st['sub_scene_faces']} "
                      f"faces, BVH builds {st['bvh_builds']}, LDR means "
                      f"{[round(m, 4) for m in st['frame_means']]}")
        print(f"relight {label} {name}: {st['wall_s']:.2f} s, launches "
              f"{launched}, peak memory {st['peak_memory_mb']:.0f} MB"
              + extra)
    if "relight_card_vs_cpu" in stats:
        c = stats["relight_card_vs_cpu"]
        print(f"relight card vs CPU ({RELIGHT_CHECK[0]}^2 px, spp "
              f"{RELIGHT_CHECK[1]}, depth {RELIGHT_CHECK[2]}, 20 spots and "
              f"the disco ball): {c['share_close']:.4f} of values within "
              f"rtol 2e-3/atol 1e-4, max |diff| {c['max_abs_diff']:.3e}")
    print(f"relight {label}: {stats['total_s']:.1f} s in all")


class watch_results:
    """While active, every call of module.<name> hands its result to
    `seen` as well as to its caller."""

    def __init__(self, module, name, seen):
        self.module, self.name, self.seen = module, name, seen

    def __enter__(self):
        orig = self.orig = getattr(self.module, self.name)
        seen = self.seen

        def watched(*a, **k):
            out = orig(*a, **k)
            seen(out)
            return out

        setattr(self.module, self.name, watched)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def tools_datasets(dev, seed, new_datasets):
    """[(label, root, kernel name, frame size)]: phase 11's two 240 x 320
    datasets (written anew with new_datasets, as --pipeline-only writes
    them) and one per scene at TOOLS_HW under TOOLS_DIR, with the seconds
    each new one took to write."""
    from iris_tpu_torch.data.make_demo_dataset import make_dataset

    out = []
    for label, n_clutter, kernel, orbit in STAGE_DATASETS:
        for hw, base, spp, depth, new in (
                (STAGE_HW, STAGE_DIR, STAGE_GEN_SPP, STAGE_GEN_DEPTH,
                 new_datasets),
                (TOOLS_HW, TOOLS_DIR, TOOLS_GEN_SPP, TOOLS_GEN_DEPTH,
                 True)):
            root = os.path.join(base, label if hw == STAGE_HW
                                else f"{label}_{hw[0]}x{hw[1]}")
            t0 = time.perf_counter()
            if new:
                shutil.rmtree(root, ignore_errors=True)
                make_dataset(root, img_hw=hw, n_train=STAGE_SPLITS[0],
                             n_val=STAGE_SPLITS[1], spp=spp,
                             indir_depth=depth, n_clutter=n_clutter,
                             seed=seed, orbit=orbit, device=dev)
            out.append((f"{label} {hw[0]}x{hw[1]}", os.path.abspath(root),
                        kernel, hw, time.perf_counter() - t0 if new
                        else None))
    return out


def geometry_summary(out):
    """What the tools check of one frame's extract_geometry arrays: the
    share of rays that hit, whether every depth is finite and >= 0, and
    whether a miss is 0 everywhere."""
    import torch

    pos, nrm, depth = out
    hit = (nrm != 0).any(-1)
    return {"hit_share": hit.float().mean().item(),
            "depth_ok": bool((torch.isfinite(depth) & (depth >= 0)).all()),
            "miss_zero": bool(((depth == 0) == ~hit).all()
                              and (pos[~hit] == 0).all()),
            "pos": pos}


def run_tools(label, root, kernel, hw, dev, seed):
    """The five tools' main(argv) on the card on one dataset (its train
    split), each with its launches counted: extract_geometry,
    render_semantic with the per-face labels face // 12 % 128,
    fuse_segmentation at n_labels 128, hdr2ldr on train/Image and
    process_images --max_width 438 on hdr2ldr's PNGs. Returns the stats,
    the first frame's hit positions (on the card) and the traversal input
    the ray-casting tools share (record_largest_trace's capture)."""
    import contextlib

    import numpy as np
    import torch

    from iris_tpu_torch.data.datasets import SyntheticDataset
    from iris_tpu_torch.geometry.mesh import load_mesh
    from iris_tpu_torch.utils import (
        extract_geometry, fuse_segmentation, hdr2ldr, process_images,
        render_semantic,
    )
    from iris_tpu_torch.utils.exr import read_exr

    work = root + "_tools"
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    n_frames, (h, w) = STAGE_SPLITS[0], hw
    n_faces = load_mesh(os.path.join(root, "scene.obj")).n_faces
    labels_npy = os.path.join(work, "labels.npy")
    np.save(labels_npy, (np.arange(n_faces) // 12) % TOOLS_LABELS)
    cli = ["--dataset", "synthetic", "--scene", root, "--ldr_img_dir", "ldr",
           "--device", str(dev)]
    ldr, small = os.path.join(root, "train", "ldr_tools"), os.path.join(
        work, f"ldr_{TOOLS_MAX_WIDTH}")
    runs = {
        "extract_geometry": (extract_geometry.main, cli + [
            "--output", os.path.join(work, "geometry")]),
        "render_semantic": (render_semantic.main, cli + [
            "--labels", labels_npy, "--output",
            os.path.join(work, "semantic")]),
        "fuse_segmentation": (fuse_segmentation.main, cli + [
            "--n_labels", str(TOOLS_LABELS), "--output",
            os.path.join(work, "fused")]),
        "hdr2ldr": (hdr2ldr.main, [
            "--dir_src", os.path.join(root, "train", "Image"), "--dir_tgt",
            ldr, "--seed", str(seed)]),
        "process_images": (process_images.main, [
            "--input", ldr, "--output", small, "--max_width",
            str(TOOLS_MAX_WIDTH)]),
    }
    frames, fused, captures, st = [], [], {}, {}
    watches = {"extract_geometry": watch_results(
                   extract_geometry, "trace_geometry",
                   lambda out: frames.append(geometry_summary(out))),
               "fuse_segmentation": watch_results(
                   fuse_segmentation, "fuse_segmentation", fused.append)}
    for tool, (main_fn, argv) in runs.items():
        with record_largest_trace() as cap, watches.get(
                tool, contextlib.nullcontext()):
            st[tool] = run_stage(main_fn, argv)
        st[tool]["frames"] = n_frames
        want = TOOLS_TRACES.get(tool, 0) * n_frames
        check(only_launched(st[tool]["launches"], kernel, want) if want
              else not any(st[tool]["launches"].values()),
              f"tools {label} {tool}: launches {st[tool]['launches']}, "
              f"{want} of {kernel} alone expected")
        if cap:
            captures[tool] = cap
    # what the tools wrote
    for sub, n in (("geometry", 3 * n_frames), ("semantic", n_frames),
                   ("fused", n_frames)):
        names = sorted(os.listdir(os.path.join(work, sub)))
        check(len(names) == n, f"tools {label} {sub}: files {names}")
    seg = read_exr(os.path.join(work, "fused", "000.exr"))
    check(seg.shape == (h, w, 3) and bool(np.isfinite(seg).all()),
          f"tools {label} fused view: shape {seg.shape}")
    check(len(frames) == n_frames and all(
        f["hit_share"] > 0.95 and f["depth_ok"] and f["miss_zero"]
        for f in frames), f"tools {label} geometry: " + str(
            [{k: v for k, v in f.items() if k != "pos"} for f in frames]))
    # the fused labels: the generator's part ids (face // 12 % 16, its
    # IndexMA maps) on > 90% of the observed faces, and the same bits when
    # fused again
    labels = fused[0]
    seen = np.flatnonzero(labels >= 0)
    agree = float((labels[seen] == (seen // 12) % 16).mean())
    ds = SyntheticDataset(root, img_dir="ldr", split="train", load_gt=False,
                          load_inverse=True)
    again = fuse_segmentation.fuse_segmentation(
        captures["fuse_segmentation"]["tracer"], n_faces, ds.frames(),
        TOOLS_LABELS)
    check(len(seen) > 0 and agree > 0.9, f"tools {label}: fused labels "
          f"agree with the part ids on {agree:.4f} of {len(seen)} faces")
    check(np.array_equal(again, labels), f"tools {label}: fused twice, "
          "other labels")
    # hdr2ldr's directory loads as the dataset's LDR images
    ldr_ds = SyntheticDataset(root, img_dir="ldr_tools", split="train",
                              load_gt=False)
    rgbs = ldr_ds.frame(0)["rgbs"]
    check(ldr_ds.exposures.shape == (n_frames,) and ldr_ds.crfs.shape
          == (3, 1024) and rgbs.shape == (h * w, 3) and bool(
              np.isfinite(rgbs).all()) and 0 < float(rgbs.mean()) <= 1,
          f"tools {label}: hdr2ldr's directory as a dataset")
    from PIL import Image

    pngs = sorted(n for n in os.listdir(small) if n.endswith(".png"))
    w_out = min(w, TOOLS_MAX_WIDTH)
    size = (w_out, h if w <= TOOLS_MAX_WIDTH else int(w_out / w * h))
    check(len(pngs) == n_frames and all(
        Image.open(os.path.join(small, n)).size == size for n in pngs),
        f"tools {label}: process_images wrote {pngs}")
    # the three ray-casting tools trace the same camera rays: one capture
    first = captures["extract_geometry"]
    check(all(c["n"] == h * w and torch.equal(c["o"], first["o"])
              and torch.equal(c["d"], first["d"])
              for c in captures.values()),
          f"tools {label}: the tools' largest traces differ")
    st.update(frames_seen=[{k: v for k, v in f.items() if k != "pos"}
                           for f in frames],
              fused_faces=int(len(seen)), fused_agree=agree,
              faces=n_faces)
    return st, frames[0]["pos"], first


def tools_card_vs_cpu(root, dev, seed):
    """On the first train frame of a 240 x 320 dataset, the tools' device
    functions on the card and on the CPU: the labels and the fused labels
    (and the rewritten view) equal, the geometry within atol 1e-5, and the
    implicit MLP (float32, TF32 off) on the frame's hit positions within
    rtol 1e-4 / atol 1e-5 of its largest value."""
    import numpy as np
    import torch

    from iris_tpu_torch.data.datasets import SyntheticDataset
    from iris_tpu_torch.geometry.bvh import build_bvh
    from iris_tpu_torch.geometry.mesh import load_mesh
    from iris_tpu_torch.models.mlps import (
        apply_implicit_mlp, init_implicit_mlp,
    )
    from iris_tpu_torch.utils import fuse_segmentation as fuse
    from iris_tpu_torch.utils.extract_geometry import trace_geometry
    from iris_tpu_torch.utils.render_semantic import (
        face_label_tensor, semantic_labels,
    )

    mesh = load_mesh(os.path.join(root, "scene.obj"))
    ds = SyntheticDataset(root, img_dir="ldr", split="train", load_gt=False,
                          load_inverse=True)
    fr = ds.frame(0)
    labels = (np.arange(mesh.n_faces) // 12) % TOOLS_LABELS
    gen = torch.Generator().manual_seed(seed + TOOLS_MLP_SEED)
    mlp = init_implicit_mlp(gen, device="cpu")
    out = []
    for d in (dev, torch.device("cpu")):
        tracer = build_bvh(mesh.triangles(), device=d)
        rays = torch.from_numpy(fr["rays"]).to(d)
        seg = torch.from_numpy(fr["segmentation"]).to(d)
        pos, nrm, depth = trace_geometry(tracer, rays)
        fused = fuse.fuse_segmentation(tracer, mesh.n_faces, [fr],
                                       TOOLS_LABELS)
        params = {k: ({f: [t.to(d) for t in v[f]] for f in v}
                      if isinstance(v, dict) else v) for k, v in mlp.items()}
        out.append({
            "pos": pos, "nrm": nrm, "depth": depth,
            "labels": semantic_labels(tracer, face_label_tensor(
                labels, mesh.n_faces, d), rays),
            "fused": torch.from_numpy(fused),
            "views": fuse.relabel(tracer, torch.from_numpy(fused).to(d),
                                  rays, seg),
            "mlp": apply_implicit_mlp(params, pos)})
    card, cpu = out
    report = {}
    for k in ("pos", "nrm", "depth"):
        err = float((card[k].cpu() - cpu[k]).abs().max())
        check(err <= 1e-5, f"tools card vs CPU: {k} off by {err:.3e}")
        report[f"{k}_max_abs_diff"] = err
    for k in ("labels", "fused", "views"):
        check(torch.equal(card[k].cpu(), cpu[k]),
              f"tools card vs CPU: {k} differ")
    a, b = card["mlp"].cpu(), cpu["mlp"]
    scale = float(b.abs().max())
    check(bool(torch.isfinite(a).all()) and torch.allclose(
        a, b, rtol=1e-4, atol=1e-5 * scale),
        f"tools card vs CPU: implicit MLP off by "
        f"{float((a - b).abs().max()):.3e} (largest value {scale:.3e})")
    report.update(rays=int(rays.shape[0]), labels_equal=True,
                  mlp_max_abs_diff=float((a - b).abs().max()),
                  mlp_max_abs=scale)
    return report


def implicit_mlp_full_frame(pos, dev, seed):
    """The implicit MLP (the JAX defaults: 256 wide, 8 deep, 10
    frequencies) forward on a full-size frame's hit positions: CUDA-event
    ms of one call after a warm-up, its output checked finite."""
    import torch

    from iris_tpu_torch.models.mlps import ImplicitMLP, init_implicit_mlp

    gen = torch.Generator(device=dev).manual_seed(seed + TOOLS_MLP_SEED)
    model = ImplicitMLP(init_implicit_mlp(gen, device=dev))
    with torch.no_grad():
        model(pos)
        ms, y = timed_once(lambda: model(pos))
    check(y.shape == (pos.shape[0], 5) and bool(torch.isfinite(y).all()),
          f"implicit MLP on {pos.shape[0]} points: {tuple(y.shape)}")
    return {"points": int(pos.shape[0]), "ms": ms}


def tools_phase(dev, seed, new_datasets=True):
    """Phase 15 on the four datasets, printed: returns the stats by
    dataset and the tools' traffic for hold_stage_traffic (the camera rays
    of a full-size frame, which the three ray-casting tools share)."""
    print(f"tools: extract_geometry, render_semantic (labels face // 12 % "
          f"{TOOLS_LABELS}), fuse_segmentation (n_labels {TOOLS_LABELS}), "
          f"hdr2ldr and process_images --max_width {TOOLS_MAX_WIDTH} on "
          f"the train split of {STAGE_HW[0]} x {STAGE_HW[1]} and "
          f"{TOOLS_HW[0]} x {TOOLS_HW[1]} datasets ({STAGE_SPLITS[0]} train "
          f"frames; the full-size ones at generator spp {TOOLS_GEN_SPP}, "
          f"depth {TOOLS_GEN_DEPTH}, cuts)")
    t_phase = time.perf_counter()
    stats, traffic, full_pos = {}, [], None
    for label, root, kernel, hw, made_s in tools_datasets(dev, seed,
                                                          new_datasets):
        t0 = time.perf_counter()
        st, pos, capture = run_tools(label, root, kernel, hw, dev, seed)
        st.update(kernel=kernel, dataset_s=made_s,
                  total_s=time.perf_counter() - t0)
        report_tools(label, st)
        stats[label] = st
        if hw == TOOLS_HW:
            traffic.append((label, kernel, {"tools": capture}))
            if full_pos is None:
                full_pos = pos
        if hw == STAGE_HW and kernel == "trace_union":
            st["card_vs_cpu"] = c = tools_card_vs_cpu(root, dev, seed)
            print(f"tools card vs CPU ({label}, frame 0, {c['rays']} rays): "
                  f"labels, fused labels and views equal; geometry max "
                  f"|diff| {c['pos_max_abs_diff']:.3e} / "
                  f"{c['nrm_max_abs_diff']:.3e} / "
                  f"{c['depth_max_abs_diff']:.3e}; implicit MLP max |diff| "
                  f"{c['mlp_max_abs_diff']:.3e} of {c['mlp_max_abs']:.3e}")
    stats["implicit_mlp"] = m = implicit_mlp_full_frame(full_pos, dev, seed)
    print(f"implicit MLP (3 -> 63 -> 256 x 8 -> 5, float32) on the "
          f"{m['points']} positions of a {TOOLS_HW[0]} x {TOOLS_HW[1]} "
          f"frame: {m['ms']:.3f} ms")
    stats["total_s"] = time.perf_counter() - t_phase
    print(f"tools: {stats['total_s']:.1f} s in all")
    return stats, traffic


def report_tools(label, st):
    made = ("" if st["dataset_s"] is None
            else f"dataset written in {st['dataset_s']:.1f} s; ")
    print(f"tools {label}: {st['faces']} faces -> {st['kernel']}; {made}"
          f"hit shares {[round(f['hit_share'], 4) for f in st['frames_seen']]}"
          f"; fused {st['fused_faces']} observed faces, "
          f"{st['fused_agree']:.4f} of them the part id")
    for tool in TOOLS:
        t = st[tool]
        launched = {k: v for k, v in t["launches"].items() if v}
        print(f"tools {label} {tool}: {t['wall_s']:.2f} s, {t['frames']} "
              f"frames, {t['rays']} rays in {t['traces']} traces, "
              f"{t['rays_per_s']:.0f} rays/s; launches {launched}; peak "
              f"memory {t['peak_memory_mb']:.0f} MB")


def frame_rays(dev):
    import numpy as np
    import torch

    from iris_tpu_torch.geometry.procedural import camera_rays

    o, d, dxdu, dydv = camera_rays(CAMERA_SIDE)
    rays = np.concatenate([o, d, dxdu, dydv], -1).astype(np.float32)
    return torch.from_numpy(rays).to(dev)


def render_scene(label, tracer, em, mat_fn, crf, rays, n_rounds, seed,
                 depth=INDIR_DEPTH):
    """The round as the render CLIs run it (pipeline.render.
    make_render_round): its eager warm-up round (recording the largest
    traversal input), its capture and first replay, then n_rounds timed
    rounds through render_frame, each one CUDA graph replay, with launch
    counts reset just before and read just after. Returns (stats,
    captured input)."""
    import numpy as np
    import torch

    from iris_tpu_torch.models.crf import crf_forward
    from iris_tpu_torch.pipeline.render import (
        make_render_fns, make_render_round, render_frame)

    render_round = make_render_round(
        *make_render_fns(tracer, em, mat_fn, SPP, depth), rays.device)
    with record_largest_trace() as captured:
        render_round(rays, seed=seed)
        torch.cuda.synchronize()
    render_round(rays)

    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    l_img, aovs = render_frame(render_round, rays, n_rounds, seed)
    end.record()
    end.synchronize()
    launches = read_launches()

    ms = start.elapsed_time(end) / n_rounds
    samples = rays.shape[0] * SPP
    check(l_img.shape == (rays.shape[0], 3), f"{label}: image shape")
    check(bool(np.isfinite(l_img).all()), f"{label}: non-finite radiance")
    check(float(np.abs(l_img).max()) > 0, f"{label}: all-zero image")
    for a in aovs:
        check(bool(np.isfinite(a).all()), f"{label}: non-finite AOV")
    ldr = crf_forward(crf, torch.from_numpy(l_img).to(rays.device))
    ldr = ldr.cpu().numpy()
    check(bool(np.isfinite(ldr).all()) and ldr.min() >= 0 and
          ldr.max() <= 1, f"{label}: LDR out of [0, 1]")
    stats = {"ms_per_round": ms, "camera_samples_per_round": samples,
             "rays_per_s": samples / (ms / 1e3), "rounds": n_rounds,
             "round": "graph replay",
             "depth": depth, "launches": launches,
             "hdr_mean": l_img.mean(0).tolist(),
             "ldr_mean": ldr.mean(0).tolist(),
             "largest_trace_rays": captured["n"]}
    return stats, captured


def round_census(tracer, em, mat_fn, rays, seed):
    """One render round (render_chunk + aov_chunk, spp 8, depth 5) after a
    warm-up round, with mat_fn's calls counted and the card's kernels
    recorded by torch.profiler: (material evaluations, kernels launched,
    device-busy ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from iris_tpu_torch.pipeline.render import make_render_fns
    from profile_render import device_kernels, device_time_us

    calls = [0]

    def counted(x):
        calls[0] += 1
        return mat_fn(x)

    render_chunk, aov_chunk = make_render_fns(tracer, em, counted, SPP,
                                              INDIR_DEPTH)
    gen = torch.Generator(device=rays.device).manual_seed(seed)
    render_chunk(rays, gen)
    aov_chunk(rays, gen)
    torch.cuda.synchronize()
    calls[0] = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        render_chunk(rays, gen)
        aov_chunk(rays, gen)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    return (calls[0], sum(e.count for e in kernels),
            sum(device_time_us(e) for e in kernels) / 1e3)


def only_launched(launches, name, n=None):
    """True when `name` was launched (n times, when given) and no other
    traversal kernel was."""
    ok = launches[name] > 0 if n is None else launches[name] == n
    return ok and all(v == 0 for k, v in launches.items() if k != name)


def move(obj, d):
    """A copy of a (nested) dataclass / dict / list of tensors on device
    d."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(d)
    if isinstance(obj, dict):
        return {k: move(v, d) for k, v in obj.items()}
    if isinstance(obj, list):
        return [move(v, d) for v in obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: move(getattr(obj, f.name), d)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def small_reference_check(tracer, em, ngp, dev, seed):
    """The same 64-pixel render (spp 2, depth 5) on the card and on the
    CPU under common random numbers. The CPU run walks the plain
    traversal and computes everything with CPU kernels. Bar: radiance
    within rtol 2e-3 / atol 1e-4 on >= 95% of values, and AOVs within
    rtol 1e-2 / atol 1e-3: bf16 rounding of MLP sums taken in another
    order can move a path now and then (tests/test_torch_slice.py)."""
    import numpy as np
    import torch

    from iris_tpu_torch.demo import demo_mat_fn
    from iris_tpu_torch.pipeline.render import make_render_fns

    rays = frame_rays(dev)[::127][:64]
    b, spp, depth = rays.shape[0], 2, INDIR_DEPTH
    n = b * spp
    rng = np.random.default_rng(seed)

    def u(*shape):
        return torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))

    s = {"dudv": u(2, b, spp, 1) - 0.5, "s1": u(n), "s2": u(n, 2),
         "s1b": u(n), "s2b": u(n, 2),
         "indirect": {"s1": u(depth, n), "s2": u(depth, n, 2),
                      "s1b": u(depth, n), "s2b": u(depth, n, 2)}}
    s_aov = {"dudv": u(2, b, spp, 1), "s2": u(n, 2)}

    out = []
    for d in (dev, torch.device("cpu")):
        tr, e, g = move(tracer, d), move(em, d), move(ngp, d)
        tr.paired = tr.dense = None
        rc, ac = make_render_fns(tr, e, demo_mat_fn(g), spp, depth)
        out.append((rc(rays.to(d), samples=move(s, d)).cpu().numpy(),
                    [a.cpu().numpy() for a in
                     ac(rays.to(d), samples=move(s_aov, d))]))
    (lg, ag), (lc, ac_) = out
    close = np.abs(lg - lc) <= 1e-4 + 2e-3 * np.abs(lc)
    check(close.mean() >= 0.95,
          f"card vs CPU radiance: {close.mean():.4f} of values close")
    for a, c in zip(ag, ac_):
        check(bool(np.allclose(a, c, rtol=1e-2, atol=1e-3)),
              "card vs CPU AOVs differ")
    return float(close.mean()), float(np.abs(lg - lc).max())


def level_blocks(x, cfg):
    """(n_levels,) bool: the level blocks of a table-shaped tensor that
    hold a nonzero, in row mode ((L*T, F) rows) and in the flat and packed
    modes ((F*L*T,), feature-major)."""
    if x.dim() == 2:
        return x.abs().reshape(cfg.n_levels, -1).sum(1) > 0
    return (x.abs().reshape(cfg.n_features, cfg.n_levels, -1).sum(2)
            > 0).any(0)


def check_bench_grads(label, grads, cfg):
    """Every gradient leaf finite; table, MLP, radiance and CRF gradients
    each nonzero; exactly cfg.bwd_level_sample level blocks of the table
    gradient nonzero."""
    import torch

    bwd_k = cfg.bwd_level_sample

    for name, g in grads.items():
        check(bool(torch.isfinite(g).all()), f"{label}: gradient {name} "
              "is not finite")
    for name in ("material.table", "material.mlp.w.0", "material.mlp.w.2",
                 "material.mlp.b.2", "radiance", "crf_w"):
        check(name in grads and float(grads[name].abs().sum()) > 0,
              f"{label}: gradient {name} is missing or zero")
    blocks = level_blocks(grads["material.table"], cfg)
    check(int(blocks.sum()) == bwd_k, f"{label}: {int(blocks.sum())} level "
          f"blocks of the table gradient are nonzero, expected {bwd_k}")


def bench_setup(label, tracer, em, ngp, crf, rays, seed):
    """What both training paths start from: fresh parameters, the benchmark
    loss, Adam, a generator, and one checked gradient (recording the
    largest traversal input of a step)."""
    import torch

    from iris_tpu_torch.train.loop import value_and_grad
    from iris_tpu_torch.train.optim import make_optimizer, named_leaves

    params = bench_params(em, ngp, crf)
    loss_fn = make_bench_loss(tracer, em, crf, rays, TRAIN_SPP)
    opt = make_optimizer(learning_rate=1e-3)
    gen = torch.Generator(device=rays.device).manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    with record_largest_trace() as captured:
        loss0, _, grads = value_and_grad(loss_fn, params, {}, gen)
    check(bool(torch.isfinite(loss0)), f"{label}: loss is not finite")
    check_bench_grads(label, grads, params["material"].cfg)
    del grads
    start_leaves = {n: t.clone() for n, t in named_leaves(params)}
    return params, loss_fn, opt, gen, float(loss0), captured, start_leaves


def bench_stats(label, kernel, params, start_leaves, losses, launches,
                n_steps, ms, wall_ms, loss0, captured, rays):
    """The checks both training paths end on (finite losses, 2 launches of
    `kernel` alone per step, every leaf finite and moved) and their
    stats."""
    import torch

    from iris_tpu_torch.train.optim import named_leaves

    losses = [float(x) for x in losses]
    check(len(losses) == n_steps and all(
        x == x and abs(x) != float("inf") for x in losses),
        f"{label}: a step's loss is not finite")
    check(only_launched(launches, kernel, 2 * n_steps),
          f"{label}: expected {2 * n_steps} launches of {kernel} alone, "
          f"got {launches}")
    for name, t in named_leaves(params):
        check(bool(torch.isfinite(t).all()), f"{label}: {name} not finite")
        check(bool((t != start_leaves[name]).any()),
              f"{label}: {name} did not move")
    samples = rays.shape[0] * TRAIN_SPP
    return {"ms_per_step": ms, "host_ms_per_step": wall_ms,
            "camera_samples_per_step": samples,
            "camera_samples_per_s": samples / (ms / 1e3), "steps": n_steps,
            "launches": launches, "first_loss": loss0, "losses": losses,
            "largest_trace_rays": captured["n"],
            "peak_memory_mb": torch.cuda.max_memory_allocated() / 2 ** 20}


def train_scene(label, kernel, tracer, em, ngp, crf, rays, n_steps, seed):
    """The benchmark step through make_train_step: one gradient (checked)
    and one warm-up step, then n_steps timed steps with launch counts
    reset just before and read just after. Returns (stats, the largest
    traversal input of a step)."""
    import torch

    from iris_tpu_torch.train.loop import make_train_step

    params, loss_fn, opt, gen, loss0, captured, start_leaves = bench_setup(
        label, tracer, em, ngp, crf, rays, seed)
    state = opt.init(params)
    step = make_train_step(loss_fn, opt)
    step(params, state, {}, gen)                          # warm-up
    torch.cuda.synchronize()

    reset_launches()
    losses = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n_steps):
        params, state, loss, _ = step(params, state, {}, gen)
        losses.append(loss)
    end.record()
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    stats = bench_stats(label, kernel, params, start_leaves, losses,
                        read_launches(), n_steps,
                        start.elapsed_time(end) / n_steps, wall_ms, loss0,
                        captured, rays)
    return stats, captured


def train_loop_scene(label, kernel, tracer, em, ngp, crf, rays, n_steps,
                     seed):
    """The benchmark step through run_training: one gradient (checked),
    step 0 as the warm-up, then steps 1..n_steps timed, with launch counts
    reset just before and read just after. A state hook stops the clock at
    the last step and a second one then saves the full training state; the
    file is loaded again and held against the live state. Returns (stats,
    the largest traversal input of a step)."""
    import itertools
    import tempfile

    import torch

    from iris_tpu_torch.train import checkpoint as ck
    from iris_tpu_torch.train.loop import run_training
    from iris_tpu_torch.train.optim import named_leaves

    params, loss_fn, opt, _, loss0, captured, start_leaves = bench_setup(
        label, tracer, em, ngp, crf, rays, seed)
    cfg = params["material"].cfg
    kw = dict(seed=seed, log_fn=None, return_state=True)
    params, state = run_training(loss_fn, params, itertools.repeat({}), opt,
                                 1, **kw)                  # step 0: warm-up
    torch.cuda.synchronize()
    # one step of a fresh Adam moves exactly the level blocks the step
    # sampled: one phase of the stride, cfg.bwd_level_sample blocks
    stride = cfg.n_levels // cfg.bwd_level_sample

    def moved_blocks():
        moved = level_blocks(params["material"].table
                             - start_leaves["material.table"], cfg)
        cols = moved.reshape(cfg.bwd_level_sample, stride)
        check(bool((cols == cols[0]).all()),
              f"{label}: moved level blocks {moved.tolist()} are not whole "
              f"phases of stride {stride}")
        return int(cols[0].sum())

    check(moved_blocks() == 1, f"{label}: the first step moved "
          f"{moved_blocks()} phases of level blocks, expected 1")

    losses, marks = [], {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def stop_clock(step, p, o):
        if step == n_steps:
            end.record()
            end.synchronize()
            marks["wall"] = time.perf_counter()
            marks["launches"] = read_launches()

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.pkl")
        reset_launches()
        t0 = time.perf_counter()
        start.record()
        params, state = run_training(
            loss_fn, params, itertools.repeat({}), opt, n_steps + 1,
            opt_state=state, start_step=1,
            hooks=[lambda s, p, loss, aux: losses.append(loss)],
            state_hooks=[stop_clock,
                         ck.make_state_saver(path, every=n_steps + 1)], **kw)
        save_s = time.perf_counter() - marks["wall"]
        check(os.listdir(tmp) == ["state.pkl"],
              f"{label}: checkpoint directory holds {os.listdir(tmp)}")
        ckpt_mb = os.path.getsize(path) / 2 ** 20
        t_load = time.perf_counter()
        restored, r_state, r_step = ck.load_train_state(
            path, os.path.join(tmp, "none.pkl"), None, optimizer=opt,
            device=rays.device)
        load_s = time.perf_counter() - t_load
    check(r_step == n_steps + 1, f"{label}: restored step {r_step}")
    live, back = named_leaves(params), named_leaves(restored)
    check([n for n, _ in live] == [n for n, _ in back],
          f"{label}: restored leaves differ in name")
    for (name, a), (_, b) in zip(live, back):
        check(a.device == b.device and torch.equal(a, b),
              f"{label}: restored {name} differs")
    check(restored["material"].cfg == cfg, f"{label}: restored config")
    s_live = state["opt"].state_dict()["state"]
    s_back = r_state["opt"].state_dict()["state"]
    check(len(s_live) == len(s_back) == len(live), f"{label}: moments")
    for i, st in s_live.items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            check(torch.equal(st[key].cpu(), s_back[i][key].cpu()),
                  f"{label}: restored {key} of leaf {i} differs")
    del restored, r_state, s_back

    stats = bench_stats(label, kernel, params, start_leaves, losses,
                        marks["launches"], n_steps,
                        start.elapsed_time(end) / n_steps,
                        (marks["wall"] - t0) * 1e3 / n_steps, loss0,
                        captured, rays)
    stats.update(moved_level_blocks=moved_blocks() * cfg.bwd_level_sample,
                 checkpoint_mb=ckpt_mb, checkpoint_save_s=save_s,
                 checkpoint_load_s=load_s)
    return stats, captured


def stage_losses(tracer, em, ngp, crf, dev, seed, n_steps=3):
    """Three optimizer steps of each stage loss on a 4,096-pixel demo
    batch; the brdf_crf batch gets diffuse (B, 3) and specular0/1
    (B, 6, 3) shadings drawn from the seed. Checks: losses finite, and the
    leaves a stage freezes take no gradient. Returns per-stage stats."""
    import numpy as np
    import torch

    from iris_tpu_torch.demo import make_demo_batch
    from iris_tpu_torch.train.loop import make_train_step, value_and_grad
    from iris_tpu_torch.train.optim import make_optimizer, named_leaves
    from iris_tpu_torch.train.steps import (
        LossConfig, make_brdf_crf_loss, make_initialize_loss,
        make_train_emitter_loss)

    batch = make_demo_batch(n_side=STAGE_BATCH_SIDE, device=dev)
    b = batch["rays"].shape[0]
    rng = np.random.default_rng(seed + 5)
    for name, shape in (("diffuse", (b, 3)), ("specular0", (b, 6, 3)),
                        ("specular1", (b, 6, 3))):
        batch[name] = torch.from_numpy(
            rng.uniform(0, 1, shape).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    mat = train_config(ngp)

    def run(label, loss_fn, params):
        opt = make_optimizer(learning_rate=1e-3)
        state = opt.init(params)
        step = make_train_step(loss_fn, opt)
        step(params, state, batch, gen)                   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for _ in range(n_steps):
            _, _, loss, _ = step(params, state, batch, gen)
            losses.append(loss)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n_steps
        losses = [float(x) for x in losses]
        check(all(np.isfinite(losses)), f"{label}: loss not finite")
        for name, t in named_leaves(params):
            check(bool(torch.isfinite(t).all()), f"{label}: {name}")
        return {"ms_per_step": ms, "losses": losses, "pixels": b}

    out = {}
    # initialize: the render's gradient must not reach the material
    cfg = LossConfig()
    loss_fn = make_initialize_loss(tracer, em, crf, cfg)
    params = {"material": train_config(ngp), "radiance": em.radiance.clone()}
    leaves = named_leaves(params)
    for _, t in leaves:
        t.requires_grad_(True)
    _, aux = loss_fn(params, batch, gen)
    render_grads = torch.autograd.grad(aux["loss_c"], [t for _, t in leaves],
                                       allow_unused=True)
    for (name, t), g in zip(leaves, render_grads):
        t.requires_grad_(False)
        frozen = name.startswith("material")
        check((g is None or not bool(g.any())) if frozen
              else (g is not None and bool(g.any())),
              f"initialize: render gradient of {name}")
    del render_grads, aux
    out["initialize"] = run("initialize", loss_fn, params)

    # train_emitter: the radiance is the only leaf; the material is frozen
    loss_fn = make_train_emitter_loss(tracer, em, mat, crf, cfg)
    params = {"radiance": em.radiance.clone()}
    _, _, grads = value_and_grad(loss_fn, params, batch, gen)
    check(set(grads) == {"radiance"} and bool(grads["radiance"].any()),
          "train_emitter: gradient leaves")
    check(not mat.table.requires_grad and mat.table.grad is None,
          "train_emitter: the frozen material took a gradient")
    out["train_emitter"] = run("train_emitter", loss_fn, params)

    for has_part in (True, False):
        label = f"brdf_crf(has_part={has_part})"
        loss_fn = make_brdf_crf_loss(
            tracer, crf, LossConfig(has_part=has_part, la=0.1), -0.1, 2.1)
        params = {"material": train_config(ngp),
                  "crf_weight": crf.weight.clone()}
        _, _, grads = value_and_grad(loss_fn, params, batch, gen)
        for name in ("material.table", "material.mlp.w.0", "crf_weight"):
            check(name in grads and bool(torch.isfinite(grads[name]).all())
                  and bool(grads[name].any()), f"{label}: gradient {name}")
        del grads
        out[label] = run(label, loss_fn, params)
    return out


def train_reference_check(tracer, em, ngp, crf, dev, seed):
    """One small train step's loss and gradients (64 rays, spp 2, float32
    compact scatter) on the card and on the CPU under the same draws. Bar:
    loss within rtol 2e-3, every gradient leaf's cosine >= 0.999 (the bf16
    MLP sums round alike only on average, see small_reference_check)."""
    import numpy as np
    import torch

    from iris_tpu_torch.train.loop import value_and_grad

    rays = frame_rays(dev)[::127][:64]
    b, spp = rays.shape[0], 2
    n = b * spp
    rng = np.random.default_rng(seed + 3)

    def u(*shape):
        return torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))

    from iris_tpu_torch.models.hashgrid import auto_bwd_level_sample

    n_levels = ngp.cfg.n_levels
    stride = n_levels // auto_bwd_level_sample(n_levels)
    samples = {
        "render": {"dudv": u(2, b, spp, 1) - 0.5, "s1": u(n), "s2": u(n, 2),
                   "s1b": u(n), "s2b": u(n, 2)},
        "mat": {"u3": u(3, n * n_levels), "phase": int(rng.integers(
            0, stride))}}
    out = []
    for d in (dev, torch.device("cpu")):
        tr, e, g, c = (move(x, d) for x in (tracer, em, ngp, crf))
        tr.paired = tr.dense = None
        loss_fn = make_bench_loss(tr, e, c, rays.to(d), spp)
        loss, _, grads = value_and_grad(
            loss_fn, bench_params(e, g, c, scatter="float32"), {}, None,
            move(samples, d))
        out.append((float(loss), {k: v.double().cpu() for k, v in
                                  grads.items()}))
    (l_card, g_card), (l_cpu, g_cpu) = out
    check(abs(l_card - l_cpu) <= 2e-3 * abs(l_cpu),
          f"card vs CPU train loss: {l_card} vs {l_cpu}")
    check(set(g_card) == set(g_cpu), "card vs CPU gradient leaves differ")
    worst = 1.0
    for name, a in g_card.items():
        c = g_cpu[name]
        cos = float((a * c).sum() / (a.norm() * c.norm()).clamp(min=1e-300))
        check(cos >= 0.999, f"card vs CPU gradient {name}: cosine {cos}")
        worst = min(worst, cos)
    return l_card, l_cpu, worst, len(g_card)


def shipped_width(name):
    from iris_tpu_torch.geometry import cuda_intersect as ci

    return ci.STREAMED_PACKET if name == "trace_streamed" else ci.PACKET


def packet_configs(leaf_size):
    """{kernel: {width: packet_config}} of the three packet walks, and the
    lines that report them."""
    from iris_tpu_torch.geometry import cuda_intersect as ci

    out, lines = {}, []
    for name in PACKET_KERNELS:
        out[name] = {w: ci.packet_config(name, leaf_size, width=w)
                     for w in ci.PACKET_WIDTHS}
        check(ci.packet_config(name, leaf_size)["packet_width"]
              == shipped_width(name), f"{name}: the kernel ships another "
              "packet width than cuda_intersect.py")
        for w, c in out[name].items():
            warps = c["blocks_per_sm"] * c["threads_per_block"] // 32
            lines.append(
                f"occupancy {name} W={w}: {c['smem_bytes_per_block']} B "
                f"shared/block of {c['threads_per_block']} threads (limit "
                f"{c['smem_limit_bytes']} B), {c['registers']} registers, "
                f"{c['local_bytes_per_thread']} B local/thread -> "
                f"{c['blocks_per_sm']} blocks = {warps} warps per SM")
    return out, lines


def width_sweep(tracer, o, d, flush, reps=20):
    """Every instantiated packet width of the three packet walks on the
    same rays: the median of `reps` launches with the L2 flushed, in turns
    there and back. trace_streamed's hits are the per-ray walk's at every
    width, bit for bit (the pair walks' equal-t ties depend on the width;
    phase 3 holds each width against its plain version).
    Returns {kernel: {width: [ms there, ms back]}}."""
    import torch

    from iris_tpu_torch.geometry import cuda_intersect as ci

    want = ci.trace_union(tracer, o, d)
    for w in ci.PACKET_WIDTHS:
        got = ci.trace_streamed(tracer, o, d, width=w)
        torch.cuda.synchronize()
        check(all(torch.equal(g, x) for g, x in zip(got, want)),
              f"trace_streamed W={w} differs from trace_union")
    turns = [(name, w) for name in PACKET_KERNELS for w in ci.PACKET_WIDTHS]
    out = {}
    for name, w in turns + turns[::-1]:
        kernel = getattr(ci, name)
        ms = time_ms(lambda: kernel(tracer, o, d, width=w), reps, flush)
        out.setdefault(name, {}).setdefault(w, []).append(ms)
    return out


def report_sweep(sweep):
    """The sweep's lines, one per kernel: W -> ms there / back, the shipped
    width marked."""
    lines = []
    for name, by_w in sweep.items():
        cells = ", ".join(
            f"W={w} -> {t[0]:.4f} / {t[1]:.4f} ms"
            + (" (shipped)" if w == shipped_width(name) else "")
            for w, t in by_w.items())
        lines.append(f"sweep {name}: {cells}")
    return lines


def width_counts(tracer, o, d):
    """The plain versions' counters at every packet width on rays o, d."""
    from iris_tpu_torch.geometry import cuda_intersect as ci

    lines = []
    for name in PACKET_KERNELS:
        for w in ci.PACKET_WIDTHS:
            counts = {}
            getattr(ci, name + "_plain")(tracer, o, d, counts=counts, width=w)
            lines.append(f"counts {name} W={w} on {o.shape[0]} rays: "
                         + ", ".join(f"{k} {v}" for k, v in counts.items()))
    return lines


def printed_json(run):
    """(run()'s result, the JSON lines it printed, parsed); everything it
    printed is printed again here."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = run()
    text = buf.getvalue()
    sys.stdout.write(text)
    sys.stdout.flush()
    return result, [json.loads(ln) for ln in text.splitlines()
                    if ln.startswith("{")]


def positive(x) -> bool:
    return isinstance(x, (int, float)) and x > 0 and x != float("inf")


def scripts_phase(dev, train=None):
    """Phase 17: the port's twins of the four root scripts on the card, each
    through the call a user makes. `train` holds phase 6's stats, printed
    beside bench's rates. Returns the phase's stats."""
    import torch

    from iris_tpu_torch import (bench, bench_components, bench_scaling,
                                graft_entry)

    t_phase = time.perf_counter()
    stats = {}
    name = torch.cuda.get_device_name(0)

    # bench: the headline metric on the flagship and the 102K scene
    t0 = time.perf_counter()
    _, lines = printed_json(lambda: bench.main([]))
    check(len(lines) == 1, f"bench printed {len(lines)} JSON lines")
    line = lines[0]
    check(tuple(line) == BENCH_KEYS, f"bench keys {list(line)}")
    check(line["metric"] == "train_fwd_bwd_rays_per_s"
          and line["unit"] == "rays/s/chip", f"bench line {line}")
    check(positive(line["value"]) and positive(
        line["rays_per_s_102k_faces"]), f"bench rates {line}")
    check(line["kernel_mode_102k"] == "trace_paired_streamed",
          f"bench kernel_mode_102k {line['kernel_mode_102k']}")
    check(line["device"]["name"] == name, f"bench device {line['device']}")
    for label, kernel in (("flagship", "trace_union"),
                          ("clutter102k", "trace_paired_streamed")):
        run = line["runs"][label]
        check(run["launches"] == {kernel: 2 * run["calls"]},
              f"bench {label}: launches {run['launches']} in "
              f"{run['calls']} calls, expected 2 a call of {kernel}")
        check(len(run["s_per_call"]) == 3
              and all(positive(t) for t in run["s_per_call"]),
              f"bench {label}: per-replay times {run['s_per_call']}")
        ms = [round(t * 1e3, 3) for t in run["s_per_call"]]
        print(f"bench {label} ({run['faces']} faces, {kernel}): ms a call "
              f"in each timed graph replay {ms}; median "
              f"{statistics.median(ms):.3f}; {run['calls']} calls run")
    stats["bench"] = line
    stats["bench_s"] = time.perf_counter() - t0
    print(f"bench: {line['value']:.1f} camera samples/s (flagship), "
          f"{line['rays_per_s_102k_faces']:.1f} (102K), fwd+bwd with no "
          "optimizer on the demo's zero SLF", end="")
    if train is not None:
        print(f"; phase 6, fwd+bwd+Adam on a seeded SLF: "
              f"{train['flagship']['camera_samples_per_s']:.1f} / "
              f"{train['clutter102k']['camera_samples_per_s']:.1f}")
    else:
        print("; phase 6 not run")

    # bench_components: every component, peak device memory
    t0 = time.perf_counter()
    _, lines = printed_json(lambda: bench_components.main([]))
    check(tuple(ln["metric"] for ln in lines) == COMPONENTS,
          f"bench_components metrics {[ln['metric'] for ln in lines]}")
    for ln in lines:
        check(positive(ln["value"]) and positive(ln["ms"])
              and ln["device"]["name"] == name, f"component {ln}")
    stats["components"] = lines
    # each line's peak is its component's alone
    stats["components_peak_mb"] = max(ln["peak_mb"] for ln in lines)
    stats["components_s"] = time.perf_counter() - t0
    exact32 = lines[COMPONENTS.index(
        "hashgrid32_exact_fwd_bwd_queries_per_s")]
    print(f"bench_components: {len(lines)} components in "
          f"{stats['components_s']:.1f} s; peak device memory "
          f"{stats['components_peak_mb']:.1f} MB, of the 32-level exact "
          f"fwd+bwd (262,144 x 8 x 32 x 2 scatter rows) {exact32['peak_mb']}"
          " MB")

    # bench_scaling: its defaults, one NCCL rank on cuda:0
    t0 = time.perf_counter()
    _, lines = printed_json(lambda: bench_scaling.main([]))
    check(len(lines) == 1 and tuple(lines[0]) == SCALING_KEYS,
          f"bench_scaling lines {lines}")
    ln = lines[0]
    check(ln["metric"] == "scaling_rays_per_s" and ln["devices"] == 1
          and ln["backend"] == "nccl" and positive(ln["value"])
          and ln["efficiency_vs_linear"] == 1.0, f"bench_scaling {ln}")
    stats["scaling"] = ln
    stats["scaling_s"] = time.perf_counter() - t0

    # graft_entry: the forward on the card, then two gloo ranks sharing
    # cuda:0 against the same step with no group
    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    with torch.no_grad():
        out = fn(*args)
    check(tuple(out.shape) == (1024, 3) and bool(torch.isfinite(out).all())
          and float(out.min()) >= 0 and float(out.max()) <= 1,
          f"entry forward: {tuple(out.shape)}, [{float(out.min())}, "
          f"{float(out.max())}]")
    print(f"entry forward: {tuple(out.shape)} mean {float(out.mean()):.6f}")
    loss = graft_entry.dryrun_multichip(2, backend="gloo")
    ref = graft_entry.dryrun_step(2, device=dev)
    check(abs(loss - ref) <= 1e-4 * abs(ref),
          f"dryrun: two ranks' loss {loss} against no group's {ref}")
    print(f"dryrun: two gloo ranks on cuda:0 {loss:.8f}, no group "
          f"{ref:.8f}")
    stats["graft"] = {"entry_mean": float(out.mean()), "dryrun_loss": loss,
                      "no_group_loss": ref}
    stats["graft_s"] = time.perf_counter() - t0
    stats["total_s"] = time.perf_counter() - t_phase
    print(f"phase 17: {stats['total_s']:.1f} s (bench {stats['bench_s']:.1f}"
          f", components {stats['components_s']:.1f}, scaling "
          f"{stats['scaling_s']:.1f}, graft {stats['graft_s']:.1f})")
    return stats


class time_captures:
    """While active, the host seconds of each CUDA graph capture
    (utils.graphs.Graph.capture_s), a list."""

    def __enter__(self):
        from iris_tpu_torch.utils import graphs

        times = []

        class CaptureTimer:
            def captured(self, graph):
                times.append(graph.capture_s)

            def replayed(self, graph, seeds, start, end):
                pass

        self._observing = graphs.observing(CaptureTimer())
        self._observing.__enter__()
        return times

    def __exit__(self, *exc):
        self._observing.__exit__(*exc)


def state_digest(params, opt_state):
    """One int64 device digest a tensor (parallel.distributed.bits_digest;
    no host sync) of every parameter leaf, every optimizer-state tensor
    (moments and step counts), the schedule's step count and its rates."""
    import torch

    from iris_tpu_torch.parallel.distributed import bits_digest
    from iris_tpu_torch.train.optim import named_leaves

    ts = [t for _, t in named_leaves(params)]
    for st in opt_state["opt"].state.values():
        ts += [st[k] for k in sorted(st) if isinstance(st[k], torch.Tensor)]
    sched = opt_state["sched"]
    ts += [sched.last_epoch] + list(sched.lrs)
    return torch.cat([bits_digest(t) for t in ts])


def chunk_run(label, tracer, em, ngp, crf, rays, chunk, seed):
    """Phase 18 (a), one run: the benchmark loss with Adam through
    run_training, CHUNK_STEPS steps at chunk_steps `chunk` from fresh
    parameters, a rate cut at CHUNK_MILESTONE. Keeps every loss, the
    state's digest at each chunk's last step, each step's CUDA-event ms,
    the launches, peak memory (and its rise above what the process held
    at the start) and the captures' host seconds."""
    import itertools

    import torch

    from iris_tpu_torch.train.loop import run_training
    from iris_tpu_torch.train.optim import make_optimizer

    params = bench_params(em, ngp, crf)
    loss_fn = make_bench_loss(tracer, em, crf, rays, TRAIN_SPP)
    opt = make_optimizer(learning_rate=1e-3, milestones=(CHUNK_MILESTONE,))
    losses, digests = [], {}
    ends = set(range(CHUNK - 1, CHUNK_STEPS, CHUNK))

    def keep(step, p, o):
        if step in ends:
            digests[step] = state_digest(p, o)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_launches()
    with time_train_steps() as steps, time_captures() as captures:
        t0 = time.perf_counter()
        run_training(loss_fn, params, itertools.repeat({}), opt, CHUNK_STEPS,
                     seed, log_fn=None,
                     hooks=[lambda s, p, loss, a: losses.append(loss)],
                     state_hooks=[keep], chunk_steps=chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"losses": [float(x) for x in losses],
            "digests": {s: d.cpu() for s, d in digests.items()},
            "step_ms": steps.step_ms(), "graphed_ms": steps.graphed_ms(),
            "launches": read_launches(), "capture_s": captures,
            "peak_memory_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
            "peak_rise_mb": (torch.cuda.max_memory_allocated() - held)
            / 2 ** 20, "wall_s": wall}


def chunk_profile(tracer, em, ngp, crf, rays, seed):
    """A fresh make_train_chunk of CHUNK steps of the benchmark loss: its
    eager warm-up chunk, then (after the capture) one replay, each under
    torch.profiler and between CUDA events: the host's launch calls
    (kernel launches and graph launches), the card's kernels and their
    device time, the chunk's event ms, and the device's idle share of
    it."""
    from iris_tpu_torch.train.loop import make_train_chunk
    from iris_tpu_torch.train.optim import make_optimizer

    params = bench_params(em, ngp, crf)
    loss_fn = make_bench_loss(tracer, em, crf, rays, TRAIN_SPP)
    opt = make_optimizer(learning_rate=1e-3)
    state = opt.init(params)
    chunk = make_train_chunk(loss_fn, opt, CHUNK)
    batches = [{}] * CHUNK
    out = {}

    out["eager"] = profiled_run(
        lambda: chunk(params, state, batches, seed, 0))
    chunk(params, state, batches, seed, CHUNK)       # capture, then replay
    out["graphed"] = profiled_run(
        lambda: chunk(params, state, batches, seed, 2 * CHUNK))
    out["bare"] = bare_replay_calls(CHUNK, rays.device)
    return out


def profiled_run(fn):
    """fn() once under torch.profiler and between CUDA events: the host's
    launch calls (launch_calls), the traversal launches the kernels
    counted, the card's kernels and their busy ms, the ms under the
    profiler and the idle share against them."""
    from torch.profiler import ProfilerActivity, profile

    from profile_render import device_kernels, device_time_us

    before = read_launches()        # waits for the card
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ms, _ = timed_once(fn)
    rec = launch_calls(prof)
    rec.update(ms_under_profiler=ms, traversal_launches=sum(
        v - before[k] for k, v in read_launches().items()))
    try:
        kernels = device_kernels(prof)
    except RuntimeError:        # the profiler saw no device kernel
        rec.update(device_busy_ms="not measured", idle_share="not measured")
    else:
        busy = sum(device_time_us(e) for e in kernels) / 1e3
        rec.update(device_busy_ms=busy, kernels=sum(e.count for e in kernels),
                   idle_share=max(0.0, 1 - busy / ms))
    return rec


def launch_calls(prof):
    """The host's kernel-launch and graph-launch calls that torch.profiler
    saw."""
    calls = {e.key: e.count for e in prof.key_averages()
             if e.key in LAUNCH_CALLS + ("cudaGraphLaunch",)}
    return {"launch_calls": calls,
            "kernel_launch_calls": sum(calls.get(k, 0)
                                       for k in LAUNCH_CALLS),
            "graph_launch_calls": calls.get("cudaGraphLaunch", 0)}


def bare_replay_calls(n_gens, device):
    """The host's launch calls (launch_calls) of one replay, under
    torch.profiler, of a graph that holds n_gens registered generators,
    one draw from each, and nothing else: what a replay costs the host
    beside its graph launch whatever the graph runs (before it launches
    the graph, CUDAGraph.replay refills each registered generator's seed
    and offset tensors on the card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from iris_tpu_torch.utils.graphs import GraphContext

    ctx = GraphContext(device)
    gens = [torch.Generator(device=device).manual_seed(i)
            for i in range(n_gens)]

    def draws():
        return torch.stack([torch.rand((), generator=g, device=device)
                            for g in gens])

    with ctx.on_stream():
        draws()
    ctx.warm = True
    graph = ctx.capture(draws, gens)
    graph.replay(range(n_gens))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graph.replay(range(1, n_gens + 1))
        torch.cuda.synchronize()
    return launch_calls(prof)


def chunk_scan_check(label, tracer, em, ngp, crf, rays, seed):
    """Phase 18 (c): utils.timing.bench_scan of CHUNK_SCAN_ITERS calls of
    bench.grad_step in one CUDA graph; its last timed replay's scalar
    against the same calls run eagerly under the same generators, bit for
    bit. Returns (the scalar, bench_scan's ms a call)."""
    import torch

    from iris_tpu_torch import bench
    from iris_tpu_torch.utils import graphs, timing

    step = bench.grad_step(make_bench_loss(tracer, em, crf, rays, TRAIN_SPP),
                           bench_params(em, ngp, crf))
    kept = []

    class Keep:
        def captured(self, graph):
            pass

        def replayed(self, graph, seeds, start, end):
            kept.append((list(seeds), graph.outputs.clone()))

    with graphs.observing(Keep()):
        dt = timing.bench_scan(step, seed, iters=CHUNK_SCAN_ITERS,
                               device=rays.device)
    seeds, got = kept[-1]
    acc = torch.zeros((), device=rays.device)
    for s in seeds:
        acc = step(torch.Generator(device=rays.device).manual_seed(s)) \
            + acc * 1e-12
    check(seeds == [seed + i for i in range(CHUNK_SCAN_ITERS)]
          and torch.equal(got, acc),
          f"{label}: bench_scan's graph gave {got.item()!r}, the eager "
          f"calls {acc.item()!r}")
    return got.item(), dt * 1e3


def chunk_initialize(root, bake, dev):
    """Phase 18 (b): initialize.main at phase 11's settings (batch 8,192,
    SPP 128 at spp 32, the 4 x 16 x 2^19 row-mode grid) on the flagship
    dataset, CHUNK_INIT_STEPS steps at --chunk_steps 10 and at 1, in a
    directory of its own: the same losses and checkpoint bits. Returns
    the two runs' stats."""
    from iris_tpu_torch.pipeline import initialize

    args = ["--dataset", "synthetic", root, "--ldr_img_dir", "ldr",
            "--device", str(dev), "--crf_basis", "3", "--has_part", "1",
            "--batch_size", str(PIPE_BATCH), "--val_step",
            str(CHUNK_INIT_STEPS), "--save_every", str(CHUNK),
            "--hash_levels", str(PRODUCTION_GRID["hash_levels"]),
            "--hash_features", str(PRODUCTION_GRID["hash_features"]),
            "--log2_hashmap_size", str(LOG2_TABLE), "--SPP", str(PIPE_SPP),
            "--spp", str(TRAIN_SPP), "--voxel_path",
            os.path.join(bake, "vslf.npz"), "--emitter_path",
            os.path.join(bake, "emitter.npz"), "--max_steps",
            str(CHUNK_INIT_STEPS)]
    samples = PIPE_BATCH * PIPE_SPP
    work = os.path.join(CHUNK_DIR, "initialize")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    here = os.getcwd()
    os.chdir(work)
    try:
        runs = {}
        for chunk in (CHUNK, 1):
            with time_captures() as captures:
                runs[chunk], _ = run_trainer(
                    initialize, args + ["--chunk_steps", str(chunk),
                                        "--experiment_name", f"c{chunk}"],
                    CHUNK_INIT_STEPS, samples)
            runs[chunk]["capture_s"] = captures
        a, b = (train_log(os.path.join("outputs", f"c{c}",
                                       "train_log.jsonl"))
                for c in (CHUNK, 1))
        check(len(a) == CHUNK_INIT_STEPS and a == b,
              f"initialize --chunk_steps {CHUNK}: losses {a} differ from "
              f"--chunk_steps 1's {b}")
        for f in ("last.pkl", "last_state.pkl"):
            check(same_pickle(os.path.join("checkpoints", f"c{CHUNK}", f),
                              os.path.join("checkpoints", "c1", f)),
                  f"initialize --chunk_steps {CHUNK}: {f} differs from "
                  "--chunk_steps 1's")
    finally:
        os.chdir(here)
    return runs


def chunks_phase(dev, seed, scenes, root, bake, bench_runs=None):
    """Phase 18, one-dispatch chunks, printed. `scenes` are (label,
    kernel, (tracer, em, ngp, crf, mesh)) of the flagship and the 102K
    scene; root and bake the flagship dataset and its SLF and emitter;
    bench_runs phase 17's bench line (None: bench.measure runs here).
    Returns the phase's stats (their launches under "launches")."""
    import torch

    from iris_tpu_torch import bench

    t_phase = time.perf_counter()
    card = card_line()
    rays = frame_rays(dev)
    stats = {"launches": {k: 0 for k in KERNELS}}
    for label, kernel, (tracer, em, ngp, crf, _) in scenes:
        runs = {c: chunk_run(label, tracer, em, ngp, crf, rays, c, seed)
                for c in (CHUNK, 1)}
        g, e = runs[CHUNK], runs[1]
        for r in runs.values():
            check(only_launched(r["launches"], kernel, 2 * CHUNK_STEPS),
                  f"chunks {label}: launches {r['launches']}, "
                  f"{2 * CHUNK_STEPS} of {kernel} alone expected")
            for k, v in r["launches"].items():
                stats["launches"][k] += v
        check(g["losses"] == e["losses"] and len(g["losses"]) ==
              CHUNK_STEPS, f"chunks {label}: graphed losses differ from "
              "the eager steps'")
        for s in sorted(g["digests"]):
            check(torch.equal(g["digests"][s], e["digests"][s]),
                  f"chunks {label}: the state after step {s} differs "
                  "from the eager steps' (parameters, moments, schedule)")
        check(len(g["graphed_ms"]) == CHUNK_STEPS // CHUNK - 1
              and len(g["capture_s"]) == 1,
              f"chunks {label}: {len(g['graphed_ms'])} replays, "
              f"{len(g['capture_s'])} captures")
        reset_launches()
        prof = chunk_profile(tracer, em, ngp, crf, rays, seed)
        eager_ms = statistics.median(e["step_ms"][CHUNK:])
        graphed_ms = statistics.median(g["graphed_ms"])
        st = {"eager_ms_per_step": eager_ms,
              "graphed_ms_per_step": graphed_ms,
              "graphed_chunk_ms": [m * CHUNK for m in g["graphed_ms"]],
              "replays_at_step0": list(range(CHUNK, CHUNK_STEPS, CHUNK)),
              "launches_per_chunk": {k: v * CHUNK // CHUNK_STEPS for k, v
                                     in g["launches"].items() if v},
              "eager_peak_memory_mb": e["peak_memory_mb"],
              "graphed_peak_memory_mb": g["peak_memory_mb"],
              "eager_peak_rise_mb": e["peak_rise_mb"],
              "graphed_peak_rise_mb": g["peak_rise_mb"],
              "capture_s": g["capture_s"][0], "profile": prof,
              "eager_wall_s": e["wall_s"], "graphed_wall_s": g["wall_s"]}
        for name in ("eager", "graphed"):
            rec = prof[name]
            busy = rec["device_busy_ms"]
            if isinstance(busy, float):
                chunk_ms = CHUNK * (eager_ms if name == "eager"
                                    else graphed_ms)
                rec["idle_share_unprofiled"] = max(0.0, 1 - busy / chunk_ms)
        stats[label] = st
        print(f"chunks {label} ({kernel}; {card}): {CHUNK_STEPS} steps of "
              f"the benchmark loss with Adam, chunks of {CHUNK} graphed "
              f"against single steps from the same state, a rate cut at "
              f"step {CHUNK_MILESTONE}: losses, parameters, moments and "
              f"schedule the same bits after every chunk (one capture "
              f"replayed at step0 {st['replays_at_step0']}); ms a step "
              f"eager {eager_ms:.3f}, graphed {graphed_ms:.3f} (chunk ms "
              f"{[round(m, 3) for m in st['graphed_chunk_ms']]}); launches "
              f"a chunk {st['launches_per_chunk']}; peak memory eager "
              f"{e['peak_memory_mb']:.0f} MB, graphed "
              f"{g['peak_memory_mb']:.0f} MB (above the run's start "
              f"{e['peak_rise_mb']:.0f} / {g['peak_rise_mb']:.0f} MB); "
              f"capture "
              f"{st['capture_s']:.3f} s")
        for name in ("eager", "graphed"):
            rec = prof[name]
            print(f"chunks {label} {name} chunk under torch.profiler: host "
                  f"kernel-launch calls {rec['kernel_launch_calls']}, graph "
                  f"launches {rec['graph_launch_calls']}, traversal "
                  f"launches the kernels counted {rec['traversal_launches']}"
                  f", device busy {rec['device_busy_ms']} ms of "
                  f"{rec['ms_under_profiler']:.3f} ms, idle share "
                  f"{rec['idle_share']} (against the unprofiled chunk "
                  f"{rec.get('idle_share_unprofiled', 'not measured')})")
        bare = prof["bare"]
        print(f"chunks {label}: a replay of a graph of {CHUNK} registered "
              f"generators and nothing else: host kernel-launch calls "
              f"{bare['kernel_launch_calls']} ({bare['launch_calls']})")
        check(prof["graphed"]["graph_launch_calls"] == 1,
              f"chunks {label}: a replayed chunk made "
              f"{prof['graphed']['graph_launch_calls']} graph launches")
        check(prof["graphed"]["kernel_launch_calls"]
              == bare["kernel_launch_calls"],
              f"chunks {label}: a replayed chunk made "
              f"{prof['graphed']['kernel_launch_calls']} kernel-launch "
              f"calls from the host, a graph of its generators alone "
              f"{bare['kernel_launch_calls']}")
        for name in ("eager", "graphed"):
            check(prof[name]["traversal_launches"] == 2 * CHUNK,
                  f"chunks {label}: the kernels counted "
                  f"{prof[name]['traversal_launches']} launches in the "
                  f"{name} chunk, {2 * CHUNK} expected")
        value, scan_ms = chunk_scan_check(label, tracer, em, ngp, crf, rays,
                                          seed)
        for k, v in read_launches().items():
            stats["launches"][k] += v
        stats[label].update(scan_value=value, scan_ms_per_call=scan_ms)
        print(f"chunks {label}: bench_scan's graph of {CHUNK_SCAN_ITERS} "
              f"grad_step calls = the eager calls' bits ({value!r}); "
              f"{scan_ms:.3f} ms a call")

    # (b) initialize at phase 11's settings
    stats["initialize"] = chunk_initialize(root, bake, dev)
    for chunk, st in stats["initialize"].items():
        for k, v in st["launches"].items():
            stats["launches"][k] += v
        print(f"chunks initialize --chunk_steps {chunk} ({card}): "
              f"{st['steps']} steps, {st['ms_per_step']:.2f} ms/step "
              f"(median after the first chunk), "
              f"{st['camera_samples_per_s']:.0f} camera samples/s, peak "
              f"memory {st['peak_memory_mb']:.0f} MB, captures "
              f"{[round(c, 3) for c in st['capture_s']]} s, "
              f"{st['wall_s']:.1f} s in all")
    print(f"chunks initialize: --chunk_steps {CHUNK} gives --chunk_steps "
          f"1's {CHUNK_INIT_STEPS} losses and checkpoint bits")

    # (c) bench's figures with the graphed bench_scan
    if bench_runs is None:
        reset_launches()
        bench_runs = {
            "flagship": bench.measure(bench.FLAGSHIP, bench.ITERS, dev),
            "clutter102k": bench.measure(bench.CLUTTER_102K,
                                         bench.ITERS_102K, dev)}
        for k, v in read_launches().items():
            stats["launches"][k] += v
    for label, run in bench_runs.items():
        ms = [round(t * 1e3, 3) for t in run["s_per_call"]]
        print(f"chunks bench.measure {label} ({run['faces']} faces, "
              f"{run['kernel_mode']}; {card}): ms a call by replay {ms}, "
              f"{run['calls']} calls, launches {run['launches']}")
    stats["bench"] = bench_runs
    stats["phase_s"] = time.perf_counter() - t_phase
    print(f"chunks: phase 18 took {stats['phase_s']:.1f} s")
    return stats


def chunks_dataset(dev, seed):
    """The flagship dataset with its SLF and emitter mask, as phase 10 and
    phase 11 write them (--chunks-only): (root, bake)."""
    from iris_tpu_torch.data.make_demo_dataset import make_dataset
    from iris_tpu_torch.pipeline import extract_emitter, slf_bake

    label, n_clutter, _, orbit = STAGE_DATASETS[0]
    root = os.path.join(STAGE_DIR, label)
    bake = os.path.abspath(os.path.join(CHUNK_DIR, "bake"))
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(bake, ignore_errors=True)
    make_dataset(root, img_hw=STAGE_HW, n_train=STAGE_SPLITS[0],
                 n_val=STAGE_SPLITS[1], spp=STAGE_GEN_SPP,
                 indir_depth=STAGE_GEN_DEPTH, n_clutter=n_clutter, seed=seed,
                 orbit=orbit, device=dev)
    common = ["--dataset", "synthetic", "--scene", root, "--ldr_img_dir",
              "ldr", "--device", str(dev), "--output", bake]
    slf_bake.main(common + ["--voxel_num", str(STAGE_VOXELS)])
    extract_emitter.main(common + ["--threshold", "0.99"])
    return os.path.abspath(root), bake


def frame_240x320(dev):
    """(240 x 320 rays (76,800, 12) on dev, as numpy too): the first 240
    rows of camera_rays(320), a frame of phase 11's datasets' size."""
    import numpy as np
    import torch

    from iris_tpu_torch.geometry.procedural import camera_rays

    h, w = STAGE_HW
    rays = np.concatenate(camera_rays(w), -1).astype(np.float32)[:h * w]
    return torch.from_numpy(rays).to(dev), rays


def same_bits(got, want):
    import torch

    return len(got) == len(want) and all(
        torch.equal(a, b) for a, b in zip(got, want))


def events_ms(fn, n):
    """fn() n times, each between two CUDA events: their ms."""
    import torch

    marks = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in marks]


def peak_mb():
    import torch

    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2 ** 20


def fresh_peak():
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def idle_against(rec, ms):
    """The profiled run's busy ms against an unprofiled run's ms."""
    busy = rec["device_busy_ms"]
    return (max(0.0, 1 - busy / ms) if isinstance(busy, float)
            else "not measured")


def render_round_check(label, kernel, tracer, em, ngp, rays, seed, bare):
    """Phase 19 (a) on one scene: the render round (render_chunk +
    aov_chunk, spp 8, depth 5) eager and as the CLIs run it
    (make_render_round: an eager warm-up, a capture, replays), bit for bit
    over 2 frames x RENDER_ROUNDS rounds and through render_frame; ms a
    round each way (CUDA events, RENDER_TIMED rounds), one round of each
    under torch.profiler (host launch calls, traversal launches the
    kernels counted, busy and idle), capture s and peak MB."""
    import numpy as np
    import torch

    from iris_tpu_torch.demo import demo_mat_fn
    from iris_tpu_torch.pipeline.render import (
        make_render_fns, make_render_round, render_frame)

    dev = rays.device
    rc, ac = make_render_fns(tracer, em, demo_mat_fn(ngp), SPP, INDIR_DEPTH)

    def eager(gen):
        return (rc(rays, gen),) + tuple(ac(rays, gen))

    fresh_peak()
    gen = torch.Generator(device=dev).manual_seed(seed)
    eager(gen)                                      # warm-up
    eager_ms = events_ms(lambda: eager(gen), RENDER_TIMED)
    eager_peak = peak_mb()

    fresh_peak()
    with time_captures() as captures:
        unit = make_render_round(rc, ac, dev)
        for f in range(2):
            gen = torch.Generator(device=dev).manual_seed(seed + f)
            for rd in range(RENDER_ROUNDS):
                got = [x.clone() for x in unit(
                    rays, seed=seed + f if rd == 0 else None)]
                check(same_bits(got, eager(gen)),
                      f"renders {label}: frame {f} round {rd}: the "
                      "graphed round differs from the eager round")
    # render_frame, the CLIs' path: the eager rounds' mean, bit for bit
    l_img, aovs = render_frame(unit, rays, RENDER_ROUNDS, seed + 2)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    acc = None
    for _ in range(RENDER_ROUNDS):
        out = eager(gen)
        acc = list(out) if acc is None else [a + b for a, b in zip(acc, out)]
    want = [(x / RENDER_ROUNDS).cpu().numpy() for x in acc]
    check(all(np.array_equal(a, b) for a, b in zip([l_img] + aovs, want)),
          f"renders {label}: render_frame's image and AOVs differ from "
          "the eager rounds'")
    graphed_ms = events_ms(lambda: unit(rays), RENDER_TIMED)
    graphed_peak = peak_mb()
    gen = torch.Generator(device=dev).manual_seed(seed)
    prof = {"eager": profiled_run(lambda: eager(gen)),
            "graphed": profiled_run(lambda: unit(rays))}
    st = {"kernel": kernel, "rays": rays.shape[0], "spp": SPP,
          "depth": INDIR_DEPTH,
          "eager_ms_per_round": statistics.median(eager_ms),
          "graphed_ms_per_round": statistics.median(graphed_ms),
          "eager_round_ms": eager_ms, "graphed_round_ms": graphed_ms,
          "eager_peak_memory_mb": eager_peak,
          "graphed_peak_memory_mb": graphed_peak,
          "capture_s": captures, "profile": prof, "bare": bare}
    for name in ("eager", "graphed"):
        prof[name]["idle_share_unprofiled"] = idle_against(
            prof[name], st[f"{name}_ms_per_round"])
        check(prof[name]["traversal_launches"] == 2 + INDIR_DEPTH + 1,
              f"renders {label}: the kernels counted "
              f"{prof[name]['traversal_launches']} launches in the {name} "
              f"round, {2 + INDIR_DEPTH + 1} expected")
    check(len(captures) == 1, f"renders {label}: {len(captures)} captures")
    check(prof["graphed"]["graph_launch_calls"] == 1
          and prof["graphed"]["kernel_launch_calls"]
          == bare["kernel_launch_calls"],
          f"renders {label}: a replayed round made "
          f"{prof['graphed']['graph_launch_calls']} graph launches and "
          f"{prof['graphed']['kernel_launch_calls']} kernel-launch calls, "
          f"a graph of its generator alone {bare['kernel_launch_calls']}")
    return st


def relight_round_check(label, kernel, mesh, em, ngp, seed):
    """Phase 19 (b) on one scene: a relight_1-shaped round (the scene's
    mesh with the learned BRDF and its emitters, relight_1's disco ball:
    40 lights and 40 spots, D = 7; a 240 x 320 frame at spp 8) over
    RELIGHT_ROUND_PHASES frames of 2 rounds, the ball turned in place
    between frames: each round as make_relight_round runs it against
    relight_path_tracing on set_disco_phase's new scene under the same
    generator, bit for bit; ms a round each way, launches a replay, capture
    s and peak MB."""
    import numpy as np
    import torch

    from iris_tpu_torch.pipeline.render_relight import (
        make_relight_round, relight_generator, relight_seed)
    from iris_tpu_torch.render import relight as R

    dev = em.radiance.device
    rays, _ = frame_240x320(dev)
    disco, spots = R.make_disco_ball(
        RELIGHT_DISCO_POSITION, 0.2, 40.0, light_num=RELIGHT_ROUND_SPOTS,
        light_radius_rate=0.1, spot_intensity=0.5, spot_cutoff_angle=20.0,
        device=dev)
    scene0 = R.build_relight_scene(
        [{"kind": "mesh", "tris": mesh.triangles(),
          "bsdf": {"type": "fipt"}}], ngp=ngp,
        main_is_emitter=em.is_emitter.cpu().numpy(),
        main_emitter_radiance=em.radiance.cpu().numpy(),
        dynamic_shapes=disco, dynamic_center=RELIGHT_DISCO_POSITION,
        device=dev)
    live = R.set_disco_phase(scene0, spots, 0.0)
    per_round = 1 + RELIGHT_ROUND_DEPTH * 3
    want_launches = dict.fromkeys(KERNELS, 0)
    want_launches[kernel] += per_round
    want_launches["trace_union"] += per_round

    def eager(scene, gen):
        return R.relight_path_tracing(
            gen, scene, rays[..., :3], rays[..., 3:6], rays[..., 6:9],
            rays[..., 9:12], RELIGHT_SPP_ROUND, RELIGHT_ROUND_DEPTH)

    fresh_peak()
    eager_ms, graphed_ms, frames, launches = [], [], [], []
    with time_captures() as captures:
        unit = make_relight_round(live, RELIGHT_SPP_ROUND,
                                  RELIGHT_ROUND_DEPTH, dev)
        for i, phase in enumerate(RELIGHT_ROUND_PHASES):
            R.set_disco_phase(scene0, spots, phase, out=live)
            moved = R.set_disco_phase(scene0, spots, phase)
            for rd in range(2):
                before = read_launches()
                ms, out = timed_once(lambda: unit(
                    rays, seed=relight_seed(i, rd)).clone())
                if i:           # past the warm-up and the capture
                    graphed_ms.append(ms)
                    launches.append({k: v - before[k] for k, v in
                                     read_launches().items()})
                ms, want = timed_once(lambda: eager(
                    moved, relight_generator(i, rd, dev)))
                eager_ms.append(ms)
                check(torch.equal(out, want), f"relight rounds {label}: "
                      f"frame {i} (phase {phase}) round {rd}: the graphed "
                      "round differs from the eager round")
            frames.append(out)
    peak = peak_mb()
    check(not torch.equal(frames[0], frames[1]),
          f"relight rounds {label}: the disco frames do not differ")
    check(len(captures) == 1 and all(x == want_launches for x in launches),
          f"relight rounds {label}: {len(captures)} captures, launches a "
          f"replay {launches}, {want_launches} expected")
    return {"kernel": kernel, "rays": rays.shape[0],
            "spp": RELIGHT_SPP_ROUND, "depth": RELIGHT_ROUND_DEPTH,
            "spots": RELIGHT_ROUND_SPOTS, "phases": RELIGHT_ROUND_PHASES,
            "eager_ms_per_round": statistics.median(eager_ms),
            "graphed_ms_per_round": statistics.median(graphed_ms),
            "eager_round_ms": eager_ms, "graphed_round_ms": graphed_ms,
            "launches_per_replay": {k: v for k, v in launches[0].items()
                                    if v},
            "peak_memory_mb": peak, "capture_s": captures,
            "static_faces": scene0.tracer.n_faces,
            "sub_scene_faces": scene0.dyn_tracer.n_faces,
            "frame_means": [float(np.mean(f.cpu().numpy())) for f in frames]}


def eager_validation(tracer, em, params, rays, step):
    """The validation frame as the hook rendered it eagerly: per chunk of
    VAL_CHUNK rays, path_tracing_single then path_tracing from
    val_generator(step, c)."""
    import functools

    import torch

    from iris_tpu_torch.core.vecmath import normalize
    from iris_tpu_torch.models.brdf import ngp_brdf_apply
    from iris_tpu_torch.render.integrator import (
        path_tracing, path_tracing_single)
    from iris_tpu_torch.train.validation import VAL_CHUNK, val_generator

    em = dataclasses.replace(em, radiance=params["radiance"])
    mat_fn = functools.partial(ngp_brdf_apply, params["material"])
    lt, lf = [], []
    with torch.no_grad():
        for c, rc in enumerate(torch.split(rays, VAL_CHUNK)):
            gen = val_generator(step, c, rays.device)
            xs, ds = rc[:, :3], normalize(rc[:, 3:6])
            lt.append(path_tracing_single(gen, tracer, em, mat_fn, xs, ds,
                                          rc[:, 6:9], rc[:, 9:12], TRAIN_SPP))
            lf.append(path_tracing(gen, tracer, em, mat_fn, xs, ds,
                                   rc[:, 6:9], rc[:, 9:12], TRAIN_SPP,
                                   INDIR_DEPTH))
    return torch.cat(lt), torch.cat(lf)


def validation_check(label, tracer, em, ngp, crf, rays, seed):
    """Phase 19 (c) on one scene: the trainers' validation render (a 240 x
    320 frame, spp 32, depth 5: 9 chunks of 8,192 rays and one of 3,072)
    through make_validation_hook with a GraphContext shared with a
    make_train_chunk of 2 steps of the benchmark loss with Adam, as the
    trainer CLIs share it: after the chunk's eager warm-up, then after
    each of two replayed chunks (an in-place parameter update each), the
    hook's images against the eager render of the same parameters, bit for
    bit; s a render each way, capture s, peak MB."""
    import numpy as np
    import torch

    from iris_tpu_torch.train.loop import make_train_chunk
    from iris_tpu_torch.train.optim import make_optimizer, named_leaves
    from iris_tpu_torch.train.validation import make_validation_hook
    from iris_tpu_torch.utils.graphs import GraphContext

    dev = rays.device
    val_rays, val_np = frame_240x320(dev)
    p = bench_params(em, ngp, crf)
    params = {"material": p["material"], "radiance": p["radiance"],
              "crf_weight": p["crf_w"]}
    bench_loss = make_bench_loss(tracer, em, crf, rays, TRAIN_SPP)

    def loss_fn(q, batch, gen, samples=None):
        return bench_loss({"material": q["material"],
                           "radiance": q["radiance"],
                           "crf_w": q["crf_weight"]}, batch, gen, samples)

    fresh_peak()
    ctx = GraphContext(dev)
    opt = make_optimizer(learning_rate=1e-2)
    state = opt.init(params)
    chunk = make_train_chunk(loss_fn, opt, 2, graphs=ctx)
    out_dir = os.path.join(RENDERS_DIR, label, "val")
    hook = make_validation_hook(
        tracer, em, crf, {"rays": val_np,
                          "rgbs": np.zeros_like(val_np[:, :3])},
        STAGE_HW, out_dir, val_step=VAL_RENDER_STEPS[1], spp=TRAIN_SPP,
        indir_depth=INDIR_DEPTH, graphs=ctx)
    graphed_s, eager_s, digests = [], [], []
    with time_captures() as captures:
        for k, step in enumerate(VAL_RENDER_STEPS):
            chunk(params, state, [{}] * 2, seed, 2 * k)
            digests.append(torch.cat([t.reshape(-1).float() for _, t in
                                      named_leaves(params)]).sum().item())
            t0 = time.perf_counter()
            lt, lf, _ = hook.render(params, step)
            torch.cuda.synchronize()
            graphed_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            wt, wf = eager_validation(tracer, em, params, val_rays, step)
            wt, wf = wt.cpu().numpy(), wf.cpu().numpy()
            eager_s.append(time.perf_counter() - t0)
            check(np.array_equal(lt, wt) and np.array_equal(lf, wf),
                  f"validation {label} at step {step}: the graphed render "
                  "differs from the eager render")
        hook(VAL_RENDER_STEPS[-1], params, 0.0, {})     # the PNGs
    peak = peak_mb()
    check(len(set(digests)) == len(digests),
          f"validation {label}: the chunks left the parameters as they were")
    check(len(captures) == 3,
          f"validation {label}: {len(captures)} captures, 3 expected (the "
          "chunk, the 8,192-ray chunks, the last chunk)")
    check(len(os.listdir(out_dir)) == 4,
          f"validation {label}: files {sorted(os.listdir(out_dir))}")
    return {"rays": val_rays.shape[0], "spp": TRAIN_SPP,
            "depth": INDIR_DEPTH, "steps": list(VAL_RENDER_STEPS),
            "graphed_s": graphed_s, "eager_s": eager_s,
            "capture_s": captures, "peak_memory_mb": peak}


def renders_phase(dev, seed, scenes):
    """Phase 19, one-dispatch rendering, printed. `scenes` are (label,
    kernel, (tracer, em, ngp, crf, mesh)) of the flagship and the 102K
    scene. Returns the phase's stats (their launches under
    "launches")."""
    t_phase = time.perf_counter()
    card = card_line()
    rays = frame_rays(dev)
    reset_launches()
    bare = bare_replay_calls(1, dev)
    stats = {"bare": bare}
    for label, kernel, (tracer, em, ngp, crf, mesh) in scenes:
        st = stats[label] = {
            "round": render_round_check(label, kernel, tracer, em, ngp,
                                        rays, seed, bare)}
        r = st["round"]
        print(f"renders {label} ({kernel}; {card}): a round of "
              f"{r['rays']} rays at spp {SPP}, depth {INDIR_DEPTH}, graphed "
              f"= eager bit for bit over 2 frames x {RENDER_ROUNDS} rounds "
              f"and through render_frame; ms a round eager "
              f"{r['eager_ms_per_round']:.3f}, graphed "
              f"{r['graphed_ms_per_round']:.3f} (median of {RENDER_TIMED});"
              f" peak memory eager {r['eager_peak_memory_mb']:.0f} MB, "
              f"graphed {r['graphed_peak_memory_mb']:.0f} MB; capture "
              f"{r['capture_s'][0]:.3f} s")
        for name in ("eager", "graphed"):
            rec = r["profile"][name]
            print(f"renders {label} {name} round under torch.profiler: host "
                  f"kernel-launch calls {rec['kernel_launch_calls']}, graph "
                  f"launches {rec['graph_launch_calls']}, traversal "
                  f"launches the kernels counted {rec['traversal_launches']}"
                  f", kernels {rec.get('kernels', 'not measured')}, device "
                  f"busy {rec['device_busy_ms']} ms of "
                  f"{rec['ms_under_profiler']:.3f} ms, idle share "
                  f"{rec['idle_share']} (against the unprofiled round "
                  f"{rec['idle_share_unprofiled']})")
        rl = st["relight"] = relight_round_check(label, kernel, mesh, em,
                                                 ngp, seed)
        print(f"renders {label} relight round ({card}): {rl['rays']} rays "
              f"at spp {rl['spp']}, depth {rl['depth']}, {rl['spots']} "
              f"spots, trees {rl['static_faces']} + {rl['sub_scene_faces']}"
              f" faces, phases {rl['phases']}: graphed = eager bit for bit "
              f"each round; ms a round eager {rl['eager_ms_per_round']:.2f},"
              f" graphed {rl['graphed_ms_per_round']:.2f}; launches a "
              f"replay {rl['launches_per_replay']}; peak memory "
              f"{rl['peak_memory_mb']:.0f} MB; capture "
              f"{rl['capture_s'][0]:.3f} s")
        v = st["validation"] = validation_check(label, tracer, em, ngp, crf,
                                                rays, seed)
        print(f"renders {label} validation ({card}): {v['rays']} rays at "
              f"spp {v['spp']}, depth {v['depth']}, at steps {v['steps']} "
              f"after in-place updates by a replayed train chunk in the "
              f"same pool: graphed = eager bit for bit; s a render graphed "
              f"{[round(x, 3) for x in v['graphed_s']]}, eager "
              f"{[round(x, 3) for x in v['eager_s']]}; captures "
              f"{[round(x, 3) for x in v['capture_s']]} s; peak memory "
              f"{v['peak_memory_mb']:.0f} MB")
    stats["launches"] = read_launches()
    stats["phase_s"] = time.perf_counter() - t_phase
    print(f"renders: phase 19 took {stats['phase_s']:.1f} s")
    return stats


def encode_phase(dev, seed, flush):
    """Phase 20, the encode kernel at the cells' shapes, printed. Returns
    its stats by case."""
    import torch

    from iris_tpu_torch.models import cuda_hashgrid
    from iris_tpu_torch.models import hashgrid as H

    card = card_line()
    stats = {}
    for unit, mode, n, grid in ENCODE_CASES:
        cfg = H.HashGridConfig(**grid)
        gen = torch.Generator(device=dev).manual_seed(seed)
        table = H.init_hashgrid(gen, cfg, dev).uniform_(-0.3, 0.3,
                                                        generator=gen)
        x = torch.rand((n, 3), generator=gen, device=dev)
        lt = cfg.n_levels * cfg.table_size
        levels = H._level_constants(cfg, dev)
        before = cuda_hashgrid.launch_counts()
        words = cuda_hashgrid.pack(table, lt) if mode == "packed" else table
        args = (words, x, levels[:3], mode, cfg.n_levels, cfg.n_features,
                cfg.log2_table_size)
        got = cuda_hashgrid.encode(*args)
        check(cuda_hashgrid.launch_counts() == {
            "encode": before["encode"] + 1,
            "pack": before["pack"] + (mode == "packed")},
              f"encode {mode}: the kernels counted their launches")
        want = cuda_hashgrid.encode_plain(*args)
        check(torch.equal(got, want), f"encode {mode}: kernel = plain")
        err = (got - want).abs().max().item()
        del got, want
        ms = time_ms(lambda: cuda_hashgrid.encode(*args), 20, flush)
        plain_ms = time_ms(lambda: cuda_hashgrid.encode_plain(*args), 20,
                           flush)
        # the bytes the encode cannot avoid: each table entry its points
        # touch, once, at the precision read; the points; the output
        idxs, _ = H._corners(*H._cells(x, *levels, cfg.table_size,
                                       cfg.n_levels))
        touched = torch.zeros(lt, dtype=torch.bool, device=dev)
        touched[idxs.reshape(-1)] = True
        entries = int(touched.sum())
        del idxs, touched
        entry = 4 if mode == "packed" else 4 * cfg.n_features
        out_bytes = n * cfg.n_levels * cfg.n_features * 4
        nbytes = entries * entry + n * 12 + out_bytes
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # every corner's read, as the kernel issues them (from L2, mostly)
        corner_bytes = n * cfg.n_levels * 8 * entry
        rec = {"unit": unit, "points": n, "levels": cfg.n_levels,
               "features": cfg.n_features, "max_abs_err": err, "ms": ms,
               "bound_ms": bound_ms, "bytes": nbytes,
               "entries_touched": entries, "table_entries": lt,
               "corner_bytes": corner_bytes,
               "plain_ms": plain_ms}
        line = (f"encode {mode} ({card}): {n} points x {cfg.n_levels} "
                f"levels x {cfg.n_features} features, kernel = plain bit "
                f"for bit; {ms:.4f} ms a call (median of 20, L2 flushed), "
                f"bound {bound_ms:.4f} ms ({nbytes} B at 3.35 TB/s: "
                f"{entries} of {lt} entries touched, points, output; the "
                f"corners' reads {corner_bytes} B), plain {plain_ms:.3f} ms")
        if mode == "packed":
            check(torch.equal(words, H._pack_bf16(table, lt)),
                  "pack = _pack_bf16")
            pack_ms = time_ms(lambda: cuda_hashgrid.pack(table, lt), 20,
                              flush)
            pack_plain_ms = time_ms(lambda: H._pack_bf16(table, lt), 20,
                                    flush)
            # the float32 table read and the words written, once
            pack_bytes = lt * 2 * 4 + lt * 4
            rec.update(pack_ms=pack_ms, pack_plain_ms=pack_plain_ms,
                       pack_bytes=pack_bytes,
                       pack_bound_ms=pack_bytes / HBM_BYTES_PER_S * 1e3)
            line += (f"; the words: pack {pack_ms:.4f} ms (bound "
                     f"{rec['pack_bound_ms']:.4f} ms, {pack_bytes} B), "
                     f"_pack_bf16 {pack_plain_ms:.4f} ms")
        stats[mode] = rec
        print(line)
    return stats


def encode_rows(main_launches, encode):
    """The "encode" and "pack" rows of the kernels line: the kernels'
    launches on the main paths (main_launches, by phase) and phase 20's
    stats (encode)."""
    src = "iris_tpu_torch/csrc/hashgrid.cu"
    none = "none: XLA runs the encode (iris_tpu/models/hashgrid.py)"
    packed = encode["packed"]
    rows = []
    for name, ms, plain_ms, bound_ms, err, extra in (
            ("encode", packed["ms"], packed["plain_ms"], packed["bound_ms"],
             max(rec["max_abs_err"] for rec in encode.values()),
             {"points": packed["points"], "plain_input": "the same points",
              **{mode: encode[mode] for mode in encode
                 if mode != "packed"}}),
            ("pack", packed["pack_ms"], packed["pack_plain_ms"],
             packed["pack_bound_ms"], 0.0,
             {"entries": packed["table_entries"],
              "plain_input": "the same table"})):
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": none,
            "launches": sum(c[name] for c in main_launches.values()),
            "launches_by_phase": {p: c[name]
                                  for p, c in main_launches.items()},
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            **extra})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=2,
                    help="timed flagship rounds (SPP=512 would be 64)")
    ap.add_argument("--sweep-only", action="store_true",
                    help="time the packet walks' widths on a train step's "
                    "rays and stop (no verdict line)")
    ap.add_argument("--stages-only", action="store_true",
                    help="run the shading-cache stages (phase 10) and stop "
                    "(no verdict line)")
    ap.add_argument("--pipeline-only", action="store_true",
                    help="run the training stages and the render CLI "
                    "(phase 11) on new datasets and stop (no verdict line)")
    ap.add_argument("--relight-only", action="store_true",
                    help="run the relight and video CLIs (phase 14) on new "
                    "datasets with the production material from --seed and "
                    "stop (no verdict line)")
    ap.add_argument("--tools-only", action="store_true",
                    help="run the dataset-preparation tools (phase 15) on "
                    "new datasets and stop (no verdict line)")
    ap.add_argument("--parallel-only", action="store_true",
                    help="run the data-parallel trainer (phase 16) on new "
                    "datasets and stop (no verdict line)")
    ap.add_argument("--drivers-only", action="store_true",
                    help="run the root scripts' twins (phase 17) and stop (no "
                    "verdict line)")
    ap.add_argument("--chunks-only", action="store_true",
                    help="run the one-dispatch training chunks (phase 18) on "
                    "the flagship and 102K scenes and a new flagship "
                    "dataset, and stop (no verdict line)")
    ap.add_argument("--renders-only", action="store_true",
                    help="run the one-dispatch renders (phase 19) on the "
                    "flagship and 102K scenes, and stop (no verdict line)")
    ap.add_argument("--encode-only", action="store_true",
                    help="run the hash grid's encode kernel at the cells' "
                    "shapes (phase 20), and stop (no verdict line)")
    ap.add_argument("--counts", action="store_true",
                    help="with --sweep-only: the plain versions' counters "
                    "at every packet width on the camera check rays")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import iris_tpu_torch
    from iris_tpu_torch.demo import demo_mat_fn, make_demo_scene
    from iris_tpu_torch.geometry import cuda_intersect as ci
    from iris_tpu_torch.geometry.bvh import build_bvh
    from iris_tpu_torch.geometry.intersect import TraversalPolicy, kernel_for
    from iris_tpu_torch.geometry.procedural import camera_rays, random_rays

    dev = torch.device(DEVICE)
    t_run = time.perf_counter()

    # 1. the card
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; package "
          f"{os.path.dirname(os.path.abspath(iris_tpu_torch.__file__))}")

    # 2. build
    build_s, ptxas = build_all()
    print(f"build: {build_s:.1f} s (nvcc traverse.cu and hashgrid.cu + g++ "
          "bvh_builder.cpp)")
    for ln in ptxas:
        print(f"  ptxas: {ln}")
    configs, lines = packet_configs(leaf_size=4)
    for ln in lines:
        print(ln)
    for name in PACKET_KERNELS:
        c = configs[name][shipped_width(name)]
        check(c["blocks_per_sm"] >= 2 and c["blocks_per_sm"]
              * c["threads_per_block"] >= 512,
              f"{name}: {c['blocks_per_sm']} resident blocks per SM")

    # scenes at production width
    def scene(n_clutter, leaf_size=4, grid=PRODUCTION_GRID):
        t0 = time.perf_counter()
        tracer, em, ngp, crf, mesh = make_demo_scene(
            n_clutter=n_clutter, slf_res=SLF_RES, log2_table=LOG2_TABLE,
            seed=args.seed, leaf_size=leaf_size, device=dev, **grid)
        seed_slf(em, args.seed, dev)
        print(f"scene n_clutter={n_clutter} leaf_size={leaf_size} grid "
              f"{ngp.cfg.n_levels}x{ngp.cfg.n_features}: "
              f"{mesh.n_faces} faces, {tracer.n_nodes} nodes, depth "
              f"{tracer.depth}, layout {tracer.layout}, kernel "
              f"{kernel_for(tracer).__name__}, built in "
              f"{time.perf_counter() - t0:.1f} s")
        check(mesh.n_faces == 12 * (n_clutter + 1) + 2, "scene face count")
        return tracer, em, ngp, crf, mesh

    if args.stages_only:
        stage_stats, traffic = stage_phase(dev, args.seed)
        shutil.rmtree(STAGE_DIR, ignore_errors=True)
        flush = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32,
                            device=dev)
        held = hold_stage_traffic(traffic, flush)
        print("run: " + json.dumps({"shading_cache_stages": stage_stats,
                                    "stage_traffic": held,
                                    "total_s": time.perf_counter() - t_run}))
        print(f"card: {card_line()}")
        return 0

    if args.pipeline_only:
        pipe_stats, train_traffic = pipeline_phase(dev, args.seed)
        shutil.rmtree(STAGE_DIR, ignore_errors=True)
        flush = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32,
                            device=dev)
        held = hold_stage_traffic(train_traffic, flush)
        print("run: " + json.dumps({"pipeline": pipe_stats,
                                    "trainer_traffic": held,
                                    "total_s": time.perf_counter() - t_run}))
        print(f"card: {card_line()}")
        return 0

    if args.relight_only:
        relight_datasets(dev, args.seed)
        relight_stats, relight_traffic = relight_phase(dev, args.seed)
        shutil.rmtree(STAGE_DIR, ignore_errors=True)
        flush = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32,
                            device=dev)
        held = hold_stage_traffic(relight_traffic, flush)
        print("run: " + json.dumps({"relight": relight_stats,
                                    "relight_traffic": held,
                                    "total_s": time.perf_counter() - t_run}))
        print(f"card: {card_line()}")
        return 0

    if args.tools_only:
        tools_stats, tools_traffic = tools_phase(dev, args.seed)
        for d in (STAGE_DIR, TOOLS_DIR):
            shutil.rmtree(d, ignore_errors=True)
        flush = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32,
                            device=dev)
        held = hold_stage_traffic(tools_traffic, flush)
        print("run: " + json.dumps({"tools": tools_stats,
                                    "tools_traffic": held,
                                    "total_s": time.perf_counter() - t_run}))
        print(f"card: {card_line()}")
        return 0

    if args.parallel_only:
        par_stats = parallel_phase(dev, args.seed, new_datasets=True)
        shutil.rmtree(STAGE_DIR, ignore_errors=True)
        print("run: " + json.dumps({"parallel": par_stats,
                                    "total_s": time.perf_counter() - t_run}))
        print(f"card: {card_line()}")
        return 0

    if args.drivers_only:
        scripts = scripts_phase(dev)
        print("run: " + json.dumps({"scripts": scripts,
                                    "total_s": time.perf_counter() - t_run}))
        print(f"card: {card_line()}")
        return 0

    if args.chunks_only:
        flag, big = scene(FLAGSHIP_CLUTTER), scene(CLUTTER_102K)
        root, bake = chunks_dataset(dev, args.seed)
        take_encode_launches()
        chunks = chunks_phase(
            dev, args.seed, (("flagship", "trace_union", flag),
                             ("clutter102k", "trace_paired_streamed", big)),
            root, bake)
        hg = take_encode_launches()
        print(f"chunks: the hash grid's kernels counted {hg}")
        check(hg["encode"] > 0, "no encode kernel launched in phase 18")
        for d in (STAGE_DIR, CHUNK_DIR):
            shutil.rmtree(d, ignore_errors=True)
        print("run: " + json.dumps({"chunks": chunks, "hashgrid_launches": hg,
                                    "total_s": time.perf_counter() - t_run}))
        print(f"card: {card_line()}")
        return 0

    if args.renders_only:
        flag, big = scene(FLAGSHIP_CLUTTER), scene(CLUTTER_102K)
        take_encode_launches()
        renders = renders_phase(
            dev, args.seed, (("flagship", "trace_union", flag),
                             ("clutter102k", "trace_paired_streamed", big)))
        hg = take_encode_launches()
        print(f"renders: the hash grid's kernels counted {hg}")
        check(hg["encode"] > 0, "no encode kernel launched in phase 19")
        shutil.rmtree(RENDERS_DIR, ignore_errors=True)
        print("run: " + json.dumps({"renders": renders,
                                    "hashgrid_launches": hg,
                                    "total_s": time.perf_counter() - t_run}))
        print(f"card: {card_line()}")
        return 0

    if args.encode_only:
        flush = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32,
                            device=dev)
        encode = encode_phase(dev, args.seed, flush)
        print("run: " + json.dumps({"encode": encode,
                                    "total_s": time.perf_counter() - t_run}))
        print(f"card: {card_line()}")
        return 0

    if args.sweep_only:
        big = scene(CLUTTER_102K)
        *_, big_in, _ = bench_setup("clutter102k", big[0], big[1], big[2],
                                    big[3], frame_rays(dev), args.seed)
        flush = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32,
                            device=dev)
        o_big, d_big = big_in["o"], big_in["d"]
        print(f"sweep on the {o_big.shape[0]} rays of a 102K train step")
        yard = (ci.trace_union, ci.trace_paired, ci.trace_dense)
        for kernel in yard + yard[::-1]:
            ms = time_ms(lambda: kernel(big[0], o_big, d_big), 20, flush)
            print(f"yardstick {kernel.__name__}: {ms:.4f} ms")
        for ln in report_sweep(width_sweep(big[0], o_big, d_big, flush)):
            print(ln)
        if args.counts:
            o_cam, d_cam, *_ = camera_rays(CHECK_RAYS_SIDE)
            for ln in width_counts(
                    big[0],
                    torch.from_numpy(np.ascontiguousarray(o_cam)).to(dev),
                    torch.from_numpy(np.ascontiguousarray(d_cam)).to(dev)):
                print(ln)
        print(f"card: {card_line()}")
        print(f"sweep took {time.perf_counter() - t_run:.1f} s")
        return 0

    flag = scene(FLAGSHIP_CLUTTER)
    big = scene(CLUTTER_102K)
    wide = scene(CLUTTER_6K, WIDE_LEAF)
    # the same 6,014 faces with 4-triangle leaves: inside the paired gate
    mid_tracer = build_bvh(wide[4].triangles(), leaf_size=4, device=dev)
    check(kernel_for(flag[0]) is ci.trace_union, "flagship dispatch")
    check(kernel_for(big[0]) is ci.trace_paired_streamed, "102K dispatch")
    check(kernel_for(wide[0]) is ci.trace_ordered, "wide-leaf dispatch")
    check(kernel_for(mid_tracer) is ci.trace_paired, "6K dispatch")
    # the wide-leaf tree is where the JAX package runs its ordered kernel:
    # leaf row past the paired layout, (N, 8)/(P, 12) rows (each padded to
    # 128 lanes there) inside the 10 MB resident gate
    resident = (-(-wide[0].nodes.shape[0] // 8) * 8
                + -(-wide[0].tris.shape[0] // 8) * 8) * 128 * 4
    check(wide[0].leaf_size * 12 > 128 and resident <= 10 << 20,
          f"wide-leaf tree: leaf row {wide[0].leaf_size * 12} floats, "
          f"resident layout {resident} B")
    print(f"paired layout bytes: 102K tree {ci.paired_layout_bytes(big[0])}"
          f", 6K tree {ci.paired_layout_bytes(mid_tracer)} (split at "
          f"{ci.PAIRED_RESIDENT_BYTES}); wide-leaf tree's (N,8)/(P,12) "
          f"rows padded to 128 lanes: {resident} B")
    table_mb = flag[2].table.numel() * 4 / 2 ** 20
    print(f"model: hash grid {flag[2].cfg.n_levels}L x "
          f"{flag[2].cfg.n_features}F x 2^{flag[2].cfg.log2_table_size} "
          f"({table_mb:.0f} MB), MLP "
          f"{[w.shape[0] for w in flag[2].mlp['w']] + [5]}, CRF dim "
          f"{flag[3].dim}, SLF {flag[1].slf.H}^3")

    # 3. each kernel against its plain version
    o_cam, d_cam, *_ = camera_rays(CHECK_RAYS_SIDE)
    n_check = CHECK_RAYS_SIDE ** 2
    o_rnd, d_rnd = random_rays(n_check, seed=args.seed + 1)
    ray_sets = {"camera": (o_cam, d_cam), "random": (o_rnd, d_rnd)}
    src = "iris_tpu/geometry/pallas_intersect.py"
    kernel_specs = {
        "trace_union": (
            ci.trace_union, ci.trace_union_plain, flag[0], False,
            f"pallas_ray_trace ({src}:240, _kernel :176)"),
        "trace_paired": (
            ci.trace_paired, ci.trace_paired_plain, big[0], True,
            f"pallas_ray_trace_paired ({src}:782, _kernel_paired :675)"),
        "trace_paired_streamed": (
            ci.trace_paired_streamed, ci.trace_paired_streamed_plain,
            big[0], True,
            f"pallas_ray_trace_paired_streamed ({src}:989, "
            "_kernel_paired_streamed :833)"),
        "trace_ordered": (
            ci.trace_ordered, ci.trace_ordered_plain, wide[0], False,
            f"pallas_ray_trace_ordered ({src}:579, _kernel_ordered :436)"),
        "trace_streamed": (
            ci.trace_streamed, ci.trace_streamed_plain, big[0], False,
            f"pallas_ray_trace_streamed ({src}:371, _kernel_streamed :271)"),
        "trace_dense": (
            ci.trace_dense, ci.trace_dense_plain, big[0], True,
            f"pallas_ray_trace_dense ({src}:1221, _kernel_dense :1102)"),
        "trace_dense_streamed": (
            ci.trace_dense_streamed, ci.trace_dense_streamed_plain, big[0],
            True, f"pallas_ray_trace_dense_streamed ({src}:1437, "
            "_kernel_dense_streamed :1271)"),
    }
    max_err, check_plain = {}, {}
    for name, (kernel, plain, tracer, _, _) in kernel_specs.items():
        for label, (o, d) in ray_sets.items():
            o_t = torch.from_numpy(np.ascontiguousarray(o)).to(dev)
            d_t = torch.from_numpy(np.ascontiguousarray(d)).to(dev)
            # the packet walks at every instantiated width on the camera
            # rays, the shipped width (None) last so that its plain run is
            # the one kept
            widths = [None]
            if name in PACKET_KERNELS and label == "camera":
                widths = [w for w in ci.PACKET_WIDTHS
                          if w != shipped_width(name)] + [None]
            for width in widths:
                kw = {} if width is None else {"width": width}
                got = kernel(tracer, o_t, d_t, **kw)
                torch.cuda.synchronize()
                counts = {}
                plain_ms, want = timed_once(
                    lambda: plain(tracer, o_t, d_t, counts=counts, **kw))
                err, same = compare_hits(got, want)
                if name in PACKET_KERNELS + ("trace_union",):
                    check(same == n_check, f"{name} {label} width {width}: "
                          f"{same}/{n_check} rays bit-equal to plain")
                max_err[name] = max(max_err.get(name, 0.0), err)
                check_plain[name, label] = (plain_ms, counts)
                at = "" if width is None else f" W={width}"
                print(f"check {name}{at} {label} ({n_check} rays): hits "
                      f"{int((got[3] >= 0).sum())}, bit-equal "
                      f"{same}/{n_check}, max |t| error {err:.3e}; plain "
                      f"{plain_ms:.1f} ms")

    # trace_union on a tree the L1 cannot hold and past every gate: the
    # Morton (heap) tree of the 102K scene, which kernel_for sends to
    # trace_union
    morton = build_bvh(big[4].triangles(), method="morton", device=dev)
    check(kernel_for(morton) is ci.trace_union
          and not ci.resident_available(morton), "Morton 102K dispatch")
    morton_bytes = morton.n_nodes * 32 + morton.tris.shape[0] * 48
    for label, (o, d) in ray_sets.items():
        o_t = torch.from_numpy(np.ascontiguousarray(o)).to(dev)
        d_t = torch.from_numpy(np.ascontiguousarray(d)).to(dev)
        got = ci.trace_union(morton, o_t, d_t)
        torch.cuda.synchronize()
        plain_ms, want = timed_once(
            lambda: ci.trace_union_plain(morton, o_t, d_t))
        err, same = compare_hits(got, want)
        check(same == n_check, f"trace_union Morton 102K {label}: "
              f"{same}/{n_check} rays bit-equal to plain")
        max_err["trace_union"] = max(max_err["trace_union"], err)
        print(f"check trace_union {label} on the Morton tree of the 102K "
              f"scene ({morton.n_nodes} nodes, {morton_bytes} B, depth "
              f"{morton.depth}; {n_check} rays): hits "
              f"{int((got[3] >= 0).sum())}, bit-equal {same}/{n_check}, "
              f"max |t| error {err:.3e}; plain {plain_ms:.1f} ms")
    del morton

    launches = dict.fromkeys(KERNELS, 0)

    def add_launches(stats):
        for k, v in stats["launches"].items():
            launches[k] += v

    def report_render(label, stats, note=""):
        print(f"{label}: {stats['rounds']} round(s){note}, each a CUDA "
              f"graph replay, of "
              f"{stats['camera_samples_per_round']} camera samples, depth "
              f"{stats['depth']}: {stats['ms_per_round']:.2f} ms/round, "
              f"{stats['rays_per_s']:.0f} rays/s; launches "
              f"{stats['launches']}; mean HDR "
              f"{[round(x, 4) for x in stats['hdr_mean']]}, mean LDR "
              f"{[round(x, 4) for x in stats['ldr_mean']]}")

    # the hash grid's kernels' launches on the main paths, by phase
    take_encode_launches()
    hg_launches = {}

    # 4. the flagship frame
    rays = frame_rays(dev)
    flag_stats, _ = render_scene(
        "flagship", flag[0], flag[1], demo_mat_fn(flag[2]), flag[3], rays,
        args.rounds, args.seed)
    check(only_launched(flag_stats["launches"], "trace_union"),
          "flagship render: launches of trace_union alone expected")
    add_launches(flag_stats)
    report_render("flagship", flag_stats, " (cut from SPP=512's 64)")
    # one material evaluation at the camera hits, one per bounce (the
    # first bounce's is handed on to the indirect tail), one in the AOV
    # pass
    n_mat, n_kernels, busy_ms = round_census(
        flag[0], flag[1], demo_mat_fn(flag[2]), rays, args.seed)
    check(n_mat == INDIR_DEPTH + 3, f"flagship round: {n_mat} material "
          f"evaluations, expected {INDIR_DEPTH + 3}")
    flag_stats.update(material_evaluations_per_round=n_mat,
                      kernels_per_round=n_kernels,
                      device_busy_ms_per_round=busy_ms)
    print(f"flagship round census (torch.profiler, one round after a "
          f"warm-up): {n_mat} material evaluations, {n_kernels} kernels "
          f"launched, device busy {busy_ms:.2f} ms")
    frac, worst = small_reference_check(flag[0], flag[1], flag[2], dev,
                                        args.seed)
    print(f"flagship card vs CPU (64 px, spp 2): {frac:.4f} of radiance "
          f"values within rtol 2e-3/atol 1e-4, max |diff| {worst:.3e}")

    # 5. one round of the 102K-face scene and of the two 6K-face trees
    big_stats, _ = render_scene(
        "clutter102k", big[0], big[1], demo_mat_fn(big[2]), big[3], rays, 1,
        args.seed)
    check(only_launched(big_stats["launches"], "trace_paired_streamed"),
          "102K render: launches of trace_paired_streamed alone expected")
    add_launches(big_stats)
    report_render("clutter102k", big_stats)
    print(f"clutter102k tree depth {big[0].depth}, stack "
          f"{ci.auto_stack_depth(big[0])}")
    wide_stats, wide_in = render_scene(
        "clutter6k_leaf16", wide[0], wide[1], demo_mat_fn(wide[2]), wide[3],
        rays, 1, args.seed, depth=2)
    check(only_launched(wide_stats["launches"], "trace_ordered"),
          "6K wide-leaf render: launches of trace_ordered alone expected")
    add_launches(wide_stats)
    report_render("clutter6k_leaf16", wide_stats)
    mid_stats, mid_in = render_scene(
        "clutter6k_leaf4", mid_tracer, wide[1], demo_mat_fn(wide[2]),
        wide[3], rays, 1, args.seed, depth=2)
    check(only_launched(mid_stats["launches"], "trace_paired"),
          "6K render: launches of trace_paired alone expected")
    add_launches(mid_stats)
    report_render("clutter6k_leaf4", mid_stats)

    # 6. training at full width
    def report_train(label, st):
        print(f"train {label}: {st['steps']} steps of "
              f"{st['camera_samples_per_step']} camera samples "
              f"(fwd+bwd+Adam): {st['ms_per_step']:.2f} ms/step "
              f"({st['host_ms_per_step']:.2f} ms on the host clock), "
              f"{st['camera_samples_per_s']:.0f} camera samples/s; largest "
              f"trace {st['largest_trace_rays']} rays; launches "
              f"{st['launches']}; losses {st['first_loss']:.6f} -> "
              f"{[round(x, 6) for x in st['losses']]}; peak memory "
              f"{st['peak_memory_mb']:.0f} MB")

    flag_train, flag_in = train_scene(
        "flagship train", "trace_union", flag[0], flag[1], flag[2], flag[3],
        rays, 5, args.seed)
    add_launches(flag_train)
    report_train("flagship", flag_train)
    big_train, big_in = train_scene(
        "clutter102k train", "trace_paired_streamed", big[0], big[1],
        big[2], big[3], rays, 3, args.seed)
    add_launches(big_train)
    report_train("clutter102k", big_train)

    # 7. the stage losses
    stages = stage_losses(flag[0], flag[1], flag[2], flag[3], dev, args.seed)
    for label, st in stages.items():
        print(f"stage {label}: 3 steps of {st['pixels']} pixels: "
              f"{st['ms_per_step']:.2f} ms/step (host clock), losses "
              f"{[round(x, 6) for x in st['losses']]}")

    # 8. a small train step on the card and on the CPU
    l_card, l_cpu, cos, n_leaves = train_reference_check(
        flag[0], flag[1], flag[2], flag[3], dev, args.seed)
    print(f"train step card vs CPU (64 rays, spp 2): loss {l_card:.6f} vs "
          f"{l_cpu:.6f}; {n_leaves} gradient leaves, least cosine "
          f"{cos:.6f}")

    # 9. the reference-parity configuration: 32 levels x 2 features
    ref = scene(CLUTTER_102K, grid=REFERENCE_GRID)
    ref_cfg = ref[2].cfg
    # HashGridConfig's own defaults: the reference's grid
    check(ref_cfg == dataclasses.replace(type(ref_cfg)(),
                                         log2_table_size=LOG2_TABLE)
          and LOG2_TABLE == type(ref_cfg)().log2_table_size
          and ref[2].table.shape == (2 * 32 << LOG2_TABLE,)
          and ref_cfg.packed_gather,
          f"reference-parity model: {ref_cfg}, table "
          f"{tuple(ref[2].table.shape)}")
    ci.pack_dense(ref[0])       # shared by the tracers made from it
    print(f"model: hash grid {ref_cfg.n_levels}L x {ref_cfg.n_features}F x "
          f"2^{ref_cfg.log2_table_size} flat table of "
          f"{ref[2].table.numel()} floats "
          f"({ref[2].table.numel() * 4 / 2 ** 20:.0f} MB), packed gather "
          f"{ref_cfg.packed_gather}; 102K tree layouts: paired "
          f"{ci.paired_layout_bytes(ref[0])} B, dense "
          f"{ci.dense_layout_bytes(ref[0])} B, resident rows "
          f"{ci.resident_layout_bytes(ref[0])} B (gates "
          f"{ci.PAIRED_RESIDENT_BYTES}, {ci.DENSE_RESIDENT_BYTES}, "
          f"{ci.RESIDENT_BYTES})")
    policies = (
        ("trace_dense", TraversalPolicy(paired_streamed=False)),
        ("trace_streamed", TraversalPolicy(paired_streamed=False,
                                           dense=False)),
        ("trace_dense_streamed", TraversalPolicy(
            paired_streamed=False, dense=False, dense_streamed=True)))
    ref_stats = {}
    for name, policy in policies:
        tracer = dataclasses.replace(ref[0], policy=policy)
        check(kernel_for(tracer).__name__ == name,
              f"{policy} sends the 102K tree to "
              f"{kernel_for(tracer).__name__}, not {name}")
        label = f"ref32x2 {name}"
        r_stats, _ = render_scene(label, tracer, ref[1],
                                  demo_mat_fn(ref[2]), ref[3], rays, 1,
                                  args.seed)
        check(only_launched(r_stats["launches"], name, 8),
              f"{label} render: 8 launches of {name} alone expected, got "
              f"{r_stats['launches']}")
        add_launches(r_stats)
        report_render(label, r_stats)
        t_stats, _ = train_loop_scene(f"{label} train", name, tracer, ref[1],
                                      ref[2], ref[3], rays, 3, args.seed)
        add_launches(t_stats)
        report_train(label, t_stats)
        ref_stats[name] = {"render": r_stats, "train": t_stats}
    # both table modes on the card: the unpacked (flat float32) table on
    # the flagship scene through trace_union
    flat = scene(FLAGSHIP_CLUTTER, grid=REFERENCE_GRID)
    flat_ngp = dataclasses.replace(flat[2], cfg=dataclasses.replace(
        flat[2].cfg, packed_gather=False))
    r_stats, _ = render_scene("ref32x2 flat flagship", flat[0], flat[1],
                              demo_mat_fn(flat_ngp), flat[3], rays, 1,
                              args.seed)
    check(only_launched(r_stats["launches"], "trace_union", 8),
          f"flat flagship render launches {r_stats['launches']}")
    add_launches(r_stats)
    report_render("ref32x2 flat flagship", r_stats)
    t_stats, _ = train_loop_scene(
        "ref32x2 flat flagship train", "trace_union", flat[0], flat[1],
        flat_ngp, flat[3], rays, 3, args.seed)
    add_launches(t_stats)
    report_train("ref32x2 flat flagship", t_stats)
    ref_stats["flat_trace_union"] = {"render": r_stats, "train": t_stats}
    hg_launches["4-9"] = take_encode_launches()
    # card against CPU, both modes
    for mode, ngp in (("packed", flat[2]), ("flat", flat_ngp)):
        frac, worst = small_reference_check(flat[0], flat[1], ngp, dev,
                                            args.seed)
        print(f"ref32x2 {mode} card vs CPU (64 px, spp 2): {frac:.4f} of "
              f"radiance values within rtol 2e-3/atol 1e-4, max |diff| "
              f"{worst:.3e}")
        l_card, l_cpu, cos, n_leaves = train_reference_check(
            flat[0], flat[1], ngp, flat[3], dev, args.seed)
        print(f"ref32x2 {mode} train step card vs CPU (64 rays, spp 2): "
              f"loss {l_card:.6f} vs {l_cpu:.6f}; {n_leaves} gradient "
              f"leaves, least cosine {cos:.6f}")
    del ref, flat, flat_ngp

    # 10. the shading-cache stages on two datasets of the port's generator
    stage_stats, traffic = stage_phase(dev, args.seed)
    for st in stage_stats.values():
        for stage in STAGES:
            add_launches(st[stage])
    hg_launches["10"] = take_encode_launches()

    # 11. the training stages and the render CLI on the same datasets
    pipe_stats, train_traffic = pipeline_phase(dev, args.seed,
                                               new_datasets=False)
    for st in pipe_stats.values():
        for name in PIPE_CLIS:
            add_launches(st[name])
    hg_launches["11"] = take_encode_launches()

    # 14. the relight and video CLIs on phase 11's trained scenes
    relight_stats, relight_traffic = relight_phase(dev, args.seed)
    for st in relight_stats.values():
        for run in st.values():
            if isinstance(run, dict) and "launches" in run:
                add_launches(run)
    hg_launches["14"] = take_encode_launches()

    # 15. the dataset-preparation tools on phase 11's datasets and two
    # full-size ones
    tools_stats, tools_traffic = tools_phase(dev, args.seed,
                                             new_datasets=False)
    for st in tools_stats.values():
        for tool in TOOLS:
            if isinstance(st, dict) and tool in st:
                add_launches(st[tool])
    hg_launches["15"] = take_encode_launches()

    # 16. the data-parallel trainer on phase 11's datasets and bakes
    par_stats = parallel_phase(dev, args.seed)
    for st in par_stats.values():
        for run in ("no_group", "nccl_1", "gloo_2"):
            add_launches(st[run])
    hg_launches["16"] = take_encode_launches()

    # 17. the root scripts' twins: bench, bench_components, bench_scaling and
    # the graft entry
    reset_launches()
    scripts = scripts_phase(dev, {"flagship": flag_train,
                                  "clutter102k": big_train})
    add_launches({"launches": read_launches()})
    hg_launches["17"] = take_encode_launches()

    # 18. one-dispatch chunks: the benchmark loss on both scenes, then
    # initialize on phase 11's flagship dataset and bake
    chunks = chunks_phase(
        dev, args.seed, (("flagship", "trace_union", flag),
                         ("clutter102k", "trace_paired_streamed", big)),
        os.path.abspath(os.path.join(STAGE_DIR, "flagship")),
        os.path.abspath(os.path.join(STAGE_DIR, "flagship_pipeline",
                                     "bake")),
        {k: v for k, v in scripts["bench"]["runs"].items()})
    add_launches(chunks)
    hg_launches["18"] = take_encode_launches()

    # 19. one-dispatch rendering: the render round, a relight round and the
    # validation render on both scenes
    renders = renders_phase(
        dev, args.seed, (("flagship", "trace_union", flag),
                         ("clutter102k", "trace_paired_streamed", big)))
    add_launches(renders)
    hg_launches["19"] = take_encode_launches()
    print(f"the hash grid's kernels' launches by phase: {hg_launches}")
    for phase in ("11", "14", "18", "19"):
        check(hg_launches[phase]["encode"] > 0,
              f"no encode kernel launched in phase {phase}")
    for d in (STAGE_DIR, TOOLS_DIR, CHUNK_DIR, RENDERS_DIR):
        shutil.rmtree(d, ignore_errors=True)

    # 12-13. each kernel on the largest input a main path gave it; the five
    # big-tree kernels on the same 518,400 rays of the 102K train step;
    # trace_union and trace_paired_streamed also on the stages' and the
    # trainers' traffic
    flush = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    held = hold_stage_traffic(traffic, flush)
    trainer_held = hold_stage_traffic(train_traffic, flush)
    relight_held = hold_stage_traffic(relight_traffic, flush)
    tools_held = hold_stage_traffic(tools_traffic, flush)
    del traffic, train_traffic, relight_traffic, tools_traffic
    inputs = {"trace_union": flag_in, "trace_paired": mid_in,
              "trace_ordered": wide_in}
    trees = {"trace_paired": mid_tracer}
    o_big, d_big = big_in["o"], big_in["d"]
    # the per-ray walks' tests on those rays, for the packet walks' bounds
    per_ray = {"near_first": {}, "stackless": {}}
    ci.trace_paired_plain(big[0], o_big, d_big, counts=per_ray["near_first"])
    stackless_hits = ci.trace_union_plain(big[0], o_big, d_big,
                                          counts=per_ray["stackless"])
    per_ray_of = {"trace_paired_streamed": "near_first",
                  "trace_dense_streamed": "near_first",
                  "trace_streamed": "stackless"}
    for label, key in (("trace_paired / trace_dense", "near_first"),
                       ("trace_union", "stackless")):
        print(f"counts {label} on the {o_big.shape[0]} rays of the 102K "
              "train step: " + ", ".join(
                  f"{k} {per_ray[key][k]}" for k in WALK_COUNTS))
    rows = []
    for name, (kernel, plain, tracer, paired, replaces) in \
            kernel_specs.items():
        tracer = trees.get(name, tracer)
        o, d = inputs.get(name, big_in)["o"], inputs.get(name, big_in)["d"]
        got = kernel(tracer, o, d)
        torch.cuda.synchronize()
        if name in PLAIN_ON_CHECK_SET:
            plain_ms, counts = check_plain[name, "camera"]
            n_plain, plain_on = n_check, "camera check rays"
            err, same = compare_hits(got, stackless_hits)
        else:
            counts = {}
            n_plain, plain_on = o.shape[0], "rays of this trace"
            plain_ms, want = timed_once(
                lambda: plain(tracer, o, d, counts=counts))
            err, same = compare_hits(got, want)
        max_err[name] = max(max_err[name], err)
        ms = time_ms(lambda: kernel(tracer, o, d), 20, flush)
        need, extra = counts, ""
        if name in per_ray_of:
            # the bound takes the per-ray walk's counts where they are the
            # smaller; the packet's own work is printed beside it
            need = per_ray[per_ray_of[name]]
            if n_plain == o.shape[0]:
                need = min(need, counts, key=test_flops)
            extra = (f"; the packet walk itself, on the {n_plain} "
                     f"{plain_on}, did "
                     + ", ".join(f"{k} {v}" for k, v in counts.items())
                     + f" = {test_flops(counts)} FP32 ops")
        bound_ms, bound_by, nbytes, ops = roofline(tracer, need, o.shape[0],
                                                   paired)
        print(f"{name} on its path's {o.shape[0]}-ray trace "
              f"({tracer.n_faces} faces): {ms:.4f} ms (plain "
              f"{plain_ms:.2f} ms in one run on the {n_plain} {plain_on}, "
              f"bound {bound_ms:.5f} ms by "
              f"{bound_by}: {nbytes} B, {ops} FP32 ops from {need['slab']} "
              f"slab + {need['mt']} triangle tests{extra}); bit-equal "
              f"{same}/{o.shape[0]}")
        rows.append({
            "name": name, "route": "cuda",
            "source": "iris_tpu_torch/csrc/traverse.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "rays": o.shape[0], "plain_rays": n_plain,
            "plain_input": plain_on,
        })
        if name in WALK_KERNELS:
            # this run's counts of the plain walk on the same rays
            rows[-1].update({k: counts[k] for k in WALK_COUNTS})
            # what the instantiation this path launched takes, as the CUDA
            # runtime reports it in this run
            res = ci.walk_config(name, tracer.leaf_size)
            rows[-1].update({k: res[k] for k in WALK_RESOURCES})
            print(f"counts {name} on its path's {o.shape[0]} rays: "
                  + ", ".join(f"{k} {counts[k]}" for k in WALK_COUNTS))
            print(f"resources {name} at leaf size {tracer.leaf_size}: "
                  + ", ".join(f"{k} {v}" for k, v in res.items()))
        if name in held:
            # the stages' and the trainers' traffic: the row's numbers are
            # those of the largest input, the train step's input kept
            # beside them
            row = rows[-1]
            row["max_abs_err"] = max([row["max_abs_err"]] + [
                m["max_abs_err"] for m in held[name] + trainer_held[name]
                + relight_held[name] + tools_held[name]])
            row["stage_traffic"] = held[name]
            row["trainer_traffic"] = trainer_held[name]
            row["relight_traffic"] = relight_held[name]
            row["tools_traffic"] = tools_held[name]
            top = max(held[name], key=lambda m: m["rays"])
            if top["rays"] > row["rays"]:
                moved = ("rays", "ms", "plain_ms", "bound_ms", "bound_by",
                         "plain_rays", "plain_input") + tuple(
                             k for k in WALK_COUNTS if k in row)
                row["train_step_input"] = {k: row.pop(k) for k in moved}
                row.update({k: top[k] for k in moved if k in top})
                row["plain_input"] = (f"{top['dataset']} {top['stage']}'s "
                                      "largest trace")
    # the five big-tree kernels on the same rays, and trace_union's per-ray
    # walk of the same tree (the packet width 1 of trace_streamed), in
    # turns there and back
    five = (ci.trace_paired, ci.trace_paired_streamed, ci.trace_streamed,
            ci.trace_dense, ci.trace_dense_streamed, ci.trace_union)
    base = ci.trace_paired(big[0], o_big, d_big)
    agree = {}
    for kernel in five[1:]:
        err, same = compare_hits(kernel(big[0], o_big, d_big), base)
        agree[kernel.__name__] = {"bit_equal_rays": same,
                                  "max_abs_t_diff": err}
    turns = [(kernel.__name__,
              time_ms(lambda: kernel(big[0], o_big, d_big), 20, flush))
             for kernel in five + five[::-1]]
    print(f"102K tree, {o_big.shape[0]} rays, in turns: "
          + ", ".join(f"{n} {t:.4f} ms" for n, t in turns))
    print(f"hits against trace_paired's on those rays: {agree}")
    # trace_paired's time on the same input, beside the other four's rows
    paired_ms = statistics.median(
        t for n, t in turns if n == "trace_paired")
    union_ms = statistics.median(t for n, t in turns if n == "trace_union")
    union_bound = roofline(big[0], per_ray["stackless"], o_big.shape[0],
                           False)[0]
    for row in rows:
        if row["name"] in agree and row["name"] != "trace_union":
            row["trace_paired_ms_same_input"] = paired_ms
            row["turns_ms"] = [t for n, t in turns if n == row["name"]]
        if row["name"] == "trace_union":
            # a tree past the L1, on sorted rays
            row.update(ms_102k_rays=union_ms, bound_ms_102k_rays=union_bound)
    print(f"per-ray walks of the 102K tree on those rays: trace_union "
          f"(stackless, trace_streamed's packet width 1) "
          f"{union_ms:.4f} ms (bound "
          f"{union_bound:.5f} ms), trace_paired (near-first) "
          f"{paired_ms:.4f} ms")
    # every packet width of the three packet walks on the same rays
    sweep = width_sweep(big[0], o_big, d_big, flush)
    for ln in report_sweep(sweep):
        print(ln)
    for row in rows:
        name = row["name"]
        if name in PACKET_KERNELS:
            width = shipped_width(name)
            c = configs[name][width]
            row.update(
                packet_width=width,
                widths_ms={str(w): statistics.mean(t)
                           for w, t in sweep[name].items()},
                smem_bytes_per_block=c["smem_bytes_per_block"],
                blocks_per_sm=c["blocks_per_sm"],
                registers=c["registers"])
            if name == "trace_streamed":
                row["trace_union_ms_same_input"] = union_ms
    print("run: " + json.dumps({
        "flagship": flag_stats, "clutter102k": big_stats,
        "clutter6k_leaf16": wide_stats, "clutter6k_leaf4": mid_stats,
        "train_flagship": flag_train, "train_clutter102k": big_train,
        "stages": stages, "ref32x2": ref_stats,
        "shading_cache_stages": stage_stats, "pipeline": pipe_stats,
        "relight": relight_stats, "tools": tools_stats,
        "parallel": par_stats, "scripts": scripts, "chunks": chunks,
        "renders": renders,
        "five_on_102k_ms": turns, "five_on_102k_hits": agree,
        "packet_sweep_ms": sweep,
        "build_s": build_s, "total_s": time.perf_counter() - t_run}))

    # 20. the hash grid's encode kernel at the cells' shapes
    encode = encode_phase(dev, args.seed, flush)
    print("encode: " + json.dumps(encode))
    rows += encode_rows(hg_launches, encode)
    for row in rows:
        check(row["launches"] > 0, f"{row['name']} was never launched on a "
              "main path")
    print(json.dumps({"kernels": rows}))

    # 21. verdict
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
