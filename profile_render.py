#!/usr/bin/env python3
"""Where one render round, one train step or one refine_shading chunk of
iris_tpu_torch spends its time on the card.

    python3 profile_render.py [--path render|train|refine]
                              [--hash 4x16|32x2|32x2flat]
                              [--policy default|dense|streamed|dense_streamed]
                              [--seed 0] [--out outputs/render_trace.json]

For each cell of chip_smoke.py (the flagship scene and the 102,014-face
clutter scene, 8,100 pixels) it runs the unit of work once to warm up,
times it a few times without the profiler, and then once under
torch.profiler (CPU and CUDA activities). The unit is one render round
(render_chunk + aov_chunk at spp 8, depth 5) or, with --path train, one
train step (fwd+bwd of the benchmark loss at spp 32 = 259,200 camera
samples, then Adam, one step of run_training) or, with --path refine, one
chunk of refine_shading's diffuse bake (path_tracing_det_diff at spp 128,
depth 5, exact encode, from the 8,100 pixels' first hits: 1,036,800 paths,
the size of the stage's 1.31M-path chunks). --hash picks the model: the
production 4-level x 16-feature row-mode grid, or the reference's 32-level
x 2-feature grid, packed (32x2) or unpacked (32x2flat). --policy picks the
TraversalPolicy of both trees; on the 102,014-face tree "dense",
"streamed" and "dense_streamed" reach trace_dense, trace_streamed and
trace_dense_streamed (the three packet walks run at their shipped packet
width; the wrappers' width= argument is for measurements: chip_smoke.py
--sweep-only times every instantiated width on a train step's rays). It
prints
the unit's wall time with and without the profiler, the summed device time
of its kernels and the device's idle share against both, the number of
kernels launched, the traversal kernels' share, and the kernels that took
the most device time. The Chrome trace of each profiled unit is written
next to --out (utils/profiling.device_trace). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def device_time_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def device_kernels(prof):
    """The card's kernels in a torch.profiler run, summed by name. Kernel
    events only: CPU ops also carry their kernels' device time, and a
    record_function range (Optimizer.step#Adam.step) shows up on the
    device timeline spanning kernels that are counted themselves. Raises
    when the profiler recorded none."""
    kernels = [e for e in prof.key_averages()
               if device_time_us(e) > 0
               and str(getattr(e, "device_type", "")).endswith("CUDA")
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith(("Optimizer.", "ProfilerStep"))]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    return kernels


def policies():
    from iris_tpu_torch.geometry.intersect import TraversalPolicy

    off = dict(paired_streamed=False)
    return {"default": TraversalPolicy(),
            "dense": TraversalPolicy(**off),
            "streamed": TraversalPolicy(dense=False, **off),
            "dense_streamed": TraversalPolicy(dense=False,
                                              dense_streamed=True, **off)}


def make_unit(path, n_clutter, seed, grid="4x16", policy="default"):
    """The unit of work to profile, as a function without arguments, and
    the name of the traversal kernel it runs."""
    import dataclasses
    import itertools

    import torch

    from chip_smoke import (
        INDIR_DEPTH, LOG2_TABLE, PRODUCTION_GRID, REFERENCE_GRID, SLF_RES,
        SPP, TRAIN_SPP, bench_params, frame_rays, make_bench_loss, seed_slf)
    from iris_tpu_torch.demo import demo_mat_fn, make_demo_scene
    from iris_tpu_torch.geometry.intersect import kernel_for

    dev = torch.device("cuda")
    tracer, em, ngp, crf, _ = make_demo_scene(
        n_clutter=n_clutter, slf_res=SLF_RES, log2_table=LOG2_TABLE,
        seed=seed, device=dev, policy=policies()[policy],
        **(PRODUCTION_GRID if grid == "4x16" else REFERENCE_GRID))
    if grid == "32x2flat":
        ngp = dataclasses.replace(ngp, cfg=dataclasses.replace(
            ngp.cfg, packed_gather=False))
    kernel = kernel_for(tracer).__name__
    seed_slf(em, seed, dev)
    rays = frame_rays(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if path == "refine":
        from iris_tpu_torch.core.vecmath import normalize
        from iris_tpu_torch.geometry.intersect import ray_intersect
        from iris_tpu_torch.render.integrator import path_tracing_det_diff

        pos, nrm, uv, tri, _ = ray_intersect(tracer, rays[:, :3],
                                             rays[:, 3:6])
        wi = normalize(rays[:, 3:6])
        mat_fn = demo_mat_fn(ngp)

        @torch.no_grad()
        def unit():
            path_tracing_det_diff(gen, tracer, em, mat_fn, pos, wi, nrm, uv,
                                  tri, 128, INDIR_DEPTH)
            torch.cuda.synchronize()

        return unit, kernel

    if path == "render":
        from iris_tpu_torch.pipeline.render import make_render_fns

        render_chunk, aov_chunk = make_render_fns(
            tracer, em, demo_mat_fn(ngp), SPP, INDIR_DEPTH)

        def unit():
            render_chunk(rays, gen)
            aov_chunk(rays, gen)
            torch.cuda.synchronize()

        return unit, kernel

    from iris_tpu_torch.train.loop import run_training
    from iris_tpu_torch.train.optim import make_optimizer

    params = bench_params(em, ngp, crf)
    opt = make_optimizer(learning_rate=1e-3)
    state = opt.init(params)
    loss_fn = make_bench_loss(tracer, em, crf, rays, TRAIN_SPP)
    steps = itertools.count()

    def unit():
        n = next(steps)
        run_training(loss_fn, params, itertools.repeat({}), opt, n + 1, seed,
                     log_fn=None, opt_state=state, start_step=n)
        torch.cuda.synchronize()

    return unit, kernel


def profile_cell(label, path, n_clutter, seed, out, grid, policy):
    from iris_tpu_torch.utils.profiling import device_trace

    unit, kernel = make_unit(path, n_clutter, seed, grid, policy)
    label = f"{label} {grid} {kernel}"
    unit()                                            # warm-up
    plain_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        unit()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    plain_ms = sorted(plain_ms)[1]
    name = os.path.splitext(os.path.basename(out))[0]
    with device_trace(os.path.dirname(os.path.abspath(out)),
                      f"{name}_{path}_{label.replace(' ', '_')}") as prof:
        t0 = time.perf_counter()
        unit()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = device_kernels(prof)
    busy_ms = sum(device_time_us(e) for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    trav_ms = sum(device_time_us(e) for e in kernels
                  if "trace_" in e.key and "_kernel" in e.key) / 1e3
    what = {"render": "round", "train": "train step",
            "refine": "refine chunk"}[path]
    print(f"{label}: {what} wall {wall_ms:.2f} ms under the profiler, "
          f"{plain_ms:.2f} ms without (median of 3); device busy "
          f"{busy_ms:.2f} ms, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f} under the profiler, "
          f"{max(0.0, 1 - busy_ms / plain_ms):.3f} without; {n_kernels} "
          f"kernels; traversal {trav_ms:.3f} ms = {trav_ms / busy_ms:.3f} "
          f"of device time")
    top = sorted(kernels, key=device_time_us, reverse=True)[:15]
    for e in top:
        print(f"  {device_time_us(e) / 1e3:8.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    cpu_ops = sorted((e for e in prof.key_averages()
                      if e.key.startswith("aten::")),
                     key=lambda e: e.count, reverse=True)[:10]
    print("  most frequent aten ops: " + ", ".join(
        f"{e.key[6:]} x{e.count}" for e in cpu_ops))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", choices=("render", "train", "refine"),
                    default="render")
    ap.add_argument("--hash", choices=("4x16", "32x2", "32x2flat"),
                    default="4x16", help="the hash grid: levels x features")
    ap.add_argument("--policy", choices=("default", "dense", "streamed",
                                         "dense_streamed"),
                    default="default", help="the trees' TraversalPolicy; "
                    "the packet walks it reaches run at their shipped "
                    "packet width (chip_smoke.py --sweep-only times the "
                    "others)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="outputs/render_trace.json")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_render: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chip_smoke import CLUTTER_102K, FLAGSHIP_CLUTTER, card_line

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    print(f"card: {card_line()}")
    for label, n_clutter in (("flagship", FLAGSHIP_CLUTTER),
                             ("clutter102k", CLUTTER_102K)):
        profile_cell(label, args.path, n_clutter, args.seed, args.out,
                     args.hash, args.policy)
    return 0


if __name__ == "__main__":
    sys.exit(main())
