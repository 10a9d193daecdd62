#!/usr/bin/env python3
"""On-card smoke run of iris_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py [--seed 0] [--rounds 2]
    python3 chip_smoke.py --sweep-only [--counts]

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
   nonzero radiance — at spp 8 and indir_depth 5, for --rounds rounds
   after one warm-up round (a cut of the 64 rounds that SPP=512 takes),
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
10. times the five big-tree kernels, and trace_union's per-ray walk of
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
11. prints one JSON line {"kernels": [...]} with each kernel's launches on
   the main paths, its error against the plain version, its time, the
   plain version's time (one run) and its roofline bound, measured on the
   largest input a main path gave the kernel (the five big-tree kernels on
   the same rays; the bound of the packet walks counts the per-ray walk's
   tests); the rows of the four per-ray walks add this run's pops,
   warp_steps and lane_busy, and those four numbers of the path's
   instantiation; trace_union's row adds its time and bound on the
   518,400 rays of the 102K train step;
12. prints the card line again and, last, the run's JSON verdict.

Any failed check raises, and the script then exits non-zero with no
verdict line. It imports nothing of JAX or of the JAX package.

--sweep-only runs phases 1-2, builds the 102,014-face scene, takes the
518,400 rays of one train step and runs the width sweep of phase 10 alone
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
import statistics
import subprocess
import sys
import threading
import time

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
SPIN_CYCLES = 500_000          # ~0.3 ms of a spin kernel before a timed run
DEVICE = "cuda"


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
    """Start both native builds together; returns (seconds, ptxas lines)."""
    from iris_tpu_torch.geometry import bvh_native, cuda_intersect

    results, errors = {}, []

    def run(name, fn):
        try:
            results[name] = fn()
        except Exception as e:  # re-raised below, after both joined
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(n, f)) for n, f in
               (("traverse", cuda_intersect.build), ("bvh", bvh_native.build))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    cuda_intersect.get_lib()
    ptxas = [ln.strip() for ln in results["traverse"][1].splitlines()
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
    from iris_tpu_torch.geometry import cuda_intersect as ci

    for name in KERNELS:
        getattr(ci, name).launches = 0


def read_launches():
    from iris_tpu_torch.geometry import cuda_intersect as ci

    return {name: getattr(ci, name).launches for name in KERNELS}


class record_largest_trace:
    """While active, keeps the largest (origins, directions) batch that
    geometry.intersect.ray_trace is given, as the kernel receives it (after
    the spatial sort)."""

    def __init__(self):
        self.captured = {}

    def __enter__(self):
        from iris_tpu_torch.geometry import intersect

        self._intersect = intersect
        self._ray_trace = ray_trace = intersect.ray_trace
        captured = self.captured

        def recording(tr, xs, ds):
            if xs.shape[0] > captured.get("n", 0):
                captured.update(n=xs.shape[0],
                                o=xs.detach().float().contiguous().clone(),
                                d=ds.detach().float().contiguous().clone())
            return ray_trace(tr, xs, ds)

        intersect.ray_trace = recording
        return captured

    def __exit__(self, *exc):
        self._intersect.ray_trace = self._ray_trace


def time_ms(fn, reps, flush):
    """Median CUDA-event time of fn; the 50 MB L2 is flushed before each
    run (the render runs other kernels between traversals). A spin kernel
    of ~0.3 ms runs before the first event, so that the host has queued
    fn's launches by the time the card reaches them: without it the
    interval holds the wrapper's host time too (tens of microseconds,
    which is 10% of a 0.5 ms kernel)."""
    import torch

    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def frame_rays(dev):
    import numpy as np
    import torch

    from iris_tpu_torch.geometry.procedural import camera_rays

    o, d, dxdu, dydv = camera_rays(CAMERA_SIDE)
    rays = np.concatenate([o, d, dxdu, dydv], -1).astype(np.float32)
    return torch.from_numpy(rays).to(dev)


def render_scene(label, tracer, em, mat_fn, crf, rays, n_rounds, seed,
                 depth=INDIR_DEPTH):
    """Warm-up round (recording the largest traversal input), then
    n_rounds timed rounds through render_frame with launch counts reset
    just before and read just after. Returns (stats, captured input)."""
    import numpy as np
    import torch

    from iris_tpu_torch.models.crf import crf_forward
    from iris_tpu_torch.pipeline.render import make_render_fns, render_frame

    render_chunk, aov_chunk = make_render_fns(tracer, em, mat_fn, SPP, depth)
    gen = torch.Generator(device=rays.device).manual_seed(seed)
    with record_largest_trace() as captured:
        render_chunk(rays, gen)
        aov_chunk(rays, gen)
        torch.cuda.synchronize()

    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    l_img, aovs = render_frame(render_chunk, aov_chunk, rays, n_rounds, gen)
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


def train_config(ngp, scatter="bfloat16"):
    """A copy of the field (own table and MLP tensors: training updates
    them in place) with the trainers' estimator settings
    (pipeline/config.py:70-100 of the JAX package): stochastic forward and
    backward, auto level-block subsampling, compact scatter."""
    from iris_tpu_torch.models.hashgrid import auto_bwd_level_sample

    cfg = dataclasses.replace(
        ngp.cfg, stochastic_fwd=True, stochastic_bwd=True,
        bwd_level_sample=auto_bwd_level_sample(ngp.cfg.n_levels),
        bwd_compact_scatter=True, bwd_scatter_dtype=scatter)
    return dataclasses.replace(
        ngp, cfg=cfg, table=ngp.table.clone(),
        mlp={k: [t.clone() for t in v] for k, v in ngp.mlp.items()})


def bench_params(em, ngp, crf, scatter="bfloat16"):
    return {"material": train_config(ngp, scatter),
            "radiance": em.radiance.clone(), "crf_w": crf.weight.clone()}


def make_bench_loss(tracer, em, crf, rays, spp):
    """The benchmark's train loss (bench.py:91-100 of the JAX package):
    MSE of crf_forward(path_tracing_single(...)) to 0.5, one stochastic
    material query at the first hit, params {"material", "radiance",
    "crf_w"}. Without samples every step jitters the ray origins by a
    fresh 1e-6 draw, as the benchmark does."""
    import functools

    import torch

    from iris_tpu_torch.models.brdf import ngp_brdf_apply
    from iris_tpu_torch.models.crf import crf_forward
    from iris_tpu_torch.render.integrator import (
        draw_uniform, path_tracing_single)

    o, d, dxdu, dydv = (rays[:, i:i + 3] for i in (0, 3, 6, 9))

    def loss_fn(p, batch, gen, samples=None):
        em2 = dataclasses.replace(em, radiance=p["radiance"])
        crf2 = dataclasses.replace(crf, weight=p["crf_w"])
        mat_fn = functools.partial(
            ngp_brdf_apply, p["material"], gen=gen,
            samples=None if samples is None else samples["mat"])
        o_step = o if samples is not None else \
            o + draw_uniform(gen, (1, 3), o.device) * 1e-6
        l = path_tracing_single(
            gen, tracer, em2, mat_fn, o_step, d, dxdu, dydv, spp,
            samples=None if samples is None else samples["render"])
        ldr = crf_forward(crf2, l, 1.0)
        loss = torch.mean((ldr - 0.5) ** 2)
        return loss, {"loss": loss}

    return loss_fn


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=2,
                    help="timed flagship rounds (SPP=512 would be 64)")
    ap.add_argument("--sweep-only", action="store_true",
                    help="time the packet walks' widths on a train step's "
                    "rays and stop (no verdict line)")
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
    print(f"build: {build_s:.1f} s (nvcc traverse.cu + g++ bvh_builder.cpp)")
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
        print(f"{label}: {stats['rounds']} round(s){note} of "
              f"{stats['camera_samples_per_round']} camera samples, depth "
              f"{stats['depth']}: {stats['ms_per_round']:.2f} ms/round, "
              f"{stats['rays_per_s']:.0f} rays/s; launches "
              f"{stats['launches']}; mean HDR "
              f"{[round(x, 4) for x in stats['hdr_mean']]}, mean LDR "
              f"{[round(x, 4) for x in stats['ldr_mean']]}")

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

    # 10-11. each kernel on the largest input a main path gave it; the five
    # big-tree kernels on the same 518,400 rays of the 102K train step
    flush = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
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
        "five_on_102k_ms": turns, "five_on_102k_hits": agree,
        "packet_sweep_ms": sweep,
        "build_s": build_s, "total_s": time.perf_counter() - t_run}))
    for row in rows:
        check(row["launches"] > 0, f"{row['name']} was never launched on a "
              "main path")
    print(json.dumps({"kernels": rows}))

    # 12. verdict
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
