#!/usr/bin/env python3
"""On-card smoke run of iris_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py [--seed 0] [--rounds 4]

Needs one NVIDIA card (sm_90a: H100/H200), nvcc and g++. It builds the
traversal kernels from iris_tpu_torch/csrc/traverse.cu and the SAH builder
from csrc/bvh_builder.cpp, then:

1. prints the card's name and power limit (nvidia-smi);
2. builds the kernels and prints the build time and ptxas' report;
3. holds each kernel against its plain PyTorch version on the card
   (trace_union on the flagship tree, trace_paired on the 102,014-face
   clutter tree; 16,384 camera rays and 16,384 random rays each);
4. renders the flagship frame (398 faces, camera_rays(90) = 8,100 pixels)
   at the production width — 4-level x 16-feature x 2^19 row-mode hash
   grid (a 128 MB table), MLP 64-64-64-5, 3-basis EMoR CRF, 64^3 SLF
   seeded with nonzero radiance — at spp 8 and indir_depth 5, for
   --rounds rounds after one warm-up round (a cut of the 64 rounds that
   SPP=512 takes), with the AOV pass and CRF to LDR; and holds a small
   render on the card against the same render on the CPU;
5. renders one round of the 102,014-face clutter scene the same way;
6. prints one JSON line {"kernels": [...]} with each kernel's launches on
   the main path, its error against the plain version, its time, the plain
   version's time and its roofline bound, measured on the inputs the
   render gave the kernel;
7. prints the card line again and, last, the run's JSON verdict.

Any failed check raises, and the script then exits non-zero with no
verdict line. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
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
SPP = 8
INDIR_DEPTH = 5
CAMERA_SIDE = 90               # 8,100 pixels
CHECK_RAYS_SIDE = 128          # 16,384 rays per comparison set
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


def roofline(tracer, counts, n_rays, paired):
    """Least time for the walk this run's data needed: each ray read and
    each hit written once, the tree's useful bytes read once, and the slab
    and triangle tests the plain walk counted at the FP32 peak."""
    from iris_tpu_torch.geometry import cuda_intersect as ci

    if paired:
        _, _, n_pairs, n_leaf_rows = ci.pack_paired(tracer)
        tree = n_pairs * 16 * 4 + n_leaf_rows * tracer.leaf_size * 48
    else:
        tree = tracer.n_nodes * 32 + tracer.tris.shape[0] * 48
    nbytes = n_rays * (24 + 16) + tree
    ops = counts["slab"] * ci.SLAB_FLOPS + counts["mt"] * ci.MT_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes, ops


def time_ms(fn, reps, flush):
    """Median CUDA-event time of fn; the 50 MB L2 is flushed before each
    run (the render runs other kernels between traversals)."""
    import torch

    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def render_scene(label, tracer, em, mat_fn, crf, rays, n_rounds, seed):
    """Warm-up round (recording the largest traversal input), then
    n_rounds timed rounds through render_frame with launch counts reset
    just before and read just after. Returns (stats, captured input)."""
    import torch

    from iris_tpu_torch.geometry import cuda_intersect as ci
    from iris_tpu_torch.geometry import intersect
    from iris_tpu_torch.models.crf import crf_forward
    from iris_tpu_torch.pipeline.render import make_render_fns, render_frame

    render_chunk, aov_chunk = make_render_fns(tracer, em, mat_fn, SPP,
                                              INDIR_DEPTH)
    gen = torch.Generator(device=rays.device).manual_seed(seed)
    captured = {}
    ray_trace = intersect.ray_trace

    def recording(tr, xs, ds):
        if xs.shape[0] > captured.get("n", 0):
            captured.update(n=xs.shape[0], o=xs.detach().float().clone(),
                            d=ds.detach().float().clone())
        return ray_trace(tr, xs, ds)

    intersect.ray_trace = recording
    try:
        render_chunk(rays, gen)
        aov_chunk(rays, gen)
        torch.cuda.synchronize()
    finally:
        intersect.ray_trace = ray_trace

    ci.trace_union.launches = 0
    ci.trace_paired.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    l_img, aovs = render_frame(render_chunk, aov_chunk, rays, n_rounds, gen)
    end.record()
    end.synchronize()
    launches = {"trace_union": ci.trace_union.launches,
                "trace_paired": ci.trace_paired.launches}

    import numpy as np

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
             "launches": launches, "hdr_mean": l_img.mean(0).tolist(),
             "ldr_mean": ldr.mean(0).tolist(),
             "largest_trace_rays": captured["n"]}
    return stats, captured


def small_reference_check(tracer, em, ngp, dev, seed):
    """The same 64-pixel render (spp 2, depth 5) on the card and on the
    CPU under common random numbers. The CPU run walks the plain
    traversal and computes everything with CPU kernels. Bar: radiance
    within rtol 2e-3 / atol 1e-4 on >= 95% of values, and AOVs within
    rtol 1e-2 / atol 1e-3: bf16 rounding of MLP sums taken in another
    order can move a path now and then (tests/test_torch_slice.py)."""
    import dataclasses

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

    def to(obj, d):
        if isinstance(obj, torch.Tensor):
            return obj.to(d)
        if isinstance(obj, dict):
            return {k: to(v, d) for k, v in obj.items()}
        if isinstance(obj, list):
            return [to(v, d) for v in obj]
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            return dataclasses.replace(obj, **{
                f.name: to(getattr(obj, f.name), d)
                for f in dataclasses.fields(obj) if f.init})
        return obj

    out = []
    for d in (dev, torch.device("cpu")):
        tr, e, g = to(tracer, d), to(em, d), to(ngp, d)
        tr.paired = None
        rc, ac = make_render_fns(tr, e, demo_mat_fn(g), spp, depth)
        out.append((rc(rays.to(d), samples=to(s, d)).cpu().numpy(),
                    [a.cpu().numpy() for a in
                     ac(rays.to(d), samples=to(s_aov, d))]))
    (lg, ag), (lc, ac_) = out
    close = np.abs(lg - lc) <= 1e-4 + 2e-3 * np.abs(lc)
    check(close.mean() >= 0.95,
          f"card vs CPU radiance: {close.mean():.4f} of values close")
    for a, c in zip(ag, ac_):
        check(bool(np.allclose(a, c, rtol=1e-2, atol=1e-3)),
              "card vs CPU AOVs differ")
    return float(close.mean()), float(np.abs(lg - lc).max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=4,
                    help="timed flagship rounds (SPP=512 would be 64)")
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

    # scenes at production width
    def scene(n_clutter):
        t0 = time.perf_counter()
        tracer, em, ngp, crf, mesh = make_demo_scene(
            n_clutter=n_clutter, slf_res=64, hash_levels=4, log2_table=19,
            hash_features=16, per_level_scale=-1.0, seed=args.seed,
            device=dev)
        seed_slf(em, args.seed, dev)
        print(f"scene n_clutter={n_clutter}: {mesh.n_faces} faces, "
              f"{tracer.n_nodes} nodes, depth {tracer.depth}, "
              f"layout {tracer.layout}, built in "
              f"{time.perf_counter() - t0:.1f} s")
        return tracer, em, ngp, crf, mesh

    flag = scene(FLAGSHIP_CLUTTER)
    big = scene(CLUTTER_102K)
    for n_clutter, (_, _, _, _, mesh) in ((FLAGSHIP_CLUTTER, flag),
                                          (CLUTTER_102K, big)):
        check(mesh.n_faces == 12 * (n_clutter + 1) + 2, "scene face count")
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
    kernel_specs = [
        ("trace_union", ci.trace_union, ci.trace_union_plain, flag[0],
         "pallas_ray_trace (iris_tpu/geometry/pallas_intersect.py:240, "
         "_kernel :176)"),
        ("trace_paired", ci.trace_paired, ci.trace_paired_plain, big[0],
         "pallas_ray_trace_paired (iris_tpu/geometry/pallas_intersect.py"
         ":782, _kernel_paired :675)"),
    ]
    max_err = {}
    for name, kernel, plain, tracer, _ in kernel_specs:
        for label, (o, d) in ray_sets.items():
            o_t = torch.from_numpy(np.ascontiguousarray(o)).to(dev)
            d_t = torch.from_numpy(np.ascontiguousarray(d)).to(dev)
            got = kernel(tracer, o_t, d_t)
            torch.cuda.synchronize()
            err, same = compare_hits(got, plain(tracer, o_t, d_t))
            max_err[name] = max(max_err.get(name, 0.0), err)
            print(f"check {name} {label} ({n_check} rays): hits "
                  f"{int((got[3] >= 0).sum())}, bit-equal {same}/{n_check},"
                  f" max |t| error {err:.3e}")

    # 4. the flagship frame
    flag_stats, flag_in = render_scene(
        "flagship", flag[0], flag[1], demo_mat_fn(flag[2]), flag[3],
        frame_rays(dev), args.rounds, args.seed)
    check(flag_stats["launches"]["trace_union"] > 0,
          "flagship render launched no trace_union")
    print(f"flagship: {args.rounds} rounds (cut from SPP=512's 64) of "
          f"{flag_stats['camera_samples_per_round']} camera samples: "
          f"{flag_stats['ms_per_round']:.2f} ms/round, "
          f"{flag_stats['rays_per_s']:.0f} rays/s; launches "
          f"{flag_stats['launches']}; mean HDR "
          f"{[round(x, 4) for x in flag_stats['hdr_mean']]}, mean LDR "
          f"{[round(x, 4) for x in flag_stats['ldr_mean']]}")
    frac, worst = small_reference_check(flag[0], flag[1], flag[2], dev,
                                        args.seed)
    print(f"flagship card vs CPU (64 px, spp 2): {frac:.4f} of radiance "
          f"values within rtol 2e-3/atol 1e-4, max |diff| {worst:.3e}")

    # 5. one round of the 102K-face scene
    big_stats, big_in = render_scene(
        "clutter102k", big[0], big[1], demo_mat_fn(big[2]), big[3],
        frame_rays(dev), 1, args.seed)
    check(big_stats["launches"]["trace_paired"] > 0,
          "102K render launched no trace_paired")
    print(f"clutter102k: 1 round of {big_stats['camera_samples_per_round']}"
          f" camera samples: {big_stats['ms_per_round']:.2f} ms/round, "
          f"{big_stats['rays_per_s']:.0f} rays/s; launches "
          f"{big_stats['launches']}; tree depth {big[0].depth}, stack "
          f"{ci.auto_stack_depth(big[0])}")

    # 6. each kernel on the inputs the render gave it
    flush = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    rows = []
    for (name, kernel, plain, tracer, replaces), captured, stats in zip(
            kernel_specs, (flag_in, big_in), (flag_stats, big_stats)):
        o, d = captured["o"], captured["d"]
        got = kernel(tracer, o, d)
        torch.cuda.synchronize()
        counts = {}
        err, same = compare_hits(got, plain(tracer, o, d, counts=counts))
        max_err[name] = max(max_err[name], err)
        ms = time_ms(lambda: kernel(tracer, o, d), 20, flush)
        plain_ms = time_ms(lambda: plain(tracer, o, d), 3, flush)
        bound_ms, bound_by, nbytes, ops = roofline(
            tracer, counts, o.shape[0], name == "trace_paired")
        print(f"{name} on the render's {o.shape[0]}-ray trace: {ms:.4f} ms "
              f"(plain {plain_ms:.2f} ms, bound {bound_ms:.5f} ms by "
              f"{bound_by}: {nbytes} B, {ops} FP32 ops from "
              f"{counts['slab']} slab + {counts['mt']} triangle tests); "
              f"bit-equal {same}/{o.shape[0]}")
        rows.append({
            "name": name, "route": "cuda",
            "source": "iris_tpu_torch/csrc/traverse.cu",
            "replaces": replaces,
            "launches": stats["launches"][name],
            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    print("run: " + json.dumps({
        "flagship": flag_stats, "clutter102k": big_stats,
        "build_s": build_s, "total_s": time.perf_counter() - t_run}))
    print(json.dumps({"kernels": rows}))

    # 7. verdict
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
