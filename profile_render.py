#!/usr/bin/env python3
"""Where one render round of iris_tpu_torch spends its time on the card.

    python3 profile_render.py [--seed 0] [--out outputs/render_trace.json]

For each cell of chip_smoke.py (the flagship scene and the 102,014-face
clutter scene, production-width model, spp 8, depth 5, 8,100 pixels), it
renders one warm-up round and then one round under torch.profiler (CPU and
CUDA activities), and prints: the round's wall time, the summed device
time of its kernels and the device's idle share, the number of kernels
launched, the traversal kernels' share, and the kernels that took the most
device time. The Chrome trace of each profiled round is written next to
--out. Needs one CUDA card.
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


def profile_cell(label, n_clutter, seed, out):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import INDIR_DEPTH, SPP, frame_rays, seed_slf
    from iris_tpu_torch.demo import demo_mat_fn, make_demo_scene
    from iris_tpu_torch.pipeline.render import make_render_fns

    dev = torch.device("cuda")
    tracer, em, ngp, _, _ = make_demo_scene(
        n_clutter=n_clutter, slf_res=64, hash_levels=4, log2_table=19,
        hash_features=16, per_level_scale=-1.0, seed=seed, device=dev)
    seed_slf(em, seed, dev)
    rays = frame_rays(dev)
    render_chunk, aov_chunk = make_render_fns(tracer, em, demo_mat_fn(ngp),
                                              SPP, INDIR_DEPTH)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def one_round():
        render_chunk(rays, gen)
        aov_chunk(rays, gen)
        torch.cuda.synchronize()

    one_round()                                       # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_round()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(out.replace(".json", f"_{label}.json"))

    # kernel events only (CPU ops also carry their kernels' device time)
    kernels = [e for e in prof.key_averages()
               if device_time_us(e) > 0
               and str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    busy_ms = sum(device_time_us(e) for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    trav_ms = sum(device_time_us(e) for e in kernels
                  if "trace_union" in e.key or "trace_paired" in e.key) / 1e3
    print(f"{label}: round wall {wall_ms:.2f} ms (under the profiler); "
          f"device busy {busy_ms:.2f} ms, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; {n_kernels} kernels; "
          f"traversal {trav_ms:.3f} ms = {trav_ms / busy_ms:.3f} of device "
          f"time")
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
        profile_cell(label, n_clutter, args.seed, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
