"""Data-parallel scaling harness (twin of the repository's root
bench_scaling.py): camera samples a second of a full training step (the
initialize loss, Adam) on 1, 2, 4, ... ranks, each rank a spawned process
that renders its rows of the batch, the gradients averaged over the ranks
(train.loop's data-parallel step), and the efficiency against linear
scaling from one rank.

    python -m iris_tpu_torch.bench_scaling [--batch 8192] [--spp 8]
        [--iters 5] [--device cuda] [--dist_backend nccl|gloo]
        [--max_ranks N]

By default the ranks are NCCL ranks, one card each, at counts up to the
cards visible. --dist_backend gloo --max_ranks N puts N ranks on the one
--device (ranks sharing a card); --device cpu runs gloo ranks on the CPU.
Both are functional runs, asked for, not fallen back to: ranks that share
a device, or move their gradients through the host, give no scaling
figure.

The model is the JAX harness's scaled-down one: the demo scene with 8
clutter boxes, a 32^3 SLF and an 8-level x 8-feature x 2^14 row-mode grid,
the initialize loss at `--spp` with 16 segments, on the demo batch of
camera_rays(int(batch ** 0.5)) pixels cut to a multiple of the rank
count. Time: rank 0's host clock around `iters` steps after a warm-up
step, ending in torch.cuda.synchronize on the card.

One JSON line a count: "metric" (scaling_rays_per_s), "devices" (the rank
count), "value", "unit", "efficiency_vs_linear", and "backend" and
"device" (the device's name and power limit).
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def _scaling_rank(group, n_ranks, batch, spp, iters):
    """Seconds a step on this rank, and the rays of the global batch."""
    from iris_tpu_torch.demo import make_demo_batch, make_demo_scene
    from iris_tpu_torch.pipeline.common import mesh_batch_size
    from iris_tpu_torch.train.loop import make_train_step, step_generator
    from iris_tpu_torch.train.optim import make_optimizer
    from iris_tpu_torch.train.steps import LossConfig, make_initialize_loss

    dev = group.device
    tracer, em, ngp, crf, _ = make_demo_scene(
        n_clutter=8, slf_res=32, hash_levels=8, hash_features=8,
        per_level_scale=-1.0, log2_table=14, device=dev)
    loss_fn = make_initialize_loss(tracer, em, crf,
                                   LossConfig(spp=spp, max_segments=16))
    opt = make_optimizer()
    params = {"material": ngp, "radiance": em.radiance.clone()}
    state = opt.init(params)
    pixels = make_demo_batch(n_side=int(batch ** 0.5), device=dev)
    b = mesh_batch_size(pixels["rays"].shape[0], n_ranks, "scaling")
    rows = {k: v[:b] for k, v in pixels.items()}
    step = make_train_step(loss_fn, opt, group)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    step(params, state, rows, step_generator(0, 0, dev, group))
    sync()
    t0 = time.perf_counter()
    for i in range(iters):
        step(params, state, rows, step_generator(0, i + 1, dev, group))
    sync()
    return (time.perf_counter() - t0) / iters, b


def rank_counts(device, backend, max_ranks) -> list:
    """1, 2, 4, ... up to max_ranks; by default up to the cards visible
    for NCCL ranks, else one."""
    if max_ranks is None:
        nccl = torch.device(device).type == "cuda" and backend in (None,
                                                                   "nccl")
        max_ranks = torch.cuda.device_count() if nccl else 1
    counts, n = [], 1
    while n <= max_ranks:
        counts.append(n)
        n *= 2
    return counts


def main(argv=None) -> list:
    from iris_tpu_torch.device import describe, resolve_device
    from iris_tpu_torch.parallel.comms_report import rank_devices
    from iris_tpu_torch.parallel.distributed import spawn_ranks

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--device", default=None, help="default the card")
    p.add_argument("--dist_backend", default=None,
                   help="default nccl on the card, gloo on the CPU")
    p.add_argument("--max_ranks", type=int, default=None,
                   help="default the cards visible (NCCL), else 1")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    card = describe(dev)
    out, first = [], None
    for n in rank_counts(dev, a.dist_backend, a.max_ranks):
        devices, backend = rank_devices(dev, a.dist_backend, n)
        dt, rays = spawn_ranks(_scaling_rank, devices, backend,
                               args=(n, a.batch, a.spp, a.iters))[0]
        rps = rays * a.spp / dt
        first = rps if n == 1 else first
        rec = {"metric": "scaling_rays_per_s", "devices": n,
               "value": round(rps, 1), "unit": "rays/s",
               "efficiency_vs_linear": round(rps / (first * n), 4),
               "backend": backend, "device": card}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
