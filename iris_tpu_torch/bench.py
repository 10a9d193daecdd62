"""Benchmark: forward+backward path-trace throughput on the card (twin of
the repository's root bench.py, which times the JAX package).

    python -m iris_tpu_torch.bench [--small-only] [--device cuda]

The work timed is the JAX benchmark's: the gradient of
mean((crf_forward(path_tracing_single(...)) - 0.5)^2) with respect to the
material (hash grid and MLP), the emitter radiance and the CRF weights,
with no optimizer update, at the production model (the 4-level x
16-feature x 2^19 row-mode hash grid, a 128 MB table, with the trainers'
estimators: stochastic forward and backward, auto level-block sampling,
compact bf16 scatter), on 8,100 camera rays (camera_rays(90)) at spp 32:
259,200 camera samples a step, each costing the traversals of its camera
ray and of its fused NEE + bounce ray, two material queries and NEE. The
SLF radiance is the demo's, zero. A "ray" is one camera sample, as the
JAX benchmark counts it.

Each call draws a fresh 1e-6 jitter of the ray origins and fresh samples
from its own generator, and folds every gradient leaf into the scalar it
returns (sum(g^2) * 1e-20), so that no backward is skipped. The calls go
through utils.timing.bench_scan: queued back to back between two CUDA
events, one synchronisation at the end, a warm-up call first. The JAX
helper runs them inside one jitted lax.scan; the port runs each step
eagerly, about a thousand launches, and a step's host work is longer than
its device work, so this time is the host's enqueue rate: what the port
costs today, not the card's limit. The time of every call is printed
beside the mean.

One JSON line: "metric" (train_fwd_bwd_rays_per_s), "value" (the 398-face
flagship), "unit", "rays_per_s_102k_faces" and "kernel_mode_102k" (the
102,014-face scene, the traversal kernel kernel_for picks for it; skipped
with --small-only), "device" (the card's name and power limit), and
"runs": per scene measure()'s record but the rate: its faces, kernel,
calls (the warm-up too), the seconds of each timed call and the traversal
launches of all of them. The JAX
line's "vs_baseline" is missing: it compares with BASELINE_BENCH.json, a
TPU number, which is no target of the port, so the twin reads and writes
no baseline file.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json

import numpy as np
import torch

from iris_tpu_torch.utils.timing import bench_scan

BATCH = 8192          # the reference training batch: camera_rays(90)
SPP = 32              # the reference per-round spp
HASH_LEVELS = 4       # the production grid (pipeline/config.py)
HASH_FEATURES = 16
LOG2_TABLE = 19
FLAGSHIP = 32         # clutter boxes: 398 faces
CLUTTER_102K = 8500   # 102,014 faces
ITERS = 24
ITERS_102K = 8


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


def bench_rays(device) -> torch.Tensor:
    """(N, 12) rays (origin, direction, the two pixel differentials) of
    camera_rays(int(BATCH ** 0.5)) on `device`."""
    from iris_tpu_torch.geometry.procedural import camera_rays

    rays = np.concatenate(camera_rays(int(BATCH ** 0.5)), -1)
    return torch.from_numpy(rays.astype(np.float32)).to(device)


def setup(n_clutter: int, device=None):
    """(tracer, mesh, rays, params, loss_fn) of the benchmark step on the
    demo scene with n_clutter boxes, at the module's widths."""
    from iris_tpu_torch.demo import make_demo_scene
    from iris_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    tracer, em, ngp, crf, mesh = make_demo_scene(
        n_clutter=n_clutter, slf_res=64, hash_levels=HASH_LEVELS,
        log2_table=LOG2_TABLE, hash_features=HASH_FEATURES,
        per_level_scale=-1.0, device=dev)
    rays = bench_rays(dev)
    return (tracer, mesh, rays, bench_params(em, ngp, crf),
            make_bench_loss(tracer, em, crf, rays, SPP))


def grad_step(loss_fn, params):
    """step(gen) -> a scalar that every gradient leaf of one call of the
    loss is folded into (bench.py:105-114 of the JAX package)."""
    from iris_tpu_torch.train.loop import value_and_grad

    def step(gen):
        _, _, grads = value_and_grad(loss_fn, params, {}, gen)
        acc = torch.zeros((), device=next(iter(grads.values())).device)
        for g in grads.values():
            acc = acc + torch.sum(g.float() ** 2) * 1e-20
        return acc

    return step


def launch_counts() -> dict:
    """Each traversal kernel's launches so far (the wrappers' counters)."""
    from iris_tpu_torch.geometry import cuda_intersect as ci

    return {name: getattr(ci, name).launches for name in ci.KERNELS}


def measure(n_clutter: int, iters: int, device=None) -> dict:
    """Camera samples a second of the benchmark step on the demo scene with
    n_clutter boxes, timed over `iters` calls after a warm-up call
    (utils.timing.bench_scan, seed 0), with the scene's faces, the
    traversal kernel it runs, each call's seconds and the traversal
    launches of all iters + 1 calls."""
    from iris_tpu_torch.geometry.intersect import kernel_for

    tracer, mesh, rays, params, loss_fn = setup(n_clutter, device)
    before = launch_counts()
    calls = []
    dt = bench_scan(grad_step(loss_fn, params), 0, iters=iters,
                    device=rays.device, call_times=calls)
    launched = {k: v - before[k] for k, v in launch_counts().items()
                if v != before[k]}
    return {"rays_per_s": rays.shape[0] * SPP / dt,
            "faces": int(mesh.n_faces),
            "kernel_mode": kernel_for(tracer).__name__,
            "calls": iters + 1, "s_per_call": calls,
            "launches": launched}


def _details(m: dict) -> dict:
    return {k: v for k, v in m.items() if k != "rays_per_s"}


def main(argv=None) -> dict:
    from iris_tpu_torch.device import describe, resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--small-only", action="store_true",
                   help="the flagship scene alone, no 102,014-face run")
    p.add_argument("--device", default=None, help="default the card")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    head = measure(FLAGSHIP, ITERS, dev)
    big = None if a.small_only else measure(CLUTTER_102K, ITERS_102K, dev)
    out = {"metric": "train_fwd_bwd_rays_per_s",
           "value": round(head["rays_per_s"], 1), "unit": "rays/s/chip"}
    runs = {"flagship": _details(head)}
    if big is not None:
        out["rays_per_s_102k_faces"] = round(big["rays_per_s"], 1)
        out["kernel_mode_102k"] = big["kernel_mode"]
        runs["clutter102k"] = _details(big)
    out["device"] = describe(dev)
    out["runs"] = runs
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
