"""Component benchmarks on the card (twin of the repository's root
bench_components.py): one JSON line a component, under the JAX metric
names, with "value", "unit", "ms" (a call's mean), "peak_mb" (the
process's peak device memory while the component ran, what the process
held before it included) and "device" (the card's name and power limit).

    python -m iris_tpu_torch.bench_components [--device cuda]

Each component goes through utils.timing.bench_scan: 16 calls captured
in one CUDA graph after a warm-up call, one warm replay, then the median
of three timed replays, each call with a torch.Generator of its own
seeded from the component's seed (0 for the traversal, 1 for the encode
forwards, 2 for their fwd+bwd, 3 and 4 for the path tracer's, the seeds
of the JAX keys), which draws its inputs afresh. Every component is
captured: nothing in a call reads the card from the host. Each call returns a scalar that depends on all of its work (a sum
of face ids, of features, of a whole table gradient), as the JAX probes
do to keep the compiler from dropping it; eager PyTorch drops nothing,
and the sums keep the calls alike.

The components, on the flagship demo scene (398 faces) with a 16-level x
2-feature x 2^19 packed grid:

- traversal_rays_per_s: ray_intersect on camera_rays(512) (262,144 rays),
  the origins jittered by U(0, 1) x 0.2 a call;
- hashgrid{16,32}_fwd_queries_per_s and
  hashgrid{16,32}_{exact,stoch_bwd,stoch_fwd,stoch_fwd_ls4}_fwd_bwd_
  queries_per_s: the packed encode (HashGridConfig's defaults at 2^19) of
  262,144 uniform positions, forward alone and forward with the whole
  table gradient; stoch_fwd_ls4 samples levels // 4 level blocks;
- hashgrid8x8row_fwd_queries_per_s and
  hashgrid8x8row_default_fwd_bwd_queries_per_s: the 8 x 8 row grid with
  the stochastic estimators and 2 of 8 level blocks;
- pts_fwd_rays_per_s and pts_fwd_bwd_{exact,stoch_bwd,stoch_fwd_ls4}_
  rays_per_s: path_tracing_single on camera_rays(90) at spp 32 (259,200
  camera samples), forward alone and with the gradient of
  mean(crf_forward(...)^2) into every material leaf (the table's summed).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json

import numpy as np
import torch

B, SPP = 8192, 32
N_QUERIES = B * SPP    # 262,144: a train step's material queries
TRAVERSAL_SIDE = 512   # camera_rays(512): 262,144 rays
LOG2_TABLE = 19
LEVELS = (16, 32)
ITERS = 16


def face_sum(tracer, o, d):
    """The sum of the face ids ray_intersect finds (-1 a miss)."""
    from iris_tpu_torch.geometry.intersect import ray_intersect

    return ray_intersect(tracer, o, d)[3].sum()


def encode_sum(table, cfg, x, gen=None):
    """The sum of hashgrid_encode's features of positions x."""
    from iris_tpu_torch.models.hashgrid import hashgrid_encode

    return hashgrid_encode(table, cfg, x, gen).sum()


def encode_grad_sum(table, cfg, x, gen=None):
    """The sum of the whole table gradient of encode_sum."""
    t = table.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(encode_sum(t, cfg, x, gen), t)
    return g.sum()


def pts_sum(tracer, em, ngp, rays, gen):
    """The sum of path_tracing_single's radiance at spp SPP, exact
    material."""
    from iris_tpu_torch.demo import demo_mat_fn
    from iris_tpu_torch.render.integrator import path_tracing_single

    with torch.no_grad():
        return path_tracing_single(gen, tracer, em, demo_mat_fn(ngp),
                                   *_ray_args(rays), SPP).sum()


def pts_grad_sum(tracer, em, ngp, crf, rays, gen, use_key):
    """The sum of the table gradient of mean(crf_forward(
    path_tracing_single(...), 1)^2), the gradient taken into every
    material leaf; with use_key the material query draws its stochastic
    corners from `gen`, else it is exact."""
    from iris_tpu_torch.models.brdf import ngp_brdf_apply
    from iris_tpu_torch.models.crf import crf_forward
    from iris_tpu_torch.render.integrator import path_tracing_single
    from iris_tpu_torch.train.loop import value_and_grad

    def loss_fn(p, batch, gen, samples=None):
        mat_fn = functools.partial(ngp_brdf_apply, p["material"],
                                   gen=gen if use_key else None)
        l = path_tracing_single(gen, tracer, em, mat_fn, *_ray_args(rays),
                                SPP)
        return torch.mean(crf_forward(crf, l, 1.0) ** 2), {}

    _, _, grads = value_and_grad(loss_fn, {"material": ngp}, {}, gen)
    return grads["material.table"].sum()


def _ray_args(rays):
    return tuple(rays[:, i:i + 3] for i in (0, 3, 6, 9))


def _rays(side, dev):
    from iris_tpu_torch.geometry.procedural import camera_rays

    rays = np.concatenate(camera_rays(side), -1).astype(np.float32)
    return torch.from_numpy(rays).to(dev)


def components(dev, n=N_QUERIES):
    """(metric, fn(gen) -> scalar, seed, units a call, unit) of every
    component, in the JAX order."""
    from iris_tpu_torch.demo import make_demo_scene
    from iris_tpu_torch.models.hashgrid import HashGridConfig, init_hashgrid
    from iris_tpu_torch.render.integrator import draw_uniform

    tracer, em, ngp, crf, _ = make_demo_scene(
        n_clutter=32, slf_res=64, hash_levels=16, log2_table=LOG2_TABLE,
        device=dev)

    def u(gen, shape):
        return draw_uniform(gen, shape, dev)

    cam = _rays(TRAVERSAL_SIDE, dev)
    o0, d0 = cam[:, :3].contiguous(), cam[:, 3:6].contiguous()
    yield ("traversal_rays_per_s",
           lambda g: face_sum(tracer, o0 + u(g, (1, 3)) * 0.2, d0), 0,
           o0.shape[0], "rays/s")

    for levels in LEVELS:
        cfg0 = HashGridConfig(n_levels=levels, log2_table_size=LOG2_TABLE)
        table = init_hashgrid(torch.Generator(device=dev).manual_seed(7),
                              cfg0, dev)
        variants = {
            "exact": (dataclasses.replace(cfg0, stochastic_bwd=False),
                      False),
            "stoch_bwd": (cfg0, True),
            "stoch_fwd": (dataclasses.replace(cfg0, stochastic_fwd=True),
                          True),
            "stoch_fwd_ls4": (dataclasses.replace(
                cfg0, stochastic_fwd=True, bwd_level_sample=levels // 4),
                True),
        }
        for name, (cfg, use_key) in variants.items():
            if name == "exact":
                yield (f"hashgrid{levels}_fwd_queries_per_s",
                       lambda g, t=table, cfg=cfg: encode_sum(
                           t, cfg, u(g, (n, 3))), 1, n, "queries/s")
            yield (f"hashgrid{levels}_{name}_fwd_bwd_queries_per_s",
                   lambda g, t=table, cfg=cfg, k=use_key: encode_grad_sum(
                       t, cfg, u(g, (n, 3)), g if k else None), 2, n,
                   "queries/s")

    cfg_row = HashGridConfig(n_levels=8, n_features=8,
                             log2_table_size=LOG2_TABLE,
                             per_level_scale=1.3 ** (31.0 / 7.0),
                             row_gather=True, stochastic_fwd=True,
                             stochastic_bwd=True, bwd_level_sample=2)
    table_row = init_hashgrid(torch.Generator(device=dev).manual_seed(7),
                              cfg_row, dev)
    exact_row = dataclasses.replace(cfg_row, stochastic_fwd=False,
                                    stochastic_bwd=False)
    yield ("hashgrid8x8row_fwd_queries_per_s",
           lambda g: encode_sum(table_row, exact_row, u(g, (n, 3))), 1, n,
           "queries/s")
    yield ("hashgrid8x8row_default_fwd_bwd_queries_per_s",
           lambda g: encode_grad_sum(table_row, cfg_row, u(g, (n, 3)), g),
           2, n, "queries/s")

    rays = _rays(int(B ** 0.5), dev)
    samples = rays.shape[0] * SPP
    yield ("pts_fwd_rays_per_s", lambda g: pts_sum(tracer, em, ngp, rays, g),
           3, samples, "rays/s")
    ngp_ls = dataclasses.replace(ngp, cfg=dataclasses.replace(
        ngp.cfg, stochastic_fwd=True,
        bwd_level_sample=ngp.cfg.n_levels // 4))
    for name, use_key, p in (("exact", False, ngp), ("stoch_bwd", True, ngp),
                             ("stoch_fwd_ls4", True, ngp_ls)):
        yield (f"pts_fwd_bwd_{name}_rays_per_s",
               lambda g, p=p, k=use_key: pts_grad_sum(
                   tracer, em, p, crf, rays, g, k), 4, samples, "rays/s")


def main(argv=None) -> list:
    from iris_tpu_torch.device import describe, resolve_device
    from iris_tpu_torch.utils.timing import bench_scan

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None, help="default the card")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    card = describe(dev)
    out = []
    for name, fn, seed, count, unit in components(dev):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        dt = bench_scan(fn, seed, iters=ITERS, device=dev)
        rec = {"metric": name, "value": round(count / dt, 1), "unit": unit,
               "ms": round(dt * 1e3, 3),
               "peak_mb": round(torch.cuda.max_memory_allocated(dev)
                                / 2 ** 20, 1),
               "device": card}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
