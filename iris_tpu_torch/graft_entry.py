"""The entry of a compile check and a data-parallel dry run, on the card
(twin of the repository's root __graft_entry__.py, which does both for
the JAX package).

entry(device=None) -> (fn, example_args): the single-card forward step of
    the flagship model, crf_forward(path_tracing_single(...)) over the
    hash-grid BRDF, the SLF emitter and the CRF, with the example rays on
    the device and a torch.Generator where the JAX entry takes a PRNG key.
dryrun_multichip(n, device=None, backend=None) -> the loss of one full
    training step of a tiny model on n ranks: parameters replicated, the
    batch split over the ranks, the gradients averaged (train.loop's
    data-parallel step, parallel/).

    python -m iris_tpu_torch.graft_entry [--ranks 2] [--device cuda]
        [--dist_backend nccl|gloo]

runs the entry's forward on the device and then the dry run. The JAX dry
run falls back to CPU devices when it finds fewer than n; this one does
not: NCCL takes one card a rank and raises if fewer are visible,
backend="gloo" puts every rank on the one device (ranks sharing a card),
device="cpu" is gloo on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import math

import numpy as np
import torch

from iris_tpu_torch.demo import demo_mat_fn, make_demo_batch, make_demo_scene
from iris_tpu_torch.device import resolve_device


def entry(device=None):
    """(fn, example_args): fn(rays_o, rays_d, dx_du, dy_dv, gen,
    samples=None) -> (B, 3) LDR of path_tracing_single at spp 4 through the
    CRF, on the demo scene with 8 clutter boxes and an 8-level x 8-feature
    x 2^15 row-mode grid; `samples` replaces the generator's draws (the
    parity tests replay the JAX key's through it). example_args are the
    camera_rays(32) tensors on the device and a generator seeded 0."""
    from iris_tpu_torch.geometry.procedural import camera_rays
    from iris_tpu_torch.models.crf import crf_forward
    from iris_tpu_torch.render.integrator import path_tracing_single

    dev = resolve_device(device)
    tracer, em, ngp, crf, _ = make_demo_scene(
        n_clutter=8, hash_levels=8, hash_features=8, log2_table=15,
        device=dev)

    def fn(rays_o, rays_d, dx_du, dy_dv, gen, samples=None):
        l = path_tracing_single(gen, tracer, em, demo_mat_fn(ngp), rays_o,
                                rays_d, dx_du, dy_dv, spp=4, samples=samples)
        return crf_forward(crf, l, 1.0)

    rays = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in camera_rays(32))
    return fn, rays + (torch.Generator(device=dev).manual_seed(0),)


def dryrun_step(n_ranks: int, group=None, device=None) -> float:
    """The loss of one training step of the dry run's model: the demo scene
    with 2 clutter boxes, an 8^3 SLF and a 4-level x 4-feature x 2^8
    row-mode grid with the trainers' estimators (stochastic forward and
    backward, auto level-block sampling), the initialize loss at spp 2,
    Adam, on the 64-pixel demo batch cut to a multiple of n_ranks; on the
    group's ranks (each renders its rows) or, with no group, in this
    process on `device`. Both draw from step_generator(0, 0), so one
    process takes each ray's numbers of the n-rank step."""
    from iris_tpu_torch.models.hashgrid import auto_bwd_level_sample
    from iris_tpu_torch.pipeline.common import mesh_batch_size
    from iris_tpu_torch.train.loop import make_train_step, step_generator
    from iris_tpu_torch.train.optim import make_optimizer
    from iris_tpu_torch.train.steps import LossConfig, make_initialize_loss

    dev = group.device if group is not None else resolve_device(device)
    tracer, em, ngp, crf, _ = make_demo_scene(
        n_clutter=2, slf_res=8, hash_levels=4, log2_table=8,
        hash_features=4, device=dev)
    ngp = dataclasses.replace(ngp, cfg=dataclasses.replace(
        ngp.cfg, stochastic_fwd=True, stochastic_bwd=True,
        bwd_level_sample=auto_bwd_level_sample(4)))
    loss_fn = make_initialize_loss(tracer, em, crf,
                                   LossConfig(spp=2, max_segments=8))
    params = {"material": ngp, "radiance": em.radiance.clone()}
    opt = make_optimizer()
    batch = make_demo_batch(n_side=8, device=dev)
    b = mesh_batch_size(batch["rays"].shape[0], n_ranks, "dryrun")
    batch = {k: v[:b] for k, v in batch.items()}
    step = make_train_step(loss_fn, opt, group)
    _, _, loss, _ = step(params, opt.init(params), batch,
                         step_generator(0, 0, dev, group))
    return float(loss)


def _dryrun_rank(group, n_ranks):
    return dryrun_step(n_ranks, group)


def dryrun_multichip(n_devices: int, device=None, backend=None) -> float:
    """One training step of dryrun_step's model on n_devices ranks, each a
    spawned process: NCCL on the card, one card a rank (raising if fewer
    are visible); backend="gloo", every rank on `device`; device="cpu",
    gloo on the CPU. Raises unless the loss is finite and the same on
    every rank; prints `dryrun_multichip(n): OK  loss=...` and returns
    the loss."""
    from iris_tpu_torch.parallel.comms_report import rank_devices
    from iris_tpu_torch.parallel.distributed import spawn_ranks

    devices, backend = rank_devices(device, backend, n_devices)
    losses = spawn_ranks(_dryrun_rank, devices, backend, args=(n_devices,))
    loss = losses[0]
    if not math.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip({n_devices}): non-finite "
                           f"loss {loss}")
    if any(x != loss for x in losses):
        raise RuntimeError(f"dryrun_multichip({n_devices}): the ranks' "
                           f"losses differ: {losses}")
    print(f"dryrun_multichip({n_devices}): OK  loss={loss:.6f}", flush=True)
    return loss


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", default=None, help="default the card")
    p.add_argument("--dist_backend", default=None,
                   help="default nccl on the card, gloo on the CPU")
    a = p.parse_args(argv)
    fn, args = entry(a.device)
    with torch.no_grad():
        out = fn(*args)
    print("entry forward:", tuple(out.shape), float(out.mean()), flush=True)
    dryrun_multichip(a.ranks, a.device, a.dist_backend)


if __name__ == "__main__":
    main()
