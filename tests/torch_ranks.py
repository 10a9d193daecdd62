"""Rank processes for the data-parallel tests (tests/test_torch_parallel.py,
tests/test_torch_comms_report.py): each test's ranks are spawned
processes (torch.multiprocessing, spawn) of one torch thread each, joined
in a gloo group on the CPU through a rendezvous file under the test's
tmp_path (no port to race for under parallel test workers). This module
imports no JAX, so that the ranks start quickly."""

from __future__ import annotations

import dataclasses
import os
import pickle

import torch

from iris_tpu_torch import convert
from iris_tpu_torch.parallel.distributed import ensure_multihost
from iris_tpu_torch.train import steps as tsteps
from iris_tpu_torch.train.loop import (
    batch_to_device, run_training, step_generator, value_and_grad,
)
from iris_tpu_torch.train.optim import make_optimizer, named_leaves

SEED = 11


def spawn(fn, world: int, tmp_path, *args, device: str = "cpu") -> list:
    """fn(group, *args) on `world` gloo ranks on the CPU, or with
    device="cuda" NCCL ranks on cuda:0..world-1; the results by rank. A
    rank that raises fails the call."""
    out_dir = os.path.join(str(tmp_path), f"ranks_{fn.__name__}")
    os.makedirs(out_dir, exist_ok=True)
    coordinator = "file://" + os.path.join(out_dir, "rendezvous")
    torch.multiprocessing.start_processes(
        _entry, args=(fn, world, coordinator, out_dir, device, args),
        nprocs=world, join=True, start_method="spawn")
    got = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            got.append(pickle.load(f))
    return got


def _entry(rank, fn, world, coordinator, out_dir, device, args):
    torch.set_num_threads(1)
    group = ensure_multihost(
        coordinator, world, rank, timeout_s=60,
        device=f"cuda:{rank}" if device == "cuda" else device)
    try:
        out = fn(group, *args)
    finally:
        group.close()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ------------------------------------------------------------ the losses

def fresh(tree):
    """A copy of a params tree (the optimizer updates leaves in place)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: fresh(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [fresh(v) for v in tree]
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, table=fresh(tree.table),
                                   mlp=fresh(tree.mlp))
    return tree


def make_case(scene, kind: str, cfg: dict):
    """(loss_fn, params) of one stage loss on the port scene (tracer, em,
    ngp, crf)."""
    tracer, em, ngp, crf = scene
    lc = tsteps.LossConfig(**cfg)
    if kind == "initialize":
        return (tsteps.make_initialize_loss(tracer, em, crf, lc),
                {"material": fresh(ngp), "radiance": fresh(em.radiance)})
    if kind == "train_emitter":
        return (tsteps.make_train_emitter_loss(tracer, em, ngp, crf, lc),
                {"radiance": tsteps.radiance_to_param(
                    fresh(em.radiance), lc.radiance_log_space)})
    return (tsteps.make_brdf_crf_loss(tracer, crf, lc, -0.1, 2.1),
            {"material": fresh(ngp), "crf_weight": fresh(crf.weight)})


def one_case(scene, batch: dict, kind: str, cfg: dict, group,
             samples=None, n_steps: int = 3) -> dict:
    """One stage loss on this process's part of the global `batch`: the
    loss, aux and gradients of step 0 from step_generator(SEED, 0) (or
    `samples`, replayed at the global shape), then n_steps Adam steps of
    run_training with a recording hook, state hook and log; everything as
    numpy."""
    loss_fn, params = make_case(scene, kind, cfg)
    gen = step_generator(SEED, 0, "cpu", group)
    loss, aux, grads = value_and_grad(
        loss_fn, params, batch_to_device(batch, "cpu"), gen, samples, group)
    out = {"loss": float(loss), "aux": {k: float(v) for k, v in aux.items()},
           "grads": convert.leaves_to_numpy(grads)}
    seen = {"hooks": [], "state_hooks": [], "log": []}
    params, _ = run_training(
        loss_fn, params, iter([batch] * n_steps),
        make_optimizer(learning_rate=1e-2), n_steps, SEED,
        log_every=1, log_fn=seen["log"].append,
        hooks=[lambda s, p, lo, a: seen["hooks"].append((s, float(lo)))],
        state_hooks=[lambda s, p, o: seen["state_hooks"].append(s)],
        return_state=True, group=group)
    out["params"] = convert.leaves_to_numpy(params)
    out["seen"] = seen
    return out


def resume_case(scene, batch, kind, cfg, group) -> dict:
    """3 steps of run_training, and 2 steps then a resume from the state in
    hand to 3, where rank 1 holds another state at the resume (its
    parameters and Adam moments moved by 1, as a rank that loaded another
    file would): the parameters of both runs, as numpy."""
    loss_fn, full = make_case(scene, kind, cfg)
    opt = make_optimizer(learning_rate=1e-2)
    full = run_training(loss_fn, full, iter([batch] * 3), opt, 3, SEED,
                        log_fn=None, group=group)
    loss_fn, params = make_case(scene, kind, cfg)
    params, state = run_training(loss_fn, params, iter([batch] * 2), opt, 2,
                                 SEED, log_fn=None, return_state=True,
                                 group=group)
    if group.rank == 1:
        with torch.no_grad():
            for _, t in named_leaves(params):
                t.add_(1.0)
            for st in state["opt"].state.values():
                st["exp_avg"].add_(1.0)
    params = run_training(loss_fn, params, iter([batch]), opt, 3, SEED,
                          opt_state=state, start_step=2, log_fn=None,
                          group=group)
    return {"full": convert.leaves_to_numpy(full),
            "resumed": convert.leaves_to_numpy(params)}


def loss_cases(group, scene, batch, cases):
    """one_case for each (kind, cfg, samples) of `cases`, then resume_case
    of the first."""
    out = [one_case(scene, batch, kind, cfg, group, samples)
           for kind, cfg, samples in cases]
    return out + [resume_case(scene, batch, *cases[0][:2], group)]


def comms_at_sizes(group, sides):
    """parallel.comms_report.demo_step at a batch of side^2 rays for each
    side of `sides`, on a 4 x 4 grid at 2^10."""
    from iris_tpu_torch.parallel.comms_report import demo_step

    return [demo_step(group, batch=n * n, hash_levels=4, hash_features=4,
                      log2_table=10) for n in sides]


def demo_initialize(group, n_side, device="cuda:0"):
    """The initialize loss's value and gradients of this rank's rows of the
    demo batch (production-shaped 4 x 16 grid at 2^12) on the group's
    device, from step_generator(SEED, 0); group None is one process on
    `device`."""
    import dataclasses as dc

    from iris_tpu_torch.demo import make_demo_batch, make_demo_scene

    dev = group.device if group is not None else torch.device(device)
    tracer, em, ngp, crf, _ = make_demo_scene(
        n_clutter=4, slf_res=16, hash_levels=4, log2_table=12,
        hash_features=16, per_level_scale=-1.0, device=dev)
    ngp = dc.replace(ngp, cfg=dc.replace(
        ngp.cfg, stochastic_fwd=True, stochastic_bwd=True,
        bwd_level_sample=1, bwd_scatter_dtype="float32"))
    loss_fn = tsteps.make_initialize_loss(
        tracer, em, crf, tsteps.LossConfig(spp=4, max_segments=8))
    params = {"material": ngp, "radiance": em.radiance.clone()}
    batch = make_demo_batch(n_side=n_side, device=dev)
    loss, aux, grads = value_and_grad(
        loss_fn, params, batch, step_generator(SEED, 0, dev, group), None,
        group)
    return {"loss": float(loss), "grads": convert.leaves_to_numpy(grads)}
