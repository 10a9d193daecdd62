"""Per-step collective traffic of a data-parallel train step (counterpart
of iris_tpu/parallel/comms_report.py).

The JAX package compiles its GSPMD step over virtual devices and sums the
bytes of the collectives in the optimized HLO. The port has no HLO: it
counts what a step really sends. While counting(group) is active, every
collective of the RankGroup is recorded as (kind, bytes): the gradient
all-reduce (one call per gradient leaf, the trainable-parameter bytes) and
the one all-gather of the per-ray tensors the losses' local parts compute
(B x C float32 over the ranks, train/steps.py). report() sums them and
sets them beside the parameter bytes, and guards the data-parallel design as the JAX package's
test_comms_report does: a step sends the parameter bytes plus O(B)
gathered floats, and nothing larger.

The time of a ring all-reduce, 2 (N-1)/N bytes / link_bw, takes the link
rate as a required argument: no interconnect figure is assumed.

CLI: python -m iris_tpu_torch.parallel.comms_report --link_bw 2.5e10
     [--ranks 2] [--batch 8192] [--hash_levels 4 --hash_features 16
     --log2_table 19] [--compute_ms 65] [--device cuda]
     [--dist_backend nccl|gloo]
counts one initialize step of the demo scene, by default at the
trainers' widths (a 4 x 16 grid at 2^19, run_pipeline.sh's batch of
8,192 rays), on the card: NCCL ranks on cuda:0..N-1, or with
--dist_backend gloo N ranks sharing the --device card; --device cpu runs
gloo ranks on the CPU. The printed JSON names the grid, the batch, the
device and the backend it counted.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch

from iris_tpu_torch.train.optim import named_leaves


@contextlib.contextmanager
def counting(group):
    """While active, group.calls is a list of every collective's (kind,
    bytes); yields that list."""
    calls = group.calls = []
    try:
        yield calls
    finally:
        group.calls = None


def trainable_bytes(params) -> int:
    """The bytes of a params tree's trainable leaves (named_leaves)."""
    return sum(t.numel() * t.element_size() for _, t in named_leaves(params))


def summarize(calls) -> dict:
    """{kind: total bytes} and the call count of a list of (kind,
    bytes)."""
    by_kind: dict[str, int] = {}
    for kind, nbytes in calls:
        by_kind[kind] = by_kind.get(kind, 0) + int(nbytes)
    return {"collective_ops": len(calls), "bytes_by_kind": by_kind}


def ring_allreduce_seconds(nbytes: int, n: int, link_bw: float) -> float:
    """A ring all-reduce of nbytes over n ranks on links of link_bw
    bytes/s."""
    return 2 * (n - 1) / n * nbytes / link_bw


def report(calls, param_bytes: int, world_size: int, link_bw: float,
           n_steps: int = 1, compute_ms: float | None = None,
           labels: dict | None = None) -> dict:
    """The per-step traffic of `calls` (counted over n_steps train steps of
    `world_size` ranks), beside the trainable-parameter bytes, with the
    ring all-reduce time at link_bw bytes/s; `labels` (what was counted)
    lead the record. Printed as one JSON line and returned."""
    s = summarize(calls)
    per = {k: v / n_steps for k, v in s["bytes_by_kind"].items()}
    allreduce = per.get("all_reduce", 0)
    gather = per.get("all_gather", 0)
    t_ring = ring_allreduce_seconds(allreduce, world_size, link_bw)
    out = dict(labels or {})
    out.update({
        "world_size": world_size,
        "steps": n_steps,
        "param_bytes": param_bytes,
        "collective_ops_per_step": s["collective_ops"] / n_steps,
        "allreduce_bytes_per_step": allreduce,
        "gather_bytes_per_step": gather,
        "allreduce_to_param": allreduce / param_bytes,
        "gather_to_param": gather / param_bytes,
        "collective_bytes_per_step": sum(per.values()),
        "link_bw": link_bw,
        "ring_allreduce_ms": t_ring * 1e3,
    })
    if compute_ms is not None:
        out["efficiency_bound"] = compute_ms / (compute_ms + t_ring * 1e3)
    print(json.dumps(out))
    return out


def demo_step(group, batch: int = 8192, hash_levels: int = 4,
              hash_features: int = 16, log2_table: int = 19, spp: int = 2):
    """One initialize train step on the demo scene, the first `batch`
    pixels of its image split over the group's ranks, counted: (calls,
    trainable bytes, floats a ray the loss gathers)."""
    import math

    from iris_tpu_torch.demo import make_demo_batch, make_demo_scene
    from iris_tpu_torch.parallel.sharding import shard_rows
    from iris_tpu_torch.train.loop import make_train_step, step_generator
    from iris_tpu_torch.train.optim import make_optimizer
    from iris_tpu_torch.train.steps import LossConfig, make_initialize_loss

    dev = group.device
    tracer, em, ngp, crf, _ = make_demo_scene(
        n_clutter=2, slf_res=8, hash_levels=hash_levels,
        log2_table=log2_table, hash_features=hash_features,
        per_level_scale=-1.0, device=dev)
    loss_fn = make_initialize_loss(tracer, em, crf,
                                   LossConfig(spp=spp, max_segments=8))
    params = {"material": ngp, "radiance": em.radiance.clone()}
    pixels = make_demo_batch(n_side=math.isqrt(batch - 1) + 1, device=dev)
    rows = {k: v[:batch] for k, v in pixels.items()}
    gen = step_generator(0, 0, dev, group)
    width = sum(t[:1].numel() for t in loss_fn.local(
        params, shard_rows(rows, group), gen).values())
    opt = make_optimizer()
    step = make_train_step(loss_fn, opt, group)
    state = opt.init(params)
    with counting(group) as calls:
        step(params, state, rows, step_generator(0, 0, dev, group))
    return list(calls), trainable_bytes(params), width


def _count(group, kw):
    """demo_step on this rank: (calls, trainable bytes, what was
    counted)."""
    calls, param_bytes, width = demo_step(group, **kw)
    labels = {"device": str(group.device), "backend": group.backend,
              "rays_per_step": kw["batch"],
              "gathered_floats_per_ray": width,
              "grid": {k: kw[k] for k in ("hash_levels", "hash_features",
                                          "log2_table")}}
    return calls, param_bytes, labels


def rank_devices(device, backend: str | None, n: int):
    """(devices by rank, backend) of an n-rank count: NCCL on the card
    (the default there), one card a rank, raising if fewer than n are
    visible; gloo, every rank on `device` (ranks sharing one card, or the
    CPU, where gloo is the default)."""
    from iris_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend != "nccl":
        return [str(dev)] * n, backend
    if dev.type != "cuda":
        raise ValueError(f"NCCL runs on the card, not on {dev}")
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(f"{n} NCCL ranks need a card each: only {have} "
                           "are visible (--dist_backend gloo shares one)")
    return [f"cuda:{r}" for r in range(n)], backend


def main(argv=None):
    from iris_tpu_torch.parallel.distributed import spawn_ranks
    from iris_tpu_torch.pipeline.common import mesh_batch_size

    p = argparse.ArgumentParser()
    p.add_argument("--link_bw", type=float, required=True,
                   help="link rate of the ring, bytes/s")
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--batch", type=int, default=8192,
                   help="rays a step over all ranks")
    p.add_argument("--hash_levels", type=int, default=4)
    p.add_argument("--hash_features", type=int, default=16)
    p.add_argument("--log2_table", type=int, default=19)
    p.add_argument("--compute_ms", type=float, default=None)
    p.add_argument("--device", default=None,
                   help="default the card; cpu for gloo ranks on the CPU")
    p.add_argument("--dist_backend", default=None,
                   help="default nccl on the card, gloo on the CPU")
    a = p.parse_args(argv)
    devices, backend = rank_devices(a.device, a.dist_backend, a.ranks)
    kw = dict(batch=mesh_batch_size(a.batch, a.ranks, "batch"),
              hash_levels=a.hash_levels, hash_features=a.hash_features,
              log2_table=a.log2_table)
    calls, param_bytes, labels = spawn_ranks(_count, devices, backend,
                                             args=(kw,))[0]
    report(calls, param_bytes, a.ranks, a.link_bw, compute_ms=a.compute_ms,
           labels=labels)


if __name__ == "__main__":
    main()
