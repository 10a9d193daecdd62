"""The training step and loop (counterpart of iris_tpu/train/loop.py:
make_train_step :31-44, TrainerConfig :25-29, make_train_chunk :55-90,
run_training :93-199), on one device or data-parallel over the ranks of a
RankGroup (parallel/distributed.py), where the JAX package shards one
logical batch over a ('data',) mesh.

On the card a chunk of steps is one CUDA graph replay (make_train_chunk,
utils/graphs.py), where the JAX package runs it as one lax.scan.

A stage provides loss_fn(params, batch, gen, samples=None) -> (loss, aux);
a data-parallel run needs it split (train.steps.SplitLoss). An N-rank step
is then the one-process step on the same global batch, up to the order of
the gradient sums: every rank renders its rows of the batch, the per-ray
results of every rank are gathered, every rank computes the same global
loss from them and the whole batch, and the gradients are averaged over
the ranks.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterable

import numpy as np
import torch

from iris_tpu_torch.parallel.distributed import (
    gather_rows, global_replicate, is_lead,
)
from iris_tpu_torch.parallel.sharding import RankGenerator, shard_rows
from iris_tpu_torch.train.optim import Optimizer, named_leaves
from iris_tpu_torch.utils.graphs import GraphContext, StaticBatches
from iris_tpu_torch.utils.profiling import count, span


def value_and_grad(loss_fn: Callable, params: dict, batch: dict, gen,
                   samples: dict | None = None, group=None):
    """(loss, aux, grads): grads maps each leaf name (see named_leaves) to
    its gradient; a leaf the loss does not reach is absent. The leaves are
    switched to requires_grad for the call and back after it.

    With a RankGroup, `batch` is the whole global batch, the same on every
    rank, and loss_fn a SplitLoss: its local part runs on the rank's rows
    (parallel.sharding.shard_rows) and its results are gathered from every
    rank, its reduce gives the global loss (the same on every rank), and
    the gradients are averaged over the ranks (all-reduced, then divided
    by N)."""
    leaves = named_leaves(params)
    was = [t.requires_grad for _, t in leaves]
    for _, t in leaves:
        t.requires_grad_(True)
    try:
        if group is None:
            loss, aux = loss_fn(params, batch, gen, samples)
        else:
            rows = gather_rows(loss_fn.local(
                params, shard_rows(batch, group), gen, samples), group)
            loss, aux = loss_fn.reduce(params, rows, batch, gen, samples)
        got = torch.autograd.grad(loss, [t for _, t in leaves],
                                  allow_unused=True)
    finally:
        for (_, t), w in zip(leaves, was):
            t.requires_grad_(w)
    grads = {name: g for (name, _), g in zip(leaves, got) if g is not None}
    if group is not None:
        for name, g in grads.items():
            g = g.contiguous()
            group.all_reduce_(g)
            grads[name] = g.div_(group.world_size)
    aux = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
           for k, v in aux.items()}
    return loss.detach(), aux, grads


def make_train_step(loss_fn: Callable, optimizer: Optimizer, group=None):
    """step(params, opt_state, batch, gen, samples=None) ->
    (params, opt_state, loss, aux). The parameters are updated in place
    and returned; opt_state comes from optimizer.init(params). With a
    RankGroup the step is data-parallel (value_and_grad). A step is the
    span train.step and counts one train.steps."""

    def step(params, opt_state, batch, gen, samples=None):
        with span("train.step"):
            count("train.steps", 1)
            loss, aux, grads = value_and_grad(loss_fn, params, batch, gen,
                                              samples, group)
            with torch.no_grad():
                optimizer.update(params, grads, opt_state)
        return params, opt_state, loss, aux

    return step


@dataclass
class TrainerConfig:
    log_every: int = 50


_STEP_SEED_MIX = 0x9E3779B97F4A7C15


def step_generator(seed: int, step: int, device,
                   group=None) -> torch.Generator:
    """The generator of one ABSOLUTE step: a fresh stream from (seed,
    step), the counterpart of jax.random.fold_in(key, step)
    (loop.py:180). A resumed run therefore draws what the uninterrupted
    run drew, chunked or not. With a RankGroup it is the rank's
    RankGenerator, seeded alike on every rank."""
    gen = (torch.Generator(device=device) if group is None else
           RankGenerator(device, group.rank, group.world_size))
    gen.manual_seed(_step_seed(seed, step))
    return gen


def _params_device(params) -> torch.device:
    return named_leaves(params)[0][1].device


def batch_to_device(batch: dict, device) -> dict:
    """A batch dict with every numpy array or tensor on `device` (numpy
    arrays, as RayBatcher yields them from the host bank, are copied over
    once; None stays None): the role of shard_batch at
    iris_tpu/train/loop.py:179 on one device."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = v.to(device) if isinstance(v, torch.Tensor) else v
    return out


def _step_seed(seed: int, step: int) -> int:
    return (int(seed) * _STEP_SEED_MIX + int(step)) % (1 << 63)


def _stack_aux(auxes: list, device) -> dict:
    """{name: (K,)} of K steps' aux dicts."""
    return {k: torch.stack([torch.as_tensor(a[k], device=device)
                            for a in auxes]) for k in auxes[0]}


def make_train_chunk(loss_fn: Callable, optimizer: Optimizer, k_steps: int,
                     group=None, graphs: GraphContext | None = None):
    """chunk(params, opt_state, batches, seed, step0, samples_for_step=None)
    -> (params, opt_state, losses (K,), auxes {name: (K,)}): k_steps
    optimizer steps, the counterpart of make_train_chunk at loop.py:55-90.
    `batches` are the chunk's K batch dicts; step j draws from
    step_generator(seed, step0 + j), so a chunk consumes what K single
    steps consume. The parameters and optimizer state are updated in
    place and returned.

    On a CUDA device with no group the chunk is a CUDA graph (utils/
    graphs.py), replayed: one host-to-device copy of the stacked batches
    (StaticBatches), the K slot generators reseeded from (seed, step0 +
    j), one replay. `graphs` is the GraphContext the chunks of a run share
    (run_training passes one; None: the chunk's own). The context's first
    chunk runs eagerly on its stream, the warm-up that builds the kernels,
    Adam's state and cuBLAS's workspace, and wastes no step; a chunk size
    is captured at its first call after that, and that call and every
    later one is a replay. The returned losses and auxes are copies, and
    the replay's bits are the eager steps' bits. A graph is bound to the
    parameter and optimizer-state tensors it captured: other ones raise.

    On the CPU the steps run eagerly, one after the other, the CPU being
    the device the caller asked for. With a RankGroup they run eagerly
    too: the collectives of a gloo group run on the host and cannot be
    captured. samples_for_step(step) -> dict | None (the parity tests'
    hook) replaces the draws of eager steps; with a graph it raises."""
    step_fn = make_train_step(loss_fn, optimizer, group)
    k_steps = int(k_steps)
    state = {"ctx": graphs, "graph": None}

    def eager(params, opt_state, batches, seed, step0, samples_for_step):
        device = _params_device(params)
        losses, auxes = [], []
        for j, batch in enumerate(batches):
            s = step0 + j
            samples = samples_for_step(s) if samples_for_step else None
            params, opt_state, loss, aux = step_fn(
                params, opt_state, batch_to_device(batch, device),
                step_generator(seed, s, device, group), samples)
            losses.append(loss)
            auxes.append(aux or {})
        return (params, opt_state, torch.stack(losses),
                _stack_aux(auxes, device))

    def capture(params, opt_state, batches, device, ctx):
        inputs = StaticBatches(batches, device)
        gens = [torch.Generator(device=device) for _ in range(k_steps)]

        def body():
            losses, auxes = [], []
            for j in range(k_steps):
                _, _, loss, aux = step_fn(params, opt_state,
                                          inputs.views[j], gens[j])
                losses.append(loss)
                auxes.append(aux or {})
            return torch.stack(losses), _stack_aux(auxes, device)

        inputs.fill(batches)
        graph = ctx.capture(body, gens, "train_chunk")
        return {"graph": graph, "inputs": inputs,
                "bound": [t for _, t in named_leaves(params)],
                "opt": opt_state["opt"]}

    def chunk(params, opt_state, batches, seed, step0,
              samples_for_step=None):
        batches = list(batches)
        if len(batches) != k_steps:
            raise ValueError(f"{len(batches)} batches for a chunk of "
                             f"{k_steps} steps")
        device = _params_device(params)
        if device.type != "cuda" or group is not None:
            return eager(params, opt_state, batches, seed, step0,
                         samples_for_step)
        if samples_for_step is not None:
            raise ValueError(
                "samples_for_step replaces the draws of eager steps (the "
                "CPU parity hook); a chunk on the card is a CUDA graph that "
                "draws from its own generators")
        ctx = state["ctx"] = state["ctx"] or GraphContext(device)
        if not ctx.warm:
            with ctx.on_stream():
                out = eager(params, opt_state, batches, seed, step0, None)
            ctx.warm = True
            return out
        g = state["graph"]
        if g is None:
            g = state["graph"] = capture(params, opt_state, batches, device,
                                         ctx)
        else:
            g["inputs"].fill(batches)
        leaves = [t for _, t in named_leaves(params)]
        if (opt_state["opt"] is not g["opt"] or len(leaves) != len(
                g["bound"]) or any(a is not b
                                   for a, b in zip(leaves, g["bound"]))):
            raise ValueError("a captured chunk updates the parameter and "
                             "optimizer-state tensors it was captured with; "
                             "make a new chunk for other ones")
        losses, auxes = g["graph"].replay(
            [_step_seed(seed, step0 + j) for j in range(k_steps)])
        return (params, opt_state, losses.clone(),
                {k: v.clone() for k, v in auxes.items()})

    return chunk


def make_run_graphs(device, group=None) -> GraphContext | None:
    """The GraphContext a trainer shares between run_training's chunks and
    its validation renders (one pool: every output is copied out before
    the next replay), or None where run_training captures nothing: off
    the card, or with a RankGroup."""
    device = torch.device(device)
    if device.type != "cuda" or group is not None:
        return None
    return GraphContext(device)


def _to_host(losses: torch.Tensor, auxes: dict):
    """The chunk's losses and auxes on the host in ONE copy (float64 holds
    every float32, bfloat16 and 32-bit integer exactly), each back in its
    own dtype: the span train.sync, the host's wait for the chunk."""
    cols = [losses] + list(auxes.values())
    with span("train.sync"):
        flat = torch.cat([c.reshape(-1).to(torch.float64)
                          for c in cols]).cpu()
    out = [c.to(col.dtype).reshape(col.shape) for c, col in
           zip(flat.split([col.numel() for col in cols]), cols)]
    return out[0], dict(zip(auxes, out[1:]))


def run_training(loss_fn: Callable, params: dict, batches: Iterable,
                 optimizer: Optimizer, n_steps: int, seed: int,
                 log_every: int = 50, log_fn: Callable | None = print,
                 hooks: list | None = None, opt_state: dict | None = None,
                 start_step: int = 0, state_hooks: list | None = None,
                 return_state: bool = False, chunk_steps: int = 1,
                 samples_for_step: Callable | None = None, group=None,
                 graphs: GraphContext | None = None):
    """Drive training for steps [start_step, n_steps) over `batches`, an
    iterator of batch dicts already positioned at start_step (numpy arrays
    or tensors: each step's batch goes to the parameters' device once,
    batch_to_device). The parameters are updated in place, on the device
    they lie on.

    Full-state resume: pass the restored `opt_state` and `start_step`
    (train.checkpoint.load_train_state); every step draws from
    step_generator(seed, step), so the resumed stream is that of an
    uninterrupted run. hooks are called as h(step, params, loss, aux),
    state_hooks as h(step, params, opt_state), every step (each hook picks
    its own cadence).

    chunk_steps > 1 keeps the JAX package's observable meaning
    (loop.py:120-125): that many batches are taken from the iterator at
    once and run as one chunk (make_train_chunk) before anyone looks;
    hooks are then called per step with that step's loss and aux (host
    tensors) and the END-OF-CHUNK parameters, and state_hooks once per
    chunk at its LAST step index, so a resume never replays updates
    already applied. On the card a chunk after the first is one CUDA
    graph replay, as it is one lax.scan dispatch on the TPU: one copy of
    the stacked batches in, one host synchronisation out (its losses).
    Every chunk size of the run (the last chunk may be shorter) shares one
    GraphContext: `graphs`, where the caller gives one (a trainer CLI
    shares it with its validation hook's graphs, make_run_graphs), else
    the run's own. The generators and update math are chunk_steps=1's, and
    so are the bits. A chunk of one step is a plain step.

    samples_for_step(step) -> dict | None replaces a step's draws (the
    hook the parity tests replay the JAX package's keys through); with
    chunks on the card it raises (make_train_chunk).

    group: a RankGroup for a data-parallel run. Every rank passes the same
    `batches` (the same global batch each step, as the JAX trainers feed
    every host the same RayBatcher stream) and the same starting state;
    rank 0's parameters and optimizer state are broadcast first (a resume
    loads on every rank, then rank 0's wins). Each step a rank moves the
    batch to its device, renders its rows (value_and_grad) and draws from
    its RankGenerator; replayed samples come at the global batch's
    shape. hooks, state_hooks and log_fn run on rank 0 alone, so
    that no two ranks write one file; the loss and aux they see are the
    global loss's, the same on every rank. A group's chunks run their
    steps one by one (make_train_chunk), which the log says once.

    Returns params, or (params, opt_state) with return_state=True."""
    if opt_state is None:
        opt_state = optimizer.init(params)
    if group is not None:
        global_replicate(params, opt_state, group)
    if not is_lead(group):
        hooks = state_hooks = log_fn = None
    step_fn = make_train_step(loss_fn, optimizer, group)
    device = _params_device(params)
    chunk_fns: dict = {}
    if group is not None and int(chunk_steps) > 1 and log_fn:
        log_fn(f"[run_training] data-parallel over {group.world_size} "
               f"ranks: each chunk of {int(chunk_steps)} runs its steps one "
               "by one (a group's collectives are not captured in a CUDA "
               "graph)")

    t0 = time.time()
    it = iter(batches)
    step = start_step
    while step < n_steps:
        with span("train.chunk"):
            k_chunk = min(max(int(chunk_steps), 1), n_steps - step)
            chunk = [next(it) for _ in range(k_chunk)]
            if k_chunk > 1:
                if device.type == "cuda" and group is None and graphs is None:
                    graphs = GraphContext(device)
                if k_chunk not in chunk_fns:
                    chunk_fns[k_chunk] = make_train_chunk(
                        loss_fn, optimizer, k_chunk, group, graphs)
                params, opt_state, losses, auxes = chunk_fns[k_chunk](
                    params, opt_state, chunk, seed, step, samples_for_step)
                losses, auxes = _to_host(losses, auxes)
                results = [(step + j, losses[j], {k: v[j] for k, v in
                                                  auxes.items()})
                           for j in range(k_chunk)]
            else:
                samples = samples_for_step(step) if samples_for_step else None
                params, opt_state, loss, aux = step_fn(
                    params, opt_state, batch_to_device(chunk[0], device),
                    step_generator(seed, step, device, group), samples)
                results = [(step, loss, aux)]
            for s, loss, aux in results:
                if hooks:
                    for h in hooks:
                        h(s, params, loss, aux)
                if log_fn and (s % log_every == 0 or s == n_steps - 1):
                    log_fn(f"step {s:6d}  loss {float(loss):.6f}  "
                           + "  ".join(f"{k}={float(v):.5f}" for k, v
                                       in (aux or {}).items())
                           + f"  [{time.time() - t0:.1f}s]")
            if state_hooks:
                for h in state_hooks:
                    h(step + k_chunk - 1, params, opt_state)
        step += k_chunk
    if return_state:
        return params, opt_state
    return params
