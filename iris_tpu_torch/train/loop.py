"""The training step and loop on one device (counterpart of
iris_tpu/train/loop.py: make_train_step :31-44, TrainerConfig :25-29,
run_training :93-199). Sharding over a mesh (mesh, n_devices) waits for
the port of parallel/.

A stage provides loss_fn(params, batch, gen, samples=None) -> (loss, aux).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterable

import numpy as np
import torch

from iris_tpu_torch.train.optim import Optimizer, named_leaves


def value_and_grad(loss_fn: Callable, params: dict, batch: dict, gen,
                   samples: dict | None = None):
    """(loss, aux, grads): grads maps each leaf name (see named_leaves) to
    its gradient; a leaf the loss does not reach is absent. The leaves are
    switched to requires_grad for the call and back after it."""
    leaves = named_leaves(params)
    was = [t.requires_grad for _, t in leaves]
    for _, t in leaves:
        t.requires_grad_(True)
    try:
        loss, aux = loss_fn(params, batch, gen, samples)
        got = torch.autograd.grad(loss, [t for _, t in leaves],
                                  allow_unused=True)
    finally:
        for (_, t), w in zip(leaves, was):
            t.requires_grad_(w)
    grads = {name: g for (name, _), g in zip(leaves, got) if g is not None}
    aux = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
           for k, v in aux.items()}
    return loss.detach(), aux, grads


def make_train_step(loss_fn: Callable, optimizer: Optimizer):
    """step(params, opt_state, batch, gen, samples=None) ->
    (params, opt_state, loss, aux). The parameters are updated in place
    and returned; opt_state comes from optimizer.init(params)."""

    def step(params, opt_state, batch, gen, samples=None):
        loss, aux, grads = value_and_grad(loss_fn, params, batch, gen,
                                          samples)
        with torch.no_grad():
            optimizer.update(params, grads, opt_state)
        return params, opt_state, loss, aux

    return step


@dataclass
class TrainerConfig:
    log_every: int = 50


_STEP_SEED_MIX = 0x9E3779B97F4A7C15


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one ABSOLUTE step: a fresh stream from (seed,
    step), the counterpart of jax.random.fold_in(key, step)
    (loop.py:180). A resumed run therefore draws what the uninterrupted
    run drew, chunked or not."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * _STEP_SEED_MIX + int(step)) % (1 << 63))
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


def run_training(loss_fn: Callable, params: dict, batches: Iterable,
                 optimizer: Optimizer, n_steps: int, seed: int,
                 log_every: int = 50, log_fn: Callable | None = print,
                 hooks: list | None = None, opt_state: dict | None = None,
                 start_step: int = 0, state_hooks: list | None = None,
                 return_state: bool = False, chunk_steps: int = 1,
                 samples_for_step: Callable | None = None):
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
    once and that many optimizer steps run before anyone looks; hooks are
    then called per step with that step's loss and the END-OF-CHUNK
    parameters, and state_hooks once per chunk at its LAST step index, so
    a resume never replays updates already applied. The steps of a chunk
    run eagerly, one after the other, with the same generators and update
    math as chunk_steps=1; capturing a chunk in a CUDA graph, which is
    what one lax.scan dispatch buys on the TPU, is not done here.

    samples_for_step(step) -> dict | None replaces a step's draws (the
    hook the parity tests replay the JAX package's keys through).

    Returns params, or (params, opt_state) with return_state=True."""
    if opt_state is None:
        opt_state = optimizer.init(params)
    step_fn = make_train_step(loss_fn, optimizer)
    device = _params_device(params)

    t0 = time.time()
    it = iter(batches)
    step = start_step
    while step < n_steps:
        k_chunk = min(max(int(chunk_steps), 1), n_steps - step)
        chunk = [next(it) for _ in range(k_chunk)]
        results = []
        for j, batch in enumerate(chunk):
            s = step + j
            samples = samples_for_step(s) if samples_for_step else None
            params, opt_state, loss, aux = step_fn(
                params, opt_state, batch_to_device(batch, device),
                step_generator(seed, s, device), samples)
            results.append((s, loss, aux))
        for s, loss, aux in results:
            if hooks:
                for h in hooks:
                    h(s, params, loss, aux)
            if log_fn and (s % log_every == 0 or s == n_steps - 1):
                log_fn(f"step {s:6d}  loss {float(loss):.6f}  " + "  ".join(
                    f"{k}={float(v):.5f}" for k, v in (aux or {}).items())
                    + f"  [{time.time() - t0:.1f}s]")
        if state_hooks:
            for h in state_hooks:
                h(step + k_chunk - 1, params, opt_state)
        step += k_chunk
    if return_state:
        return params, opt_state
    return params
