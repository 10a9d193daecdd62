"""One training step on one device (counterpart of make_train_step,
iris_tpu/train/loop.py:31-44). run_training, chunked steps and sharding
are not ported yet.

A stage provides loss_fn(params, batch, gen, samples=None) -> (loss, aux).
"""

from __future__ import annotations

from typing import Callable

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
