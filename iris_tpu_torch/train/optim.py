"""Optimizer factory: Adam/AdamW/SGD with a piecewise-constant learning
rate (counterpart of iris_tpu/train/optim.py; reference
configure_optimizers, train_brdf_crf.py:106-114).

torch.optim.Adam with MultiStepLR computes the updates of optax.adam over
optax.piecewise_constant_schedule: eps outside the square root
(eps_root = 0), bias correction of both moments, and the rate scaled from
the step whose 0-based index reaches a milestone. The same holds for AdamW
(decoupled decay, p -= lr * wd * p) and SGD.

The trainable leaves of a params dict are plain tensors, the tensors of a
{"w": [...], "b": [...]} MLP dict, and the table and MLP of an NGPBRDF
(its voxel bounds receive a zero gradient in the JAX package and never
move). The optimizer updates them in place.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from iris_tpu_torch.models.brdf import NGPBRDF


def named_leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """The trainable tensors of a params tree with the JAX pytree's leaf
    names: "material.table", "material.mlp.w.0", "radiance", ..."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    dot = prefix + "." if prefix else ""
    if isinstance(tree, NGPBRDF):
        return ([(dot + "table", tree.table)]
                + named_leaves(tree.mlp, dot + "mlp"))
    if isinstance(tree, dict):
        out = []
        for k in tree:
            out += named_leaves(tree[k], dot + str(k))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += named_leaves(v, dot + str(i))
        return out
    raise TypeError(f"no trainable leaves known for {type(tree).__name__}")


@dataclass
class Optimizer:
    """init(params) builds the torch optimizer and scheduler over the
    params' leaves (the opt_state); update steps both."""

    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    milestones: tuple[int, ...] = (1000,)
    scheduler_rate: float = 0.5
    optimizer: str = "Adam"
    # top-level params key -> multiplier of its updates
    update_scales: dict = field(default_factory=dict)

    def init(self, params: dict) -> dict:
        groups = []
        for key in params:
            leaves = [t for _, t in named_leaves(params[key])]
            groups.append({
                "params": leaves,
                "lr": self.learning_rate * self.update_scales.get(key, 1.0)})
        if self.optimizer == "SGD":
            opt = torch.optim.SGD(groups, lr=self.learning_rate)
        elif self.weight_decay:
            opt = torch.optim.AdamW(groups, lr=self.learning_rate,
                                    weight_decay=self.weight_decay)
        else:
            opt = torch.optim.Adam(groups, lr=self.learning_rate)
        sched = torch.optim.lr_scheduler.MultiStepLR(
            opt, milestones=sorted(int(m) for m in self.milestones),
            gamma=self.scheduler_rate)
        return {"opt": opt, "sched": sched}

    def update(self, params: dict, grads: dict, opt_state: dict) -> None:
        """One optimizer step, in place: grads maps leaf names to
        gradients (a leaf without one is left alone)."""
        for name, leaf in named_leaves(params):
            leaf.grad = grads.get(name)
            if leaf.grad is None and self.weight_decay:
                # optax decays a leaf whose gradient is zero as well
                leaf.grad = torch.zeros_like(leaf)
        opt_state["opt"].step()
        opt_state["sched"].step()
        for _, leaf in named_leaves(params):
            leaf.grad = None


def make_optimizer(learning_rate: float = 1e-3, weight_decay: float = 0.0,
                   milestones: tuple[int, ...] = (1000,),
                   scheduler_rate: float = 0.5,
                   optimizer: str = "Adam") -> Optimizer:
    return Optimizer(learning_rate, weight_decay, tuple(milestones),
                     scheduler_rate, optimizer)


def scale_updates_for_key(optimizer: Optimizer, key: str, scale: float
                          ) -> Optimizer:
    """Multiply the updates of params[key] by `scale` (scale 1 returns the
    optimizer itself). Adam, AdamW and SGD updates are linear in the
    learning rate, so the leaf's parameter group gets lr * scale."""
    if scale == 1.0:
        return optimizer
    scales = dict(optimizer.update_scales)
    scales[key] = scales.get(key, 1.0) * scale
    return Optimizer(optimizer.learning_rate, optimizer.weight_decay,
                     optimizer.milestones, optimizer.scheduler_rate,
                     optimizer.optimizer, scales)
