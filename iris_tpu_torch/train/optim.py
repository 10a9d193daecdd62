"""Optimizer factory: Adam/AdamW/SGD with a piecewise-constant learning
rate (counterpart of iris_tpu/train/optim.py; reference
configure_optimizers, train_brdf_crf.py:106-114).

Adam over DeviceSchedule's rates computes the updates of optax.adam over
optax.piecewise_constant_schedule: eps outside the square
root (eps_root = 0), bias correction of both moments, and the rate scaled
from the step whose 0-based index reaches a milestone. The same holds for
AdamW (decoupled decay, p -= lr * wd * p) and SGD.

The step keeps no state on the host, so that on the card a chunk of steps
can be captured in a CUDA graph and replayed (train.loop.
make_train_chunk): each parameter group's learning rate is a tensor on
the parameters' device, which DeviceSchedule sets from a step count on
that device as optax evaluates piecewise_constant_schedule inside the JAX
package's scan: lr * rate^(#milestones <= step). The Adam, AdamW and SGD
updates over those rates are written in tensor ops (_DeviceAdam,
_DeviceSGD; torch.optim's read a tensor rate back to the host off the
card), their step counts tensors on the same device. Every device, and
eager and captured steps, run this same code, so the CPU parity tests
hold the update the card runs, and a graph gives the eager steps' bits.

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


class DeviceSchedule:
    """MultiStepLR's piecewise-constant rate, held on the parameters'
    device: a step count there (`last_epoch`, the steps taken) and one
    float32 tensor a parameter group as that group's learning rate, set to
    base_lr * rate^(#milestones <= count) by device ops alone. step(),
    get_last_lr() and state_dict()/load_state_dict() are MultiStepLR's
    (get_last_lr reads the rates back to the host); loading puts the
    schedule's rate tensors back into the optimizer's groups (a loaded
    optimizer state_dict brings host copies of them). Checkpoints of
    MultiStepLR load too: only their last_epoch is read."""

    def __init__(self, opt, base_lrs, milestones, rate: float):
        dev = opt.param_groups[0]["params"][0].device
        self.opt, self.base_lrs, self.rate = opt, list(base_lrs), rate
        self.last_epoch = torch.zeros((), dtype=torch.int64, device=dev)
        self.milestones = torch.as_tensor(
            sorted(int(m) for m in milestones), dtype=torch.int64,
            device=dev).reshape(-1)
        self._rate = torch.full((), float(rate), dtype=torch.float64,
                                device=dev)
        self.lrs = [g["lr"] for g in opt.param_groups]
        self._set()

    def _set(self):
        passed = (self.milestones <= self.last_epoch).sum()
        scale = torch.pow(self._rate, passed)
        for lr, base in zip(self.lrs, self.base_lrs):
            lr.copy_(scale * base)

    def step(self):
        self.last_epoch.add_(1)
        self._set()

    def get_last_lr(self) -> list[float]:
        """The rates as MultiStepLR reports them: each base rate times
        `rate` once for every milestone passed, in float64 (the groups
        hold them in float32). Reads the step count back to the host."""
        passed = int((self.milestones <= self.last_epoch).sum())
        out = []
        for lr in self.base_lrs:
            for _ in range(passed):
                lr *= self.rate
            out.append(lr)
        return out

    def state_dict(self) -> dict:
        return {"last_epoch": self.last_epoch}

    def load_state_dict(self, state: dict) -> None:
        self.last_epoch.copy_(torch.as_tensor(state["last_epoch"]))
        for g, lr in zip(self.opt.param_groups, self.lrs):
            g["lr"] = lr
        self._set()


class _DeviceAdam(torch.optim.Optimizer):
    """Adam, and AdamW with a weight decay, over a tensor learning rate a
    group, in tensor ops alone: the sequence of torch.optim.Adam's
    capturable multi-tensor step, which reads nothing back to the host,
    run on every device (torch.optim.Adam takes a tensor rate on the CPU
    only by reading it back, and on no device without a card's
    capturable path). The state of a leaf is torch.optim.Adam's:
    exp_avg, exp_avg_sq and a float32 step count on the leaf's device."""

    def __init__(self, groups, weight_decay: float = 0.0,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(groups, {"weight_decay": weight_decay,
                                  "betas": betas, "eps": eps})

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        for p, st in self.state.items():     # counts come back on the host
            st["step"] = st["step"].to(device=p.device, dtype=torch.float32)

    @torch.no_grad()
    def step(self):
        for g in self.param_groups:
            ps = [p for p in g["params"] if p.grad is not None]
            if not ps:
                continue
            for p in ps:
                if not self.state[p]:
                    self.state[p].update(
                        step=torch.zeros((), dtype=torch.float32,
                                         device=p.device),
                        exp_avg=torch.zeros_like(p),
                        exp_avg_sq=torch.zeros_like(p))
            st = [self.state[p] for p in ps]
            grads = [p.grad for p in ps]
            m, v = [s["exp_avg"] for s in st], [s["exp_avg_sq"] for s in st]
            steps = [s["step"] for s in st]
            (b1, b2), lr = g["betas"], g["lr"]
            torch._foreach_add_(steps, 1)
            if g["weight_decay"]:
                torch._foreach_mul_(ps, 1 - lr * g["weight_decay"])
            torch._foreach_lerp_(m, grads, 1 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, grads, grads, 1 - b2)
            # step size -lr / (1 - b1^t), correction sqrt(1 - b2^t)
            bc1 = torch._foreach_pow(b1, steps)
            bc2 = torch._foreach_pow(b2, steps)
            torch._foreach_sub_(bc1, 1)
            torch._foreach_sub_(bc2, 1)
            torch._foreach_neg_(bc2)
            torch._foreach_div_(bc1, lr)
            torch._foreach_reciprocal_(bc1)
            torch._foreach_sqrt_(bc2)
            denom = torch._foreach_sqrt(v)
            torch._foreach_div_(denom, bc2)
            torch._foreach_add_(denom, g["eps"])
            torch._foreach_div_(denom, bc1)
            torch._foreach_addcdiv_(ps, m, denom)


class _DeviceSGD(torch.optim.Optimizer):
    """p -= lr * grad with a device tensor as lr: torch.optim.SGD takes
    `alpha=-lr`, which reads a tensor rate back to the host."""

    def __init__(self, groups):
        super().__init__(groups, {})

    @torch.no_grad()
    def step(self):
        for g in self.param_groups:
            ps = [p for p in g["params"] if p.grad is not None]
            if ps:
                torch._foreach_add_(ps, torch._foreach_mul(
                    [p.grad for p in ps], -g["lr"]))


@dataclass
class Optimizer:
    """init(params) builds the torch optimizer and scheduler over the
    params' leaves (the opt_state); update steps both. Both keep their
    state in tensors on the params' device (the module's docstring)."""

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
        dev = groups[0]["params"][0].device
        base = [g["lr"] for g in groups]
        for g in groups:
            g["lr"] = torch.zeros((), dtype=torch.float32, device=dev)
        opt = (_DeviceSGD(groups) if self.optimizer == "SGD"
               else _DeviceAdam(groups, self.weight_decay))
        return {"opt": opt, "sched": DeviceSchedule(
            opt, base, self.milestones, self.scheduler_rate)}

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
