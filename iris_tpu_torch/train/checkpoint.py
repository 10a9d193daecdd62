"""Checkpoint save and restore of a training state (counterpart of
iris_tpu/train/checkpoint.py).

A checkpoint is a pickle of nested dicts and lists of numpy arrays:
{"params": ..., "opt_state": ..., "step": n}. params is the params tree
with every tensor as numpy and every NGPBRDF as a dict of its fields;
opt_state is the torch optimizer's and scheduler's state_dict with its
tensors as numpy. The JAX package's files pickle a JAX treedef beside the
leaves, so the two packages' checkpoint files are not exchangeable: carry
a state across with iris_tpu_torch.convert.
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch

from iris_tpu_torch.device import resolve_device
from iris_tpu_torch.models.brdf import NGPBRDF
from iris_tpu_torch.models.hashgrid import HashGridConfig
from iris_tpu_torch.train.optim import Optimizer, named_leaves

_NGP_TAG = "__ngp_brdf__"


def to_numpy(tree):
    """A params tree or a state_dict with every tensor as a numpy array
    (a copy: the optimizer updates the leaves in place)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, NGPBRDF):
        return {_NGP_TAG: True, "cfg": dataclasses.asdict(tree.cfg),
                **{k: to_numpy(getattr(tree, k))
                   for k in ("table", "mlp", "voxel_min", "voxel_max")}}
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return tree


def from_numpy(tree, device):
    """to_numpy's inverse: tensors on `device`, NGPBRDFs rebuilt."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy()).to(device)
    if isinstance(tree, dict):
        if tree.get(_NGP_TAG):
            return NGPBRDF(cfg=HashGridConfig(**tree["cfg"]), **{
                k: from_numpy(tree[k], device)
                for k in ("table", "mlp", "voxel_min", "voxel_max")})
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [from_numpy(v, device) for v in tree]
    return tree


def save_pytree(path: str, tree) -> None:
    """Pickle the tree with its tensors as numpy. ATOMIC: written to a
    temp file, then os.replace'd. A kill or an error mid-write (the very
    case the resume machinery exists for) never truncates the only
    checkpoint; the temp file is removed when the write raises."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            pickle.dump(to_numpy(tree), f)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    os.replace(tmp, path)


def _load_raw(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def load_pytree(path: str, device=None):
    """A saved tree with its tensors on `device`: None means the card, as
    at every entry point (device.resolve_device); "cpu" asks for the CPU."""
    return from_numpy(_load_raw(path), resolve_device(device))


def opt_state_to_numpy(opt_state: dict) -> dict:
    """The optimizer's and scheduler's state_dicts (moments, step counts,
    learning rates, the schedule's step count: optim.DeviceSchedule) as
    numpy."""
    return {"opt": to_numpy(opt_state["opt"].state_dict()),
            "sched": to_numpy(opt_state["sched"].state_dict())}


def restore_opt_state(optimizer: Optimizer, params: dict, saved: dict
                      ) -> dict:
    """A live opt_state over `params` from opt_state_to_numpy's dict. The
    state is handed over on the CPU: the optimizer's load_state_dict
    moves the moments and step counts to their parameters' device, and
    the schedule's load puts its step count back and its learning-rate
    tensors back into the optimizer's groups, so that a resumed run
    steps, eagerly or in CUDA graphs, on the uninterrupted run's bits."""
    opt_state = optimizer.init(params)
    opt_state["opt"].load_state_dict(from_numpy(saved["opt"], "cpu"))
    opt_state["sched"].load_state_dict(from_numpy(saved["sched"], "cpu"))
    return opt_state


def make_state_saver(path: str, every: int = 1000):
    """state_hook for run_training: every `every` steps persist the FULL
    training state {params, opt_state, step}, so that kill-and-resume
    reproduces the uninterrupted run."""

    def hook(step, params, opt_state):
        if every > 0 and (step + 1) % every == 0:
            save_pytree(path, {"params": params,
                               "opt_state": opt_state_to_numpy(opt_state),
                               "step": np.int64(step + 1)})
    return hook


def load_train_state(state_path: str, params_path: str, params,
                     optimizer: Optimizer | None = None, device=None):
    """Resume helper: the full state if present and readable, else a
    params-only file, else the given fresh params. Returns
    (params, opt_state | None, start_step). The restored params lie on
    `device` (None: the card, see load_pytree), and run_training trains
    on the device its params lie on. With `optimizer` the saved optimizer
    state comes back live (restore_opt_state), ready for run_training;
    without it, as the saved numpy dict."""
    # resolved first, so that a missing card raises here and is not taken
    # for an unreadable state file below
    device = resolve_device(device)
    if os.path.exists(state_path):
        try:
            st = _load_raw(state_path)
            restored = from_numpy(st["params"], device)
            opt_state = st["opt_state"]
            if optimizer is not None:
                opt_state = restore_opt_state(optimizer, restored, opt_state)
            print(f"[resume] full state from {state_path} "
                  f"(step {int(st['step'])})")
            return restored, opt_state, int(st["step"])
        except Exception as e:   # corrupt or partial state file
            print(f"[resume] unreadable state file {state_path}: {e}; "
                  "falling back")
    if os.path.exists(params_path):
        print(f"[resume] params only from {params_path} "
              "(optimizer state reset)")
        return load_pytree(params_path, device), None, 0
    return params, None, 0


def load_into(path: str, template):
    """Restore a file's leaves into an existing params tree, in place
    (count, shapes, dtypes and device follow the template); returns the
    template."""
    leaves = named_leaves(template)
    device = leaves[0][1].device if leaves else torch.device("cpu")
    loaded = named_leaves(load_pytree(path, device))
    if len(loaded) != len(leaves):
        raise ValueError("checkpoint/template structure mismatch: "
                         f"{len(loaded)} leaves in {path}, {len(leaves)} in "
                         "the template")
    with torch.no_grad():
        for (_, new), (_, old) in zip(loaded, leaves):
            old.copy_(new.reshape(old.shape).to(old.dtype))
    return template
