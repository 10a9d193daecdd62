"""Generic MLP building blocks (counterpart of iris_tpu/models/mlps.py;
parity: reference model/mlps.py).

The reference keeps a NeRF-style positional encoding + skip MLP that its
trainers import but never instantiate (model/mlps.py:15-89,
train_brdf_crf.py:35); provided here for the same API surface and for
experiments that swap the hash grid for a frequency encoding. As functions
over a parameter dict (the JAX package's form; convert.implicit_mlp
carries a JAX tree's weights across) and as an nn.Module, ImplicitMLP.
Float32 throughout, TF32 off (models/mlp.apply_mlp with bf16=False).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from iris_tpu_torch.device import resolve_device
from iris_tpu_torch.models.mlp import apply_mlp, init_mlp


def positional_encoding(x: torch.Tensor, n_freqs: int = 10,
                        include_input: bool = True) -> torch.Tensor:
    """NeRF frequency encoding: [x, sin(2^k pi x), cos(2^k pi x)]."""
    outs = [x] if include_input else []
    for k in range(n_freqs):
        f = (2.0 ** k) * math.pi
        outs.append(torch.sin(f * x))
        outs.append(torch.cos(f * x))
    return torch.cat(outs, dim=-1)


def init_implicit_mlp(gen: torch.Generator, in_dim: int = 3,
                      out_dim: int = 5, width: int = 256, depth: int = 8,
                      skip_at: int = 4, n_freqs: int = 10,
                      device=None) -> dict:
    """NeRF-style skip MLP over positional-encoded input: the trunk's
    weights drawn from `gen` first, then the head's (He-uniform, zero
    biases), on `device` (default: the card)."""
    dev = resolve_device(device)
    enc_dim = in_dim * (1 + 2 * n_freqs)
    trunk = init_mlp(gen, [enc_dim] + [width] * skip_at, dev)
    head = init_mlp(gen, [width + enc_dim] + [width] * (depth - skip_at)
                    + [out_dim], dev)
    return {"trunk": trunk, "head": head, "n_freqs": n_freqs}


def apply_implicit_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    enc = positional_encoding(x, params["n_freqs"])
    h = torch.relu(apply_mlp(params["trunk"], enc, bf16=False))
    return apply_mlp(params["head"], torch.cat([h, enc], -1), bf16=False)


class ImplicitMLP(nn.Module):
    """apply_implicit_mlp with the trunk's and the head's weights and
    biases as the module's parameters; params: what init_implicit_mlp or
    convert.implicit_mlp returns."""

    def __init__(self, params: dict):
        super().__init__()
        self.n_freqs = int(params["n_freqs"])
        self.trunk = nn.ParameterDict({
            k: nn.ParameterList(params["trunk"][k]) for k in ("w", "b")})
        self.head = nn.ParameterDict({
            k: nn.ParameterList(params["head"][k]) for k in ("w", "b")})

    def as_params(self) -> dict:
        """The parameter dict of apply_implicit_mlp (the module's own
        tensors, not copies)."""
        return {"trunk": {k: list(v) for k, v in self.trunk.items()},
                "head": {k: list(v) for k, v in self.head.items()},
                "n_freqs": self.n_freqs}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_implicit_mlp(self.as_params(), x)
