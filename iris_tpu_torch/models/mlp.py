"""Small MLP (counterpart of iris_tpu/models/mlp.py; the reference's tcnn
FullyFusedMLP, model/brdf.py:231-237: hidden ReLU layers, linear head).

The JAX package casts activations and weights to bf16 and accumulates in
f32 (mlp.py:37-39). Products of two bf16 values are exact in f32, so the
same numbers come from rounding both operands to bf16 and multiplying in
f32; only the summation order differs. TF32 would round the operands again
and is switched off for these products."""

from __future__ import annotations

import torch

from iris_tpu_torch.utils.profiling import span


def init_mlp(gen: torch.Generator, sizes: list[int], device) -> dict:
    """sizes = [in, hidden..., out]. He-uniform weights, zero biases."""
    params = {"w": [], "b": []}
    for i in range(len(sizes) - 1):
        bound = (6.0 / sizes[i]) ** 0.5
        w = torch.empty((sizes[i], sizes[i + 1]), dtype=torch.float32,
                        device=device)
        params["w"].append(w.uniform_(-bound, bound, generator=gen))
        params["b"].append(torch.zeros(sizes[i + 1], dtype=torch.float32,
                                       device=device))
    return params


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def apply_mlp(params: dict, x: torch.Tensor, bf16: bool = True
              ) -> torch.Tensor:
    """Forward pass with bf16 operands and f32 sums, or with bf16=False
    f32 operands (the implicit MLP of models/mlps.py); hidden activations
    ReLU, linear head. The span mlp.apply."""
    torch.backends.cuda.matmul.allow_tf32 = False
    n = len(params["w"])
    h = x
    with span("mlp.apply"):
        for i in range(n):
            w, b = params["w"][i], params["b"][i]
            if bf16:
                h = _bf16_round(h) @ _bf16_round(w) + b
            else:
                h = h @ w + b
            if i < n - 1:
                h = torch.relu(h)
    return h
