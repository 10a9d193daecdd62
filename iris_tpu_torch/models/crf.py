"""EMoR-basis camera response function (counterpart of
iris_tpu/models/crf.py; reference crf/model_crf.py EmorCRF): per-channel
weights over the first `dim` EMoR basis vectors on top of the mean curve
f0 (:32-43); forward = clip(hdr*exposure, 0, 1) -> per-channel curve lookup
(:68-86). The inverse waits for the slice that needs it."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from iris_tpu_torch.core.interp import interp1d_uniform
from iris_tpu_torch.device import resolve_device
from iris_tpu_torch.models.emor import emor_mean_and_basis


@dataclass
class EmorCRF:
    weight: torch.Tensor  # (3, dim) learnable
    f0: torch.Tensor      # (1024,)
    basis: torch.Tensor   # (dim, 1024)
    dim: int


def init_emor_crf(dim: int = 3, device=None) -> EmorCRF:
    dev = resolve_device(device)
    f0, basis = emor_mean_and_basis(dim)
    return EmorCRF(
        weight=torch.zeros((3, dim), dtype=torch.float32, device=dev),
        f0=torch.from_numpy(f0).to(dev),
        basis=torch.from_numpy(basis).to(dev),
        dim=dim,
    )


def get_crf(crf: EmorCRF) -> torch.Tensor:
    """(3, 1024) response curves."""
    return crf.f0[None] + crf.weight @ crf.basis


def crf_forward(crf: EmorCRF, hdr: torch.Tensor, exposure=None
                ) -> torch.Tensor:
    """hdr (B,3) -> ldr (B,3). exposure broadcasts (scalar or (B,1))."""
    if exposure is None:
        exposure = 1.0
    h = torch.clamp(hdr * exposure, 0.0, 1.0)
    curves = get_crf(crf)
    return torch.stack([interp1d_uniform(h[:, i], curves[i])
                        for i in range(3)], dim=-1)
