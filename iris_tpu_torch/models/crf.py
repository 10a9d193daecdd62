"""EMoR-basis camera response function (counterpart of
iris_tpu/models/crf.py; reference crf/model_crf.py EmorCRF): per-channel
weights over the first `dim` EMoR basis vectors on top of the mean curve
f0 (:32-43); forward = clip(hdr*exposure, 0, 1) -> per-channel curve lookup
(:68-86); inverse by monotone projection and numeric curve inversion
(:45-55, :88-106); regularizers (:108-122)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from iris_tpu_torch.core.interp import (
    interp1d, interp1d_uniform, mono_increase_constraint,
)
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


def get_inv_crf(crf: EmorCRF) -> torch.Tensor:
    """(3, 1024) inverse curves on a uniform grid (mono-projected)."""
    curves = get_crf(crf)
    x = torch.linspace(0.0, 1.0, curves.shape[-1], dtype=curves.dtype,
                       device=curves.device)
    return torch.stack([interp1d(x, mono_increase_constraint(c), x)
                        for c in curves])


def crf_inverse(crf: EmorCRF, ldr: torch.Tensor, exposure=None
                ) -> torch.Tensor:
    """ldr (B,3) -> hdr (B,3)."""
    if exposure is None:
        exposure = 1.0
    l = torch.clamp(ldr, 0.0, 1.0)
    inv = get_inv_crf(crf)
    return torch.stack([interp1d_uniform(l[:, i], inv[i])
                        for i in range(3)], dim=-1) / exposure


def reg_weight(crf: EmorCRF) -> torch.Tensor:
    return torch.mean(crf.weight ** 2)


def reg_monotonically_increasing(crf: EmorCRF) -> torch.Tensor:
    curves = get_crf(crf)
    diff = curves[:, 1:] - curves[:, :-1]
    return torch.sum(torch.relu(-diff))


def reg_smoothness(crf: EmorCRF) -> torch.Tensor:
    curves = get_crf(crf)
    s = curves[:, :-2] + curves[:, 2:] - 2.0 * curves[:, 1:-1]
    return torch.mean(s ** 2)


def fit_weight_to_crf(crf: EmorCRF, target: np.ndarray) -> np.ndarray:
    """Least-squares weights reproducing target curves (3, 1024)
    (reference cal_weight_fitting_crf :61-66)."""
    f0 = crf.f0.detach().cpu().numpy()
    basis = crf.basis.detach().cpu().numpy().T      # (1024, dim)
    pinv = np.linalg.inv(basis.T @ basis) @ basis.T
    return (pinv @ (np.asarray(target) - f0[None]).T).T
