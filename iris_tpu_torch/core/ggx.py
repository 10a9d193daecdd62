"""GGX microfacet BRDF math (counterpart of iris_tpu/core/ggx.py; formula
parity with reference utils/ops.py G1_GGX_Schlick :46, G_Smith :56,
fresnelSchlick :64, fresnelSchlick_sep :69, D_GGX :74)."""

from __future__ import annotations

import math

import torch

PI = math.pi


def g1_ggx_schlick(nov: torch.Tensor, roughness: torch.Tensor
                   ) -> torch.Tensor:
    """Schlick-GGX G1 term, pre-divided by NoV."""
    k = roughness + 1.0
    k = k * k / 8.0
    denom = nov * (1.0 - k) + k
    return 1.0 / denom


def g_smith(nov: torch.Tensor, nol: torch.Tensor, roughness: torch.Tensor
            ) -> torch.Tensor:
    """Smith shadow-masking divided by (NoV*NoL)."""
    return g1_ggx_schlick(nol, roughness) * g1_ggx_schlick(nov, roughness)


def fresnel_schlick(voh: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
    x = (1.0 - voh) ** 5
    return f0 + (1.0 - f0) * x


def fresnel_schlick_sep(voh: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Split F = F0*(1-x) + x into its two weights (x = (1-VoH)^5)."""
    x = (1.0 - voh) ** 5
    return 1.0 - x, x


def d_ggx(noh: torch.Tensor, roughness: torch.Tensor) -> torch.Tensor:
    """GGX normal distribution with alpha = roughness^2."""
    alpha = roughness * roughness
    alpha2 = alpha * alpha
    denom = noh * noh * (alpha2 - 1.0) + 1.0
    return alpha2 / (PI * denom * denom)
