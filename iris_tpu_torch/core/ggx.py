"""GGX microfacet BRDF math (counterpart of iris_tpu/core/ggx.py; formula
parity with reference utils/ops.py G1_GGX_Schlick :46, G_Smith :56,
fresnelSchlick :64, fresnelSchlick_sep :69, D_GGX :74, lerp_specular
:99)."""

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


def lerp_specular(specular: torch.Tensor, roughness: torch.Tensor
                  ) -> torch.Tensor:
    """Interpolate (..., R, 3) cached specular shadings at roughness
    (..., 1), remapped from [0.02, 1.0] to the R cached levels (reference
    utils/ops.py:99-119)."""
    r_min, r_max = 0.02, 1.0
    r_num = specular.shape[-2]
    r = (roughness - r_min) / (r_max - r_min) * (r_num - 1)
    r = torch.clamp(r, 0.0, float(r_num - 1))
    r0 = torch.floor(r).to(torch.int64)
    r1 = torch.ceil(r).to(torch.int64)
    frac = r - r0.to(r.dtype)
    pick = (specular.shape[-1],)
    s0 = torch.gather(specular, -2, r0[..., None].expand(
        *r0.shape[:-1], 1, *pick))[..., 0, :]
    s1 = torch.gather(specular, -2, r1[..., None].expand(
        *r1.shape[:-1], 1, *pick))[..., 0, :]
    return s0 * (1.0 - frac) + s1 * frac
