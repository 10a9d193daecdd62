"""BRDF model: analytic GGX+Lambert lobes and the neural (hash-grid) field
(counterpart of iris_tpu/models/brdf.py; reference model/brdf.py
diffuse_sampler :20, specular_sampler :36, eval_diffuse :70,
sample_diffuse :78, eval_specular :90, sample_specular :112, eval_brdf
:138, sample_brdf :177, NGPBRDF :213), and the fixed ConstantBRDF of the
shading bakes and the analytic oracles.

The reference's `.data` detach points (the GGX NDF inside sampling pdfs and
the sampler's alpha) are `.detach()` here, at the same places as the JAX
package's stop_gradient (brdf.py:50,89,105,118).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from iris_tpu_torch.core.ggx import (
    d_ggx, fresnel_schlick, fresnel_schlick_sep, g_smith,
)
from iris_tpu_torch.core.vecmath import (
    angle2xyz, dot, get_normal_space, normalize, reflect, to_world,
)
from iris_tpu_torch.device import resolve_device
from iris_tpu_torch.models.hashgrid import (
    HashGridConfig, hashgrid_encode, init_hashgrid,
)
from iris_tpu_torch.models.mlp import apply_mlp, init_mlp

PI = math.pi


# ---------------------------------------------------------------- samplers

def diffuse_sampler(sample2: torch.Tensor, normal: torch.Tensor
                    ) -> torch.Tensor:
    """Cosine-hemisphere sample around normal: wi ~ NoL/pi."""
    theta = torch.arcsin(torch.sqrt(sample2[..., 0]))
    phi = 2.0 * PI * sample2[..., 1]
    wi = angle2xyz(theta, phi)
    return to_world(get_normal_space(normal), wi)


def specular_sampler(sample2: torch.Tensor, roughness: torch.Tensor,
                     wo: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """GGX NDF half-vector sample, reflected to wi (h ~ D*NoH)."""
    alpha = (roughness * roughness).reshape(roughness.shape[0]).detach()
    c2 = (1.0 - sample2[..., 0]) / (sample2[..., 0] * (alpha * alpha - 1.0)
                                    + 1.0)
    theta = torch.arccos(torch.sqrt(torch.clamp(c2, 0.0, 1.0)))
    phi = 2.0 * PI * sample2[..., 1]
    wh = angle2xyz(theta, phi)
    wh = to_world(get_normal_space(normal), wh)
    return normalize(reflect(wo, wh))


# ------------------------------------------------------------ eval / sample

def eval_diffuse(wi, normal):
    """Lambert lobe * NoL and its cosine pdf: (brdf (B,3), pdf (B,1))."""
    pdf = torch.relu(dot(normal, wi)) / PI
    return pdf.expand(*pdf.shape[:-1], 3), pdf


def sample_diffuse(sample2, normal):
    """Cosine-hemisphere sample: (wi, pdf (B,1), brdf/pdf weight = 1)."""
    wi = diffuse_sampler(sample2, normal)
    pdf = torch.relu(dot(normal, wi)) / PI
    return wi, pdf, torch.ones_like(normal)


def _half_products(wi, wo, normal):
    h = normalize(wi + wo)
    nol = torch.relu(dot(wi, normal))
    nov = torch.relu(dot(wo, normal))
    voh = torch.relu(dot(wo, h))
    noh = torch.relu(dot(normal, h))
    return nol, nov, voh, noh


def eval_specular(wi, wo, normal, roughness):
    """Two Fresnel-split specular lobes + the (detached-D) sampling pdf."""
    nol, nov, voh, noh = _half_products(wi, wo, normal)
    d = d_ggx(noh, roughness)
    pdf = d.detach() / (4.0 * torch.clamp(voh, min=1e-4)) * noh
    g = g_smith(nov, nol, roughness)
    f0, f1 = fresnel_schlick_sep(voh)
    return d * g * f0 / 4.0 * nol, d * g * f1 / 4.0 * nol, pdf


def sample_specular(sample2, wo, normal, roughness):
    """Sample the GGX lobe; weights are brdf/pdf for the two Fresnel
    terms. roughness: a scalar, (B,) or (B, 1)."""
    if not isinstance(roughness, torch.Tensor):     # filled on the device
        roughness = torch.full((), float(roughness), dtype=wo.dtype,
                               device=wo.device)
    roughness = roughness.to(dtype=wo.dtype, device=wo.device)
    if roughness.dim() <= 1:
        roughness = roughness.reshape(-1, 1)
    roughness = roughness.expand(wo.shape[0], 1)
    wi = specular_sampler(sample2, roughness, wo, normal)
    nol, nov, voh, noh = _half_products(wi, wo, normal)
    d = d_ggx(noh, roughness)
    pdf = d.detach() / (4.0 * torch.clamp(voh, min=1e-4)) * noh
    g = g_smith(nov, nol, roughness)
    f0, f1 = fresnel_schlick_sep(voh)
    fac = g * voh * nol / torch.clamp(noh, min=1e-4)
    return wi, pdf, f0 * fac, f1 * fac


def eval_brdf(wi, wo, normal, mat):
    """Full BRDF (Lambert kd + GGX ks) * NoL, plus the mixed sampling
    pdf."""
    albedo, roughness, metallic = (mat["albedo"], mat["roughness"],
                                   mat["metallic"])
    nol, nov, voh, noh = _half_products(wi, wo, normal)
    d = d_ggx(noh, roughness)
    pdf_spec = d.detach() / (4.0 * torch.clamp(voh, min=1e-4)) * noh
    pdf_diff = nol / PI
    pdf = 0.5 * pdf_spec + 0.5 * pdf_diff
    kd = albedo * (1.0 - metallic)
    ks = 0.04 * (1.0 - metallic) + albedo * metallic
    g = g_smith(nov, nol, roughness)
    f = fresnel_schlick(voh, ks)
    brdf = kd / PI * nol + d * g * f / 4.0 * nol
    return brdf, pdf


def sample_brdf(sample1, sample2, wo, normal, mat):
    """50/50 lobe-mixed importance sample; returns (wi, pdf, brdf/pdf)."""
    wi_d = diffuse_sampler(sample2, normal)
    wi_s = specular_sampler(sample2, mat["roughness"], wo, normal)
    pick_diffuse = (sample1 > 0.5)[..., None]
    wi = torch.where(pick_diffuse, wi_d, wi_s)
    brdf, pdf = eval_brdf(wi, wo, normal, mat)
    pos = pdf > 0
    w = torch.where(pos, brdf / torch.where(pos, pdf, 1.0), 0.0)
    w = torch.where(torch.isnan(w), 0.0, w)
    return wi, pdf, w


# -------------------------------------------------------------- NGP field

@dataclass
class NGPBRDF:
    """Hash-grid + MLP BRDF parameter field (reference NGPBRDF
    :213-260)."""

    table: torch.Tensor        # flat (F*L*T,), or (L*T, F) rows in row
                               # mode; see models/hashgrid.py
    mlp: dict                  # {"w": [...], "b": [...]}
    voxel_min: torch.Tensor    # scalar or (3,)
    voxel_max: torch.Tensor
    cfg: HashGridConfig


def init_ngp_brdf(seed: int, voxel_min, voxel_max,
                  cfg: HashGridConfig | None = None, hidden: int = 64,
                  n_hidden: int = 2, device=None) -> NGPBRDF:
    """Random field from `seed` (a torch.Generator stream: the values are
    not the JAX package's; convert.py carries those across). The default
    cfg is HashGridConfig(), the reference's 32 x 2 grid, as in the JAX
    package (models/brdf.py:160)."""
    dev = resolve_device(device)
    cfg = cfg or HashGridConfig()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    feat = cfg.n_levels * cfg.n_features
    return NGPBRDF(
        table=init_hashgrid(gen, cfg, dev),
        mlp=init_mlp(gen, [feat] + [hidden] * n_hidden + [5], dev),
        voxel_min=torch.as_tensor(voxel_min, dtype=torch.float32,
                                  device=dev),
        voxel_max=torch.as_tensor(voxel_max, dtype=torch.float32,
                                  device=dev),
        cfg=cfg,
    )


def ngp_brdf_apply(params: NGPBRDF, position: torch.Tensor,
                   gen: torch.Generator | None = None,
                   samples: dict | None = None) -> dict:
    """BRDF parameters at positions (B,3): albedo (B,3), roughness (B,1)
    in [0.02, 1], metallic (B,1) (reference model/brdf.py:243-260).

    A generator or a `samples` dict (hashgrid_encode's) switches on the
    hash grid's stochastic-corner estimators, the training hot path; with
    neither the encode is exact, as renders use it."""
    x = (position - params.voxel_min) / (params.voxel_max
                                         - params.voxel_min)
    feat = hashgrid_encode(params.table, params.cfg, x, gen, samples)
    out = torch.sigmoid(apply_mlp(params.mlp, feat))
    return {
        "albedo": out[..., 0:3],
        "roughness": out[..., 3:4] * 0.98 + 0.02,
        "metallic": out[..., 4:5],
    }


@dataclass
class ConstantBRDF:
    """Fixed material for tests and shading bakes (reference BaseBRDF
    role): albedo (3,), roughness and metallic scalars or (1,)."""

    albedo: torch.Tensor
    roughness: torch.Tensor
    metallic: torch.Tensor


def constant_brdf_apply(params: ConstantBRDF, position: torch.Tensor
                        ) -> dict:
    b = position.shape[0]
    return {
        "albedo": torch.broadcast_to(params.albedo, (b, 3)),
        "roughness": torch.broadcast_to(params.roughness, (b, 1)),
        "metallic": torch.broadcast_to(params.metallic, (b, 1)),
    }
