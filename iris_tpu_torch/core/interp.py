"""1-D regular-grid interpolation and the monotone projection of a
response curve (counterpart of iris_tpu/core/interp.py)."""

from __future__ import annotations

import torch


def interp1d_uniform(x: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Interpolate fp, sampled on linspace(0, 1, N), at x (clamped to
    [0, 1] like the reference's RegularGridInterpolator)."""
    n = fp.shape[-1]
    xi = torch.clamp(x, 0.0, 1.0) * (n - 1)
    i0 = torch.clamp(torch.floor(xi).to(torch.int64), 0, n - 2)
    frac = xi - i0.to(xi.dtype)
    f0 = fp[..., i0]
    f1 = fp[..., i0 + 1]
    return f0 * (1.0 - frac) + f1 * frac


def interp1d(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
             ) -> torch.Tensor:
    """Linear interpolation of fp sampled at increasing xp, queried at x,
    clamped at both ends: numpy.interp (and jnp.interp) semantics."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    n - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    dx = x1 - x0
    w = torch.where(dx > 0, (x - x0) / torch.where(dx > 0, dx, 1.0), 0.0)
    out = f0 + (f1 - f0) * w
    out = torch.where(x < xp[0], fp[0], out)
    return torch.where(x > xp[-1], fp[-1], out)


def mono_increase_constraint(crf: torch.Tensor) -> torch.Tensor:
    """Project a curve to a monotone-increasing one normalized to [0, 1]
    (crf/model_crf.py:22-30): shift all finite differences by the most
    negative one, renormalize to sum 1, cumulative-sum, prepend 0."""
    diff = crf[1:] - crf[:-1]
    gap = torch.clamp(-torch.min(diff), min=0.0)
    diff = diff + gap
    diff = diff / torch.sum(diff)
    return torch.cat([torch.zeros(1, dtype=crf.dtype, device=crf.device),
                      torch.cumsum(diff, 0)])
