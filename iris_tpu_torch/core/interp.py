"""1-D regular-grid interpolation (counterpart of
iris_tpu/core/interp.py: only interp1d_uniform, which crf_forward uses)."""

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
