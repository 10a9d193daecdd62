"""Vector math primitives, batched over leading axes (counterpart of
iris_tpu/core/vecmath.py; reference utils/ops.py get_normal_space :12,
angle2xyz :32, double_sided :85)."""

from __future__ import annotations

import torch

EPS = 1e-12


def dot(a: torch.Tensor, b: torch.Tensor, keepdims: bool = True
        ) -> torch.Tensor:
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Safe L2-normalize along the last axis (F.normalize's eps clamp)."""
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=EPS)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def get_normal_space(normal: torch.Tensor) -> torch.Tensor:
    """Orthonormal frame (..., 3, 3) with columns (tangent, bitangent,
    normal). Tangent is normalize(x_axis x n) when |n.x| <= 0.1, else
    normalize(y_axis x n)."""
    x_axis = torch.zeros_like(normal)
    x_axis[..., 0] = 1.0
    y_axis = torch.zeros_like(normal)
    y_axis[..., 1] = 1.0
    near_x = torch.abs(normal[..., 0:1]) <= 1e-1
    t = torch.where(near_x, cross(x_axis, normal), cross(y_axis, normal))
    tangent = normalize(t)
    bitangent = cross(normal, tangent)
    return torch.stack([tangent, bitangent, normal], dim=-1)


def to_world(frame: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Transform local v (..., 3) by frame (..., 3, 3) columns (t, b, n)."""
    return (frame[..., 0] * v[..., 0:1]
            + frame[..., 1] * v[..., 1:2]
            + frame[..., 2] * v[..., 2:3])


def angle2xyz(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Spherical (theta from +z, phi around z) to a unit vector (..., 3)."""
    sin_t = torch.sin(theta)
    v = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                     torch.cos(theta)], dim=-1)
    return normalize(v)


def double_sided(view: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Flip normals to face the viewer (reference utils/ops.py:85)."""
    nov = dot(normal, view)
    return torch.where(nov < 0, -normal, normal)


def reflect(wo: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Mirror wo about h."""
    return 2.0 * dot(wo, h) * h - wo


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec. 709 luminance (..., 1) of rgb (..., 3)."""
    # filled on the device: a host tensor's copy would stop a graph capture
    w = torch.empty(3, dtype=rgb.dtype, device=rgb.device)
    for i, c in enumerate((0.2126, 0.7152, 0.0722)):
        w.narrow(0, i, 1).fill_(c)
    return torch.sum(rgb * w, dim=-1, keepdim=True)
