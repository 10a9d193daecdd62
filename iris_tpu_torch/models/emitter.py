"""Emitter models: triangle area lights + optional SLF radiance cache
(counterpart of iris_tpu/models/emitter.py; reference model/emitter.py
AreaEmitter :15, SLFEmitter :134). `slf=None` gives the AreaEmitter.

eval_emitter's radiance-cache early termination (roughness >
trace_roughness on non-emissive surfaces returns the cached SLF value and
ends the path, reference :210-219) is written with masks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from iris_tpu_torch.core.vecmath import normalize
from iris_tpu_torch.device import resolve_device
from iris_tpu_torch.models.slf import VoxelSLF, slf_query


class _RadianceRows(torch.autograd.Function):
    """radiance[e_idx] with the JAX package's explicit backward
    (_radiance_rows, emitter.py:25-54): for K <= 256 emitters the adjoint
    is onehot(e_idx)^T @ g, a skinny matrix product; above, a row
    scatter-add."""

    @staticmethod
    def forward(ctx, radiance, e_idx):
        ctx.save_for_backward(e_idx)
        ctx.k = radiance.shape[0]
        return radiance[e_idx]

    @staticmethod
    def backward(ctx, g):
        (e_idx,) = ctx.saved_tensors
        k = ctx.k
        if k <= 256:
            onehot = (e_idx[:, None] == torch.arange(k, device=g.device)
                      ).to(g.dtype)
            return onehot.t() @ g, None
        return torch.zeros((k, g.shape[-1]), dtype=g.dtype,
                           device=g.device).index_add_(0, e_idx, g), None


def radiance_rows(radiance: torch.Tensor, e_idx: torch.Tensor
                  ) -> torch.Tensor:
    return _RadianceRows.apply(radiance, e_idx)


@dataclass
class Emitter:
    is_emitter: torch.Tensor        # (F,) bool per mesh face
    emitter_idx: torch.Tensor       # (F,) int64 face -> emitter id, -1
    triangle_idx: torch.Tensor      # (K,) int64 emitter id -> face
    emitter_vertices: torch.Tensor  # (K, 3, 3)
    emitter_area: torch.Tensor      # (K,)
    radiance: torch.Tensor          # (K, 3)
    emitter_pdf: torch.Tensor       # (K,)
    emitter_cdf: torch.Tensor       # (K,)
    slf: VoxelSLF | None = None


def make_emitter(is_emitter: np.ndarray, triangles: np.ndarray,
                 radiance: np.ndarray | None = None,
                 slf: VoxelSLF | None = None, device=None) -> Emitter:
    """Emitter state from a face mask + (F,3,3) mesh triangles, with the
    reference's uniform selection pdf/cdf (:48-51)."""
    dev = resolve_device(device)
    is_emitter = np.asarray(is_emitter, bool)
    f = len(is_emitter)
    k = max(int(is_emitter.sum()), 1)
    emitter_idx = np.full(f, -1, np.int64)
    emitter_idx[is_emitter] = np.arange(is_emitter.sum())
    tri_idx = np.flatnonzero(is_emitter)
    if len(tri_idx) == 0:
        tri_idx = np.zeros(1, np.int64)
    verts = np.asarray(triangles, np.float32)[tri_idx]
    c = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    area = np.linalg.norm(c, axis=-1) / 2.0
    pdf = np.full(k, 1.0 / k, np.float32)
    cdf = np.cumsum(pdf)
    if radiance is None:
        radiance = np.zeros((k, 3), np.float32)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    return Emitter(
        is_emitter=t(is_emitter, torch.bool),
        emitter_idx=t(emitter_idx, torch.int64),
        triangle_idx=t(tri_idx, torch.int64),
        emitter_vertices=t(verts, torch.float32),
        emitter_area=t(area, torch.float32),
        radiance=t(radiance, torch.float32),
        emitter_pdf=t(pdf, torch.float32),
        emitter_cdf=t(cdf, torch.float32),
        slf=slf,
    )


def eval_emitter(em: Emitter, position: torch.Tensor,
                 light_dir: torch.Tensor, triangle_idx: torch.Tensor,
                 roughness: torch.Tensor | None = None,
                 trace_roughness: float = 0.6):
    """Surface emission + pdf at hit points: (Le (B,3), emit_pdf (B,1),
    valid_next (B,)). With `roughness` above `trace_roughness` on a
    non-emissive surface whose cache entry is non-empty, Le includes the
    SLF value and valid_next goes False (reference :180-221)."""
    vis = triangle_idx != -1
    eid = em.emitter_idx[torch.clamp(triangle_idx, min=0)]
    is_area = (eid >= 0) & vis
    e_idx = torch.clamp(eid, min=0)
    pdf_over_area = em.emitter_pdf / torch.clamp(em.emitter_area, min=1e-12)
    emit_pdf = torch.where(is_area, pdf_over_area[e_idx], 0.0)
    le = torch.where(is_area[:, None], radiance_rows(em.radiance, e_idx),
                     0.0)
    le = le * vis[:, None]
    valid_next = (~is_area) & vis

    if roughness is not None and em.slf is not None:
        is_diffuse = (~is_area) & vis & (roughness[..., 0] > trace_roughness)
        cache = slf_query(em.slf, position)
        le = le + torch.where(is_diffuse[:, None], cache, 0.0)
        terminate = is_diffuse & (torch.sum(cache, -1) > 0)
        valid_next = valid_next & (~terminate)

    return le, emit_pdf[:, None], valid_next


def sample_emitter(em: Emitter, sample1: torch.Tensor,
                   sample2: torch.Tensor, position: torch.Tensor):
    """Pick an emitter by cdf (left-side search, as jnp.searchsorted), then
    a uniform point on its triangle: (wi (B,3), pdf (B,1) area-space,
    triangle_idx (B,)) — reference model/emitter.py:100-131."""
    k = em.emitter_cdf.shape[0]
    e = torch.clamp(
        torch.searchsorted(em.emitter_cdf,
                           torch.clamp(sample1, min=1e-12).contiguous(),
                           right=False),
        0, k - 1)
    xi1 = torch.sqrt(sample2[..., 0])
    u = (1.0 - xi1)[:, None]
    v = (xi1 * sample2[..., 1])[:, None]
    w = 1.0 - u - v
    p = em.emitter_vertices[e]
    point = p[:, 0] * u + p[:, 1] * v + p[:, 2] * w
    wi = normalize(point - position)
    tri = em.triangle_idx[e]
    pdf_over_area = em.emitter_pdf / torch.clamp(em.emitter_area, min=1e-12)
    return wi, pdf_over_area[e][:, None], tri


def slf_forward(em: Emitter, position: torch.Tensor) -> torch.Tensor:
    """Radiance-cache lookup (reference SLFEmitter.forward :175-178)."""
    if em.slf is None:
        raise ValueError("emitter has no SLF radiance cache")
    return slf_query(em.slf, position)
