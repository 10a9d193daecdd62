"""Voxel surface-light-field radiance cache (counterpart of
iris_tpu/models/slf.py; reference model/slf.py VoxelSLF :16-70): a dense
H^3 index grid maps occupied voxels to a compact (K, 3) radiance table;
queries outside occupied voxels return 0.

The bake's scatter-add is a deterministic segment sum
(core/segment.py): the same bits on every run, on the card as on the
CPU. It adds in another order than the JAX package's `.at[].add`, so the
two agree to float rounding."""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from iris_tpu_torch.core.segment import segment_sum
from iris_tpu_torch.device import resolve_device


@dataclass
class VoxelSLF:
    inds: torch.Tensor       # (H^3,) int64: flat voxel -> compact idx, -1
    radiance: torch.Tensor   # (K, 3) float32
    count: torch.Tensor      # (K,) float32 entry counts
    voxel_min: torch.Tensor  # scalar f32 (isotropic bbox)
    voxel_max: torch.Tensor
    H: int


def init_voxel_slf(mask: np.ndarray, voxel_min: float, voxel_max: float,
                   device=None) -> VoxelSLF:
    """mask: (H,H,H) bool occupancy, indexed [z,y,x]
    (flat = x + y*H + z*H^2)."""
    dev = resolve_device(device)
    h = mask.shape[0]
    flat = np.asarray(mask, bool).reshape(-1)
    k = int(flat.sum())
    inds = np.full(h * h * h, -1, np.int64)
    inds[np.flatnonzero(flat)] = np.arange(k)
    return VoxelSLF(
        inds=torch.from_numpy(inds).to(dev),
        radiance=torch.zeros((max(k, 1), 3), dtype=torch.float32, device=dev),
        count=torch.zeros(max(k, 1), dtype=torch.float32, device=dev),
        voxel_min=torch.tensor(voxel_min, dtype=torch.float32, device=dev),
        voxel_max=torch.tensor(voxel_max, dtype=torch.float32, device=dev),
        H=h,
    )


def spatial_idx(slf: VoxelSLF, x: torch.Tensor) -> torch.Tensor:
    """Compact voxel index for positions (B,3); -1 where empty."""
    h = slf.H
    xn = (x - slf.voxel_min) / (slf.voxel_max - slf.voxel_min)
    # clamp before the cast: far-out positions saturate as in JAX (a
    # float->int cast out of range is undefined in C)
    xi = torch.clamp(torch.clamp(xn * h, -1.0, float(h)).to(torch.int64),
                     0, h - 1)
    flat = xi[..., 0] + xi[..., 1] * h + xi[..., 2] * h * h
    return slf.inds[flat]


def slf_query(slf: VoxelSLF, x: torch.Tensor) -> torch.Tensor:
    """Radiance at positions (B,3); zeros for empty voxels."""
    idx = spatial_idx(slf, x)
    rgb = slf.radiance[torch.clamp(idx, min=0)]
    return torch.where((idx >= 0)[..., None], rgb, 0.0)


def slf_scatter_add(slf: VoxelSLF, x: torch.Tensor, radiance: torch.Tensor,
                    mask: torch.Tensor | None = None) -> VoxelSLF:
    """Accumulate radiance (B, 3) at positions (B, 3) into their voxels;
    rows outside occupied voxels or off `mask` add nothing. Returns the
    updated SLF (functional)."""
    idx = spatial_idx(slf, x)
    ok = idx >= 0
    if mask is not None:
        ok = ok & mask
    k = slf.radiance.shape[0]
    # rows that add nothing go to an overflow bucket: no host sync
    seg = torch.where(ok, idx, k)
    rows = torch.cat([radiance, torch.ones_like(radiance[:, :1])], -1)
    acc = segment_sum(torch.where(ok[:, None], rows, 0.0), seg, k + 1)[:k]
    return replace(slf, radiance=slf.radiance + acc[:, :3],
                   count=slf.count + acc[:, 3])


def slf_finalize_mean(slf: VoxelSLF) -> VoxelSLF:
    """Mean-pool accumulated radiance (reference slf_bake.py:138)."""
    return replace(slf, radiance=slf.radiance
                   / torch.clamp(slf.count, min=1.0)[:, None])
