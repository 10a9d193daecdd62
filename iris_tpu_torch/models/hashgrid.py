"""Multi-resolution hash-grid encoding, exact row mode (counterpart of
iris_tpu/models/hashgrid.py; the reference's tiny-cuda-nn HashGrid,
model/brdf.py:222-229).

Only what renders run is ported: the row-gather layout and the exact
8-corner trilinear encode. The flat and packed 32Lx2F modes and the
stochastic-corner training estimators wait for the training slice.

Table layout (hashgrid.py:79-88): element (level, entry, feature) sits at
flat index (level*T + entry)*F + feature, so the (L*T, F) row view holds one
feature row per table entry. The port stores that row view.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_PRIMES = (1, 2654435761, 805459861)


@dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 32
    n_features: int = 2
    log2_table_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.3
    # feature-minor (L*T, F) rows, one row gather per corner; the only
    # mode this slice ports
    row_gather: bool = False

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    def resolutions(self) -> np.ndarray:
        """floor(base * scale**level) in numpy float64, exactly as the JAX
        package computes it (a float32 power can land a level one off)."""
        l = np.arange(self.n_levels)
        return np.floor(
            self.base_resolution * self.per_level_scale ** l
        ).astype(np.int64)


def init_hashgrid(gen: torch.Generator, cfg: HashGridConfig,
                  device) -> torch.Tensor:
    """(L*T, F) table rows, uniform(-1e-4, 1e-4)."""
    rows = torch.empty((cfg.n_levels * cfg.table_size, cfg.n_features),
                       dtype=torch.float32, device=device)
    return rows.uniform_(-1e-4, 1e-4, generator=gen)


def hashgrid_encode(rows: torch.Tensor, cfg: HashGridConfig,
                    x: torch.Tensor) -> torch.Tensor:
    """Encode positions x (B, 3) in [0,1]^3 -> features (B, L*F),
    level-major and feature-minor (hashgrid.py:750-761)."""
    if not cfg.row_gather:
        raise NotImplementedError(
            "only the exact row-mode encode (row_gather=True) is ported")
    dev = x.device
    b = x.shape[0]
    l = cfg.n_levels
    t = cfg.table_size
    res_np = cfg.resolutions()
    res = torch.as_tensor(res_np, dtype=torch.float32, device=dev)
    # int64 index math: the low log2(T) bits of the products and XORs are
    # those of the JAX package's uint32 math, and masks keep only those
    res_u = torch.as_tensor(res_np + 1, dtype=torch.int64, device=dev)
    dense_ok = torch.as_tensor((res_np + 1) ** 3 <= t, device=dev)
    level_off = torch.arange(l, dtype=torch.int64, device=dev) * t

    x = torch.clamp(x, 0.0, 1.0)
    # flat (M,) = (B*L,) arrays: m = query*L + level
    res_f = res_u.expand(b, l).reshape(-1)
    dense_f = dense_ok.expand(b, l).reshape(-1)
    off_f = level_off.expand(b, l).reshape(-1)

    def corner_index(cx, cy, cz):
        dense = cx + res_f * (cy + res_f * cz)
        hashed = (cx * _PRIMES[0] ^ cy * _PRIMES[1]
                  ^ cz * _PRIMES[2]) & (t - 1)
        idx = torch.where(dense_f, dense, hashed) + off_f
        # out-of-range reads clamp, as JAX gathers do
        return torch.clamp(idx, 0, l * t - 1)

    cell, frac = [], []
    for c in range(3):
        p = (x[:, c:c + 1] * res[None, :]).reshape(-1)
        c0 = torch.floor(p)
        cell.append(c0.to(torch.int64))
        frac.append(p - c0)

    acc = torch.zeros((b * l, rows.shape[1]), dtype=rows.dtype, device=dev)
    for k in range(8):                       # _row_lookup_impl (:475)
        kx, ky, kz = (k >> 2) & 1, (k >> 1) & 1, k & 1
        idx = corner_index(cell[0] + kx, cell[1] + ky, cell[2] + kz)
        wx = frac[0] if kx else 1.0 - frac[0]
        wy = frac[1] if ky else 1.0 - frac[1]
        wz = frac[2] if kz else 1.0 - frac[2]
        w = (wx * wy * wz).detach()
        acc = acc + rows[idx] * w[:, None]
    return acc.reshape(b, l * cfg.n_features)
