"""Multi-resolution hash-grid encoding, row mode (counterpart of
iris_tpu/models/hashgrid.py; the reference's tiny-cuda-nn HashGrid,
model/brdf.py:222-229).

Ported: the row-gather layout, the exact 8-corner trilinear encode (what
renders run), and the stochastic-corner training estimators with their
explicit backward passes (hashgrid.py:426-568). The flat and packed 32Lx2F
modes raise NotImplementedError.

Table layout (hashgrid.py:79-88): element (level, entry, feature) sits at
flat index (level*T + entry)*F + feature, so the (L*T, F) row view holds one
feature row per table entry. The port stores that row view.

Randomness is explicit. The stochastic estimators draw from a
torch.Generator, or take a `samples` dict that overrides every draw:
"u3" (3, B*L_eff) corner uniforms, "phase" and "fphase" (ints) the
level-block phases of the backward and forward subsampling. The parity
tests replay the JAX package's key stream into that dict.
"""

from __future__ import annotations

import random
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
    # Stochastic-corner estimators (active only when hashgrid_encode gets a
    # generator or samples). Each axis bit of the corner is an independent
    # Bernoulli(frac_axis), so the chosen corner has exactly its trilinear
    # weight as probability and the importance weight is 1.
    #   stochastic_bwd: the backward scatters the cotangent to the ONE
    #     sampled corner (E[grad] = exact grad); the forward stays exact.
    #   stochastic_fwd: the forward gathers the one sampled corner too.
    stochastic_bwd: bool = True
    stochastic_fwd: bool = False
    # Strided level-block subsampling of the stochastic backward: one
    # shared phase s per step, cotangents scattered only for levels
    # {s, s+stride, ...} (bwd_level_sample of n_levels), scaled by stride.
    # 0 = all levels.
    bwd_level_sample: int = 0
    # The same subsampling of the stochastic forward: kept levels scaled by
    # the stride, the rest zero. Requires stochastic_fwd; 0 = all levels.
    fwd_level_sample: int = 0
    # feature-minor (L*T, F) rows, one row gather per corner; the only
    # mode ported
    row_gather: bool = False
    # Compact per-level-block gradient scatter: each sampled level's
    # cotangents go into their own (T, F) buffer, accumulated in
    # bwd_scatter_dtype, and the buffers are placed into the (L*T, F)
    # table cotangent.
    bwd_compact_scatter: bool = True
    bwd_scatter_dtype: str = "bfloat16"
    # Forward gathers of the stochastic estimators may read a bfloat16 cast
    # of the table (master rows stay f32). Renders always read f32.
    fwd_gather_dtype: str = "float32"

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


def auto_bwd_level_sample(n_levels: int, ratio: int = 4) -> int:
    """Largest divisor of n_levels that is <= n_levels/ratio (>= 1): the
    trainers' default gradient-scatter reduction (hashgrid.py:149)."""
    target = max(n_levels // ratio, 1)
    for k in range(target, 0, -1):
        if n_levels % k == 0:
            return k
    return 1


def init_hashgrid(gen: torch.Generator, cfg: HashGridConfig,
                  device) -> torch.Tensor:
    """(L*T, F) table rows, uniform(-1e-4, 1e-4)."""
    rows = torch.empty((cfg.n_levels * cfg.table_size, cfg.n_features),
                       dtype=torch.float32, device=device)
    return rows.uniform_(-1e-4, 1e-4, generator=gen)


# ---------------------------------------------------------- row-mode lookups

def _row_scatter_chosen(g_rows, chosen_idx, phase, lt, levels, bwd_k,
                        tsize=0, compact=None):
    """(M, F) cotangent -> (L*T, F) table cotangent by ONE row scatter per
    query at the sampled corner row (hashgrid.py:426-472).

    With 0 < bwd_k < levels: strided level-block subsampling. Flat
    m = q*levels + lvl with lvl = j*stride + r; keep r == phase and scale
    by stride. With `compact` ("bfloat16" or "float32"), tsize < lt and at
    most 16 slots: each kept level's rows go into a (tsize, F) buffer of
    that dtype (every index of one slot column shares a level block), and
    the buffers are placed into the full cotangent; otherwise one scatter
    into the full table."""
    f = g_rows.shape[1]
    k_slots = levels or 1
    if bwd_k and levels and bwd_k < levels:
        stride = levels // bwd_k
        b = chosen_idx.shape[0] // levels
        chosen_idx = chosen_idx.reshape(b, bwd_k, stride)[:, :, phase] \
            .reshape(b * bwd_k)
        g_rows = g_rows.reshape(b, bwd_k, stride, f)[:, :, phase] \
            .reshape(b * bwd_k, f) * float(stride)
        k_slots = bwd_k
    full = torch.zeros((lt, f), dtype=g_rows.dtype, device=g_rows.device)
    if not (compact and 0 < tsize < lt and k_slots <= 16):
        return full.index_add_(0, chosen_idx, g_rows)
    out_dtype = g_rows.dtype
    acc_dtype = torch.bfloat16 if compact == "bfloat16" else out_dtype
    b = chosen_idx.shape[0] // k_slots
    idx2 = chosen_idx.reshape(b, k_slots)
    g3 = g_rows.to(acc_dtype).reshape(b, k_slots, f)
    blocks = full.view(lt // tsize, tsize, f)
    for j in range(k_slots):
        local = idx2[:, j] & (tsize - 1)
        block = idx2[:1, j] // tsize        # uniform level block per slot
        buf = torch.zeros((tsize, f), dtype=acc_dtype, device=g_rows.device)
        buf.index_add_(0, local, g3[:, j])
        # placed by a device-side index: no host read of the block id
        blocks.index_copy_(0, block, buf.to(out_dtype)[None])
    return full


def _row_cast(rows, gdtype):
    """Mixed-precision forward reads (cfg.fwd_gather_dtype)."""
    if gdtype == "bfloat16" and rows.dtype != torch.bfloat16:
        return rows.to(torch.bfloat16)
    return rows


def _row_lookup(rows, idxs, weights, gdtype=None):
    """Sum over corners k of rows[idxs[k]] * weights[k]: idxs (8, M)."""
    rcast = _row_cast(rows, gdtype)
    acc = torch.zeros((idxs.shape[1], rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    for k in range(idxs.shape[0]):
        acc = acc + rcast[idxs[k]].to(rows.dtype) * weights[k][:, None]
    return acc


class _RowWeighted(torch.autograd.Function):
    """Exact 8-corner weighted row lookup; the backward scatters g*w to all
    eight corners (_row_weighted_p, hashgrid.py:482-501)."""

    @staticmethod
    def forward(ctx, rows, idxs, weights):
        ctx.save_for_backward(idxs, weights)
        ctx.lt = rows.shape[0]
        return _row_lookup(rows, idxs, weights)

    @staticmethod
    def backward(ctx, g):
        idxs, weights = ctx.saved_tensors
        acc = torch.zeros((ctx.lt, g.shape[1]), dtype=g.dtype,
                          device=g.device)
        for k in range(idxs.shape[0]):
            acc.index_add_(0, idxs[k], g * weights[k][:, None])
        return acc, None, None


class _RowStochBwd(torch.autograd.Function):
    """Exact forward, stochastic backward: the cotangent goes to the one
    sampled corner row (_row_stoch_bwd_p, hashgrid.py:522-545)."""

    @staticmethod
    def forward(ctx, rows, idxs, weights, chosen_idx, phase, levels, bwd_k,
                tsize, compact, gdtype):
        ctx.save_for_backward(chosen_idx)
        ctx.args = (phase, rows.shape[0], levels, bwd_k, tsize, compact)
        return _row_lookup(rows, idxs, weights, gdtype)

    @staticmethod
    def backward(ctx, g):
        (chosen_idx,) = ctx.saved_tensors
        phase, lt, levels, bwd_k, tsize, compact = ctx.args
        return (_row_scatter_chosen(g, chosen_idx, phase, lt, levels, bwd_k,
                                    tsize, compact),) + (None,) * 9


class _RowStoch(torch.autograd.Function):
    """Stochastic forward and backward: one gather and one scatter at the
    sampled corner row (_row_stoch_p, hashgrid.py:548-568)."""

    @staticmethod
    def forward(ctx, rows, chosen_idx, phase, levels, bwd_k, tsize, compact,
                gdtype):
        ctx.save_for_backward(chosen_idx)
        ctx.args = (phase, rows.shape[0], levels, bwd_k, tsize, compact)
        return _row_cast(rows, gdtype)[chosen_idx].to(rows.dtype)

    @staticmethod
    def backward(ctx, g):
        (chosen_idx,) = ctx.saved_tensors
        phase, lt, levels, bwd_k, tsize, compact = ctx.args
        return (_row_scatter_chosen(g, chosen_idx, phase, lt, levels, bwd_k,
                                    tsize, compact),) + (None,) * 7


def row_weighted(rows, idxs, weights):
    return _RowWeighted.apply(rows, idxs, weights)


def row_stoch_bwd(rows, idxs, weights, chosen_idx, phase, levels, bwd_k,
                  tsize=0, compact=None, gdtype=None):
    return _RowStochBwd.apply(rows, idxs, weights, chosen_idx, int(phase),
                              levels, bwd_k, tsize, compact, gdtype)


def row_stoch(rows, chosen_idx, phase, levels, bwd_k, tsize=0, compact=None,
              gdtype=None):
    return _RowStoch.apply(rows, chosen_idx, int(phase), levels, bwd_k,
                           tsize, compact, gdtype)


def _draw_phase(gen, samples, name, n) -> int:
    """One level-block phase in [0, n), as a host integer (it slices numpy
    arrays and reshaped views) drawn without reading the device: a CPU
    generator draws it directly; a CUDA generator's seed and Philox offset
    are host-side counters, and the phase is drawn from them (the offset
    moves on with every corner draw, so each step gets a fresh phase; the
    name keeps the forward and backward phases of one call apart)."""
    if samples is not None:
        return int(samples[name])
    if gen.device.type == "cpu":
        return int(torch.randint(0, n, (1,), generator=gen))
    return random.Random(
        f"{name}:{gen.initial_seed()}:{gen.get_offset()}").randrange(n)


def hashgrid_encode(rows: torch.Tensor, cfg: HashGridConfig,
                    x: torch.Tensor, gen: torch.Generator | None = None,
                    samples: dict | None = None) -> torch.Tensor:
    """Encode positions x (B, 3) in [0,1]^3 -> features (B, L*F),
    level-major and feature-minor (hashgrid.py:571-761).

    With `gen` or `samples` and cfg.stochastic_{bwd,fwd} it runs the
    unbiased stochastic-corner estimators; with neither, the exact encode
    (what renders use). `samples` overrides the draws: "u3"
    (3, B*L_eff), "phase", "fphase"."""
    if not cfg.row_gather:
        raise NotImplementedError(
            "only the row-mode encode (row_gather=True) is ported")
    for name in ("bwd_scatter_dtype", "fwd_gather_dtype"):
        if getattr(cfg, name) not in ("bfloat16", "float32"):
            raise ValueError(f"{name} must be 'bfloat16' or 'float32', got "
                             f"{getattr(cfg, name)!r}")
    dev = x.device
    b = x.shape[0]
    l = cfg.n_levels
    t = cfg.table_size
    keyed = gen is not None or samples is not None
    stoch = keyed and (cfg.stochastic_bwd or cfg.stochastic_fwd)

    res_np = cfg.resolutions()
    level_np = np.arange(l, dtype=np.int64)
    if cfg.fwd_level_sample and keyed and not cfg.stochastic_fwd:
        raise ValueError("fwd_level_sample requires stochastic_fwd")
    fwd_k = cfg.fwd_level_sample if (stoch and cfg.stochastic_fwd) else 0
    fphase = None
    if fwd_k and 0 < fwd_k < l:
        if l % fwd_k:
            raise ValueError(
                f"fwd_level_sample={fwd_k} must divide n_levels={l}")
        fstride = l // fwd_k
        fphase = _draw_phase(gen, samples, "fphase", fstride)
        # slice every per-level array to the sampled levels first, so the
        # index math, corner sampling and gather all shrink by the stride
        res_np = res_np.reshape(fwd_k, fstride)[:, fphase]
        level_np = level_np.reshape(fwd_k, fstride)[:, fphase]
        l_eff = fwd_k
    else:
        fwd_k = 0
        l_eff = l

    res = torch.as_tensor(res_np, dtype=torch.float32, device=dev)
    # int64 index math: the low log2(T) bits of the products and XORs are
    # those of the JAX package's uint32 math, and masks keep only those
    res_u = torch.as_tensor(res_np + 1, dtype=torch.int64, device=dev)
    dense_ok = torch.as_tensor((res_np + 1) ** 3 <= t, device=dev)
    level_off = torch.as_tensor(level_np * t, dtype=torch.int64, device=dev)

    x = torch.clamp(x, 0.0, 1.0)
    # flat (M,) = (B*L_eff,) arrays: m = query*L_eff + level
    res_f = res_u.expand(b, l_eff).reshape(-1)
    dense_f = dense_ok.expand(b, l_eff).reshape(-1)
    off_f = level_off.expand(b, l_eff).reshape(-1)

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
        frac.append((p - c0).detach())

    # level-block subsampling of the backward scatter: one shared phase per
    # step; with fwd_level_sample it nests inside the fwd-sampled levels
    bwd_k = cfg.bwd_level_sample if stoch else 0
    phase = 0
    if bwd_k and 0 < bwd_k < l_eff:
        if l_eff % bwd_k:
            raise ValueError(
                f"bwd_level_sample={bwd_k} must divide the "
                f"{'fwd-sampled ' if fwd_k else ''}level count {l_eff}")
        phase = _draw_phase(gen, samples, "phase", l_eff // bwd_k)
    else:
        bwd_k = 0

    chosen_idx = None
    if stoch:
        # separable corner sampling: per-axis Bernoulli(frac)
        if samples is not None:
            u3 = samples["u3"]
        else:
            u3 = torch.rand((3, b * l_eff), generator=gen,
                            dtype=torch.float32, device=dev)
        bits = [(u3[c] < frac[c]).to(torch.int64) for c in range(3)]
        chosen_idx = corner_index(cell[0] + bits[0], cell[1] + bits[1],
                                  cell[2] + bits[2])

    compact = cfg.bwd_scatter_dtype if cfg.bwd_compact_scatter else None
    if stoch and cfg.stochastic_fwd:
        fr = row_stoch(rows, chosen_idx, phase, l_eff, bwd_k, t, compact,
                       cfg.fwd_gather_dtype)
    else:
        idxs, weights = [], []
        for k in range(8):
            kx, ky, kz = (k >> 2) & 1, (k >> 1) & 1, k & 1
            idxs.append(corner_index(cell[0] + kx, cell[1] + ky,
                                     cell[2] + kz))
            wx = frac[0] if kx else 1.0 - frac[0]
            wy = frac[1] if ky else 1.0 - frac[1]
            wz = frac[2] if kz else 1.0 - frac[2]
            weights.append(wx * wy * wz)
        idxs = torch.stack(idxs, 0)
        weights = torch.stack(weights, 0)
        if stoch and cfg.stochastic_bwd:
            fr = row_stoch_bwd(rows, idxs, weights, chosen_idx, phase, l_eff,
                               bwd_k, t, compact, cfg.fwd_gather_dtype)
        else:
            fr = row_weighted(rows, idxs, weights)
    fdim = cfg.n_features
    if fwd_k:
        # kept levels back into the full (B, L) layout, scaled by the
        # stride (inverse dropout); the rest zero
        z = torch.zeros((b, fwd_k, l // fwd_k, fdim), dtype=fr.dtype,
                        device=dev)
        z[:, :, fphase] = (fr * float(l // fwd_k)).reshape(b, fwd_k, fdim)
        return z.reshape(b, l * fdim)
    return fr.reshape(b, l_eff * fdim)
