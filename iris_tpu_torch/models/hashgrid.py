"""Multi-resolution hash-grid encoding (counterpart of
iris_tpu/models/hashgrid.py; the reference's tiny-cuda-nn HashGrid,
model/brdf.py:222-229: 32 levels x 2 features, 2^19 entries, base
resolution 16, per-level scale 1.3, which is HashGridConfig's default).

Three table modes, each with the exact 8-corner trilinear encode (what
renders run) and the stochastic-corner training estimators with explicit
backward passes:

- flat (the default): a 1-D (F*L*T,) table, feature j's level tables at
  [j*L*T, (j+1)*L*T); one 1-D gather per feature and corner, and in the
  backward one deterministic segment sum of every feature and corner
  (hashgrid.py:181-249);
- packed (packed_gather with n_features == 2, on by default): the same
  table read through a bfloat16 cast with both features of an entry in one
  32-bit word, one gather per corner, float32 accumulation and a float32
  backward (:192-211, :252-267). A render of a packed table therefore
  reads bfloat16 features;
- row (row_gather): element (level, entry, feature) at flat index
  (level*T + entry)*F + feature; the port stores the (L*T, F) row view,
  one row gather per corner (:426-568).

The output of the flat and packed modes is feature-major, (B, F*L); row
mode's is level-major and feature-minor, (B, L*F). Either is a fixed
permutation that the first MLP layer absorbs.

These are gathers, scatters and elementwise passes that the JAX package
leaves to XLA, so plain PyTorch is their port, with one exception: on the
card the exact 8-corner forward (every encode but the stochastic
forward's) is one kernel launch (csrc/hashgrid.cu through
models/cuda_hashgrid.py), which computes the cells, indices, weights and
trilinear sums in registers and writes the output once in its final
layout, bit-equal to the plain version below; a CPU tensor runs that plain
version, and a backward that needs the eight corners recomputes them with
it from the saved points. Every scatter of a backward is a segment sum
whose order the indices fix (core/segment.py), so a
training step gives the same gradient bits twice on the card, where
`index_add_` would add with atomics. Nothing in the encode reads the
device back, and nothing copies from the host once a grid's level
constants lie on the device (_level_constants): the level-block phases
are (1,) int64 tensors drawn on the device, and the level blocks they
pick are taken by device indices (index_select, index_copy_), where the
JAX package takes them by dynamic_slice. An encode can therefore be
captured in a CUDA graph (utils/graphs.py), each replay drawing its own
phases.

Randomness is explicit. The stochastic estimators draw from a
torch.Generator, or take a `samples` dict that overrides every draw:
"u3" (3, B*L_eff) corner uniforms, "phase" and "fphase" (ints or (1,)
integer tensors) the level-block phases of the backward and forward
subsampling. The parity tests replay the JAX package's key stream into
that dict.

An encode is the span hashgrid.encode and counts hashgrid.gather_bytes:
the table bytes that any encode of its mode and estimator reads (each
point's corners at each kept level, every feature at the precision the
mode reads it), whatever the gathers of this implementation read besides
(indices, materialised corners). Each backward is the span
hashgrid.encode_bwd. Each launch of the kernel counts
hashgrid.encode_kernel.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from iris_tpu_torch.core.segment import segment_sum
from iris_tpu_torch.models import cuda_hashgrid
from iris_tpu_torch.parallel.sharding import draw_uniform, rank_rows
from iris_tpu_torch.utils.profiling import count, spanned

_PRIMES = (1, 2654435761, 805459861)


@dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 32
    n_features: int = 2
    log2_table_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.3
    # Both bf16 features of an entry in one 32-bit word, so a corner costs
    # one gather instead of two (needs n_features == 2; the forward reads
    # bf16, gradients stay f32). Ignored in row mode.
    packed_gather: bool = True
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
    # feature-minor (L*T, F) rows, one row gather per corner
    row_gather: bool = False
    # The JAX package's row-mode table is 1-D unless this is set, then
    # (L*T, F); the port always holds the (L*T, F) view, and convert.py
    # hands back the layout it was given.
    row_native_layout: bool = False
    # Compact per-level-block gradient scatter: each sampled level's
    # cotangents go into their own (T, F) buffer, accumulated in
    # bwd_scatter_dtype, and the buffers are placed into the (L*T, F)
    # table cotangent. Flat and packed modes scatter each (feature, level)
    # into its own (T,) float32 block of the cotangent.
    bwd_compact_scatter: bool = True
    bwd_scatter_dtype: str = "bfloat16"
    # Forward gathers of the stochastic estimators may read a bfloat16 cast
    # of the table (master rows stay f32). Row mode only, where renders
    # always read f32.
    fwd_gather_dtype: str = "float32"
    # Packed mode: the one-corner forward gathers level block by level
    # block with local indices, bit-equal to the one global gather.
    fwd_block_gather: bool = True

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
    """Table parameters, uniform(-1e-4, 1e-4): (L*T, F) rows in row mode,
    else the flat (F*L*T,) table (hashgrid.py:160-178)."""
    n = cfg.n_levels * cfg.table_size
    shape = (n, cfg.n_features) if cfg.row_gather else (n * cfg.n_features,)
    table = torch.empty(shape, dtype=torch.float32, device=device)
    return table.uniform_(-1e-4, 1e-4, generator=gen)


# ------------------------------------------------- flat and packed lookups

def _lookup_impl(table, idxs, weights, n_features, block):
    """(F, M): per feature j, the sum over corners k of
    table[idxs[k] + j*block] * weights[k] (hashgrid.py:181-189)."""
    out = []
    for j in range(n_features):
        acc = torch.zeros(idxs.shape[1], dtype=table.dtype,
                          device=table.device)
        for k in range(idxs.shape[0]):
            acc = acc + table[idxs[k] + j * block] * weights[k]
        out.append(acc)
    return torch.stack(out, 0)


def _pack_bf16(table, block):
    """(block,) int32: entry i holds bfloat16(table[i]) in its low half and
    bfloat16(table[block + i]) in its high half, both rounded to nearest
    even as the JAX package's astype does. Packed through a (block, 2)
    bfloat16 view and unpacked the same way, so no shift ever meets the
    sign bit."""
    pair = torch.stack([table[:block].to(torch.bfloat16),
                        table[block:2 * block].to(torch.bfloat16)], 1)
    return pair.view(torch.int32).reshape(block)


def _unpack_bf16(words):
    """(M,) int32 words -> the two float32 features (M,), (M,)."""
    pair = words.view(torch.bfloat16).reshape(-1, 2).to(torch.float32)
    return pair[:, 0], pair[:, 1]


def _lookup_packed_impl(table, idxs, weights, block):
    """_lookup_impl for two features read from the packed bf16 words: one
    gather per corner, float32 accumulation (hashgrid.py:192-211)."""
    return _lookup_words(_pack_bf16(table, block), idxs, weights)


def _lookup_words(packed, idxs, weights):
    """(2, M): the packed words' two features summed over the corners."""
    m = idxs.shape[1]
    acc0 = torch.zeros(m, dtype=torch.float32, device=packed.device)
    acc1 = torch.zeros(m, dtype=torch.float32, device=packed.device)
    for k in range(idxs.shape[0]):
        g0, g1 = _unpack_bf16(packed[idxs[k]])
        acc0 = acc0 + g0 * weights[k]
        acc1 = acc1 + g1 * weights[k]
    return torch.stack([acc0, acc1], 0)


def _phase_index(phase, device) -> torch.Tensor:
    """A level-block phase as the (1,) int64 device index that selects it:
    a tensor drawn on the device stays there, a host integer (a replayed
    JAX draw, a test's phase) is filled in on the device, not copied."""
    if isinstance(phase, torch.Tensor):
        return phase.reshape(1).to(device=device, dtype=torch.int64)
    return torch.full((1,), int(phase), dtype=torch.int64, device=device)


def _take_phase(a, b, bwd_k, stride, phase):
    """The phase column of the strided level blocks: a (b*bwd_k*stride,
    ...) flat array viewed (b, bwd_k, stride, ...), index `phase` of axis
    2, back to (b*bwd_k, ...)."""
    tail = tuple(a.shape[1:])
    return a.reshape((b, bwd_k, stride) + tail).index_select(2, phase) \
        .reshape((b * bwd_k,) + tail)


def _scatter_chosen(g, chosen_idx, phase, n_features, block, tsize,
                    levels=0, bwd_k=0, tbl=0, compact=False):
    """(F, M) cotangent -> flat (tsize,) = (F*block,) table cotangent by
    ONE segment sum of every feature at the sampled corner
    (hashgrid.py:272-324).

    With 0 < bwd_k < levels: strided level-block subsampling. Flat
    m = q*levels + lvl with lvl = j*stride + r; keep r == phase (an int
    or a (1,) device tensor), scale by stride. With `compact`, tbl <
    block and at most 32 (slot, feature) pairs: each kept level's
    cotangents are scattered with local indices into that (feature,
    level)'s own (tbl,) block of the cotangent; otherwise one scatter per
    feature over the whole table. Every index of one slot column shares a
    level block, so a slot's block is its first index // tbl, read on the
    device as the JAX package reads it (idx2[0, s] // tbl), and the slots'
    sums are placed by one index_copy_. All slots share one segment
    sum."""
    cols = torch.stack([g[j] for j in range(g.shape[0])], 1)
    k_slots = levels or 1
    if bwd_k and levels and bwd_k < levels:
        stride = levels // bwd_k
        b = chosen_idx.shape[0] // levels
        ph = _phase_index(phase, g.device)
        chosen_idx = _take_phase(chosen_idx, b, bwd_k, stride, ph)
        cols = _take_phase(cols, b, bwd_k, stride, ph) * float(stride)
        k_slots = bwd_k
    nf = cols.shape[1]
    if not (compact and 0 < tbl < block and k_slots * nf <= 32):
        # (block, F) sums, feature-major as the table
        return segment_sum(cols, chosen_idx, block).t().reshape(tsize)
    acc = torch.zeros(tsize, dtype=cols.dtype, device=cols.device)
    b = chosen_idx.shape[0] // k_slots
    if b == 0:
        return acc
    idx2 = chosen_idx.reshape(b, k_slots)
    # every slot's local indices in one sum, slot s at [s*tbl, (s+1)*tbl)
    slot_key = (idx2 & (tbl - 1)) + torch.arange(
        k_slots, device=chosen_idx.device) * tbl
    sums = segment_sum(cols, slot_key.reshape(-1),
                       k_slots * tbl).reshape(k_slots, tbl, nf)
    acc.view(nf, block // tbl, tbl).index_copy_(
        1, idx2[0] // tbl, sums.permute(2, 0, 1))
    return acc


def _stoch_gather_impl(table, chosen_idx, n_features, block, packed,
                       levels=0, tbl=0, fwd_block=False):
    """(F, M): every feature at the one sampled corner
    (hashgrid.py:361-393). Packed with fwd_block: each column of the
    (B, levels) view (flat m = q*levels + lvl: a column shares a level
    block) is read from its (tbl,) level block with local indices, the
    block found on the device from the column's first index, as the JAX
    package finds it; bit-equal to the global gather."""
    m = chosen_idx.shape[0]
    if not packed:
        return torch.stack([table[chosen_idx + j * block]
                            for j in range(n_features)], 0)
    packed_t = _pack_bf16(table, block)
    if (fwd_block and levels and 0 < tbl < block and levels <= 32
            and m % levels == 0):
        idx2 = chosen_idx.reshape(m // levels, levels)
        lvl = idx2[:1] // tbl                               # (1, levels)
        words = packed_t.view(block // tbl, tbl)[lvl, idx2 - lvl * tbl] \
            .reshape(-1)
    else:
        words = packed_t[chosen_idx]
    return torch.stack(_unpack_bf16(words), 0)


def _flat_bwd(g, idxs, weights, n_features, block, tsize):
    """Exact cotangent (_weighted_lookup_bwd, hashgrid.py:234-246): g (F,
    M) times each corner's weight, summed into the (block, F) entries in
    corner-major order by one segment sum, laid out feature-major."""
    rows = (weights[:, :, None] * g.t()[None]).reshape(-1, n_features)
    return segment_sum(rows, idxs.reshape(-1), block).t().reshape(tsize)


class _WeightedLookup(torch.autograd.Function):
    """Exact 8-corner weighted lookup, flat or packed, with the exact
    float32 backward (_weighted_lookup_p and _weighted_lookup_packed_p,
    hashgrid.py:224-267)."""

    @staticmethod
    def forward(ctx, table, idxs, weights, n_features, block, packed):
        ctx.save_for_backward(idxs, weights)
        ctx.args = (n_features, block, table.shape[0])
        if packed:
            return _lookup_packed_impl(table, idxs, weights, block)
        return _lookup_impl(table, idxs, weights, n_features, block)

    @staticmethod
    @spanned("hashgrid.encode_bwd")
    def backward(ctx, g):
        idxs, weights = ctx.saved_tensors
        return (_flat_bwd(g, idxs, weights, *ctx.args),) + (None,) * 5


class _LookupStochBwd(torch.autograd.Function):
    """Exact forward, stochastic backward: the cotangent goes to the one
    sampled corner (_lookup_stoch_bwd_p, hashgrid.py:327-358)."""

    @staticmethod
    def forward(ctx, table, idxs, weights, chosen_idx, phase, n_features,
                block, packed, levels, bwd_k, tbl, compact):
        ctx.save_for_backward(chosen_idx)
        ctx.args = (phase, n_features, block, table.shape[0], levels, bwd_k,
                    tbl, compact)
        if packed:
            return _lookup_packed_impl(table, idxs, weights, block)
        return _lookup_impl(table, idxs, weights, n_features, block)

    @staticmethod
    @spanned("hashgrid.encode_bwd")
    def backward(ctx, g):
        (chosen_idx,) = ctx.saved_tensors
        return (_scatter_chosen(g, chosen_idx, *ctx.args),) + (None,) * 11


class _StochLookup(torch.autograd.Function):
    """Stochastic forward and backward: one gather and one scatter per
    feature at the sampled corner (_stoch_lookup_p, hashgrid.py:396-420)."""

    @staticmethod
    def forward(ctx, table, chosen_idx, phase, n_features, block, packed,
                levels, bwd_k, tbl, compact, fwd_block):
        ctx.save_for_backward(chosen_idx)
        ctx.args = (phase, n_features, block, table.shape[0], levels, bwd_k,
                    tbl, compact)
        return _stoch_gather_impl(table, chosen_idx, n_features, block,
                                  packed, levels, tbl, fwd_block)

    @staticmethod
    @spanned("hashgrid.encode_bwd")
    def backward(ctx, g):
        (chosen_idx,) = ctx.saved_tensors
        return (_scatter_chosen(g, chosen_idx, *ctx.args),) + (None,) * 10


def weighted_lookup(table, idxs, weights, n_features: int, block: int):
    return _WeightedLookup.apply(table, idxs, weights, n_features, block,
                                 False)


def weighted_lookup_packed(table, idxs, weights, block: int):
    return _WeightedLookup.apply(table, idxs, weights, 2, block, True)


def lookup_stoch_bwd(table, idxs, weights, chosen_idx, phase, n_features,
                     block, packed, levels, bwd_k, tbl=0, compact=False):
    return _LookupStochBwd.apply(
        table, idxs, weights, chosen_idx, phase, n_features, block, packed,
        levels, bwd_k, tbl, compact)


def stoch_lookup(table, chosen_idx, phase, n_features, block, packed, levels,
                 bwd_k, tbl=0, compact=False, fwd_block=False):
    return _StochLookup.apply(
        table, chosen_idx, phase, n_features, block, packed, levels, bwd_k,
        tbl, compact, fwd_block)


# ---------------------------------------------------------- row-mode lookups

def _row_scatter_chosen(g_rows, chosen_idx, phase, lt, levels, bwd_k,
                        tsize=0, compact=None):
    """(M, F) cotangent -> (L*T, F) table cotangent by ONE row segment sum
    at the sampled corner rows (hashgrid.py:426-472).

    With 0 < bwd_k < levels: strided level-block subsampling. Flat
    m = q*levels + lvl with lvl = j*stride + r; keep r == phase (an int or
    a (1,) device tensor) and scale by stride. With `compact` ("bfloat16"
    or "float32"), tsize < lt and at most 16 slots: each kept level's rows
    go into a (tsize, F) buffer of that dtype (every index of one slot
    column shares a level block), all slots in one segment sum, and the
    buffers are placed into the full cotangent; otherwise one segment sum
    into the full table."""
    f = g_rows.shape[1]
    k_slots = levels or 1
    if bwd_k and levels and bwd_k < levels:
        stride = levels // bwd_k
        b = chosen_idx.shape[0] // levels
        ph = _phase_index(phase, g_rows.device)
        chosen_idx = _take_phase(chosen_idx, b, bwd_k, stride, ph)
        g_rows = _take_phase(g_rows, b, bwd_k, stride, ph) * float(stride)
        k_slots = bwd_k
    if not (compact and 0 < tsize < lt and k_slots <= 16):
        return segment_sum(g_rows, chosen_idx, lt)
    full = torch.zeros((lt, f), dtype=g_rows.dtype, device=g_rows.device)
    out_dtype = g_rows.dtype
    acc_dtype = torch.bfloat16 if compact == "bfloat16" else out_dtype
    b = chosen_idx.shape[0] // k_slots
    if b == 0:
        return full
    idx2 = chosen_idx.reshape(b, k_slots)
    # every slot's local rows in one sum, slot j at [j*tsize, (j+1)*tsize)
    slot_key = (idx2 & (tsize - 1)) + torch.arange(
        k_slots, device=idx2.device) * tsize
    bufs = segment_sum(g_rows.to(acc_dtype), slot_key.reshape(-1),
                       k_slots * tsize).reshape(k_slots, tsize, f)
    # each slot's level block, uniform over the slot's column, placed by a
    # device-side index: no host read of the block ids
    full.view(lt // tsize, tsize, f).index_copy_(0, idx2[0] // tsize,
                                                 bufs.to(out_dtype))
    return full


def _row_cast(rows, gdtype):
    """Mixed-precision forward reads (cfg.fwd_gather_dtype)."""
    if gdtype == "bfloat16" and rows.dtype != torch.bfloat16:
        return rows.to(torch.bfloat16)
    return rows


def _row_bwd(g, idxs, weights, lt):
    """Exact cotangent of the row lookup: g (M, F) times each corner's
    weight, every corner's rows in one corner-major segment sum."""
    rows = (weights[:, :, None] * g[None]).reshape(-1, g.shape[1])
    return segment_sum(rows, idxs.reshape(-1), lt)


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
    @spanned("hashgrid.encode_bwd")
    def backward(ctx, g):
        idxs, weights = ctx.saved_tensors
        return _row_bwd(g, idxs, weights, ctx.lt), None, None


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
    @spanned("hashgrid.encode_bwd")
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
    @spanned("hashgrid.encode_bwd")
    def backward(ctx, g):
        (chosen_idx,) = ctx.saved_tensors
        phase, lt, levels, bwd_k, tsize, compact = ctx.args
        return (_row_scatter_chosen(g, chosen_idx, phase, lt, levels, bwd_k,
                                    tsize, compact),) + (None,) * 7


def row_weighted(rows, idxs, weights):
    return _RowWeighted.apply(rows, idxs, weights)


def row_stoch_bwd(rows, idxs, weights, chosen_idx, phase, levels, bwd_k,
                  tsize=0, compact=None, gdtype=None):
    return _RowStochBwd.apply(rows, idxs, weights, chosen_idx, phase,
                              levels, bwd_k, tsize, compact, gdtype)


def row_stoch(rows, chosen_idx, phase, levels, bwd_k, tsize=0, compact=None,
              gdtype=None):
    return _RowStoch.apply(rows, chosen_idx, phase, levels, bwd_k, tsize,
                           compact, gdtype)


def _draw_phase(gen, samples, name, n, dev) -> torch.Tensor:
    """One level-block phase in [0, n) as a (1,) int64 tensor on `dev`,
    drawn on the generator's device (jax.random.randint at hashgrid.py:621
    and :671): it selects level blocks by device index and is never read
    by the host, so a captured step draws a fresh phase at every replay.
    samples[name] (an int or a tensor) replaces the draw."""
    if samples is not None:
        return _phase_index(samples[name], dev)
    return torch.randint(0, n, (1,), generator=gen, device=gen.device).to(dev)


@functools.lru_cache(maxsize=32)
def _level_constants(cfg: HashGridConfig, dev: torch.device):
    """(resolution f32, resolution + 1 i64, dense-level mask, level ids
    i64), each (L,) on `dev`: copied from the host once per grid and
    device, on the first encode (an eager call, before any capture), and
    shared, never written, by every encode after it."""
    res = cfg.resolutions()
    return (torch.as_tensor(res, dtype=torch.float32, device=dev),
            torch.as_tensor(res + 1, dtype=torch.int64, device=dev),
            torch.as_tensor((res + 1) ** 3 <= cfg.table_size, device=dev),
            torch.arange(cfg.n_levels, dtype=torch.int64, device=dev))


@spanned("hashgrid.encode")
def hashgrid_encode(table: torch.Tensor, cfg: HashGridConfig,
                    x: torch.Tensor, gen: torch.Generator | None = None,
                    samples: dict | None = None) -> torch.Tensor:
    """Encode positions x (B, 3) in [0,1]^3 -> features: (B, F*L)
    feature-major in the flat and packed modes, (B, L*F) level-major in
    row mode (hashgrid.py:571-780). `table` is the flat (F*L*T,) table, or
    in row mode the (L*T, F) rows (a flat row-mode table is viewed so).

    With `gen` or `samples` and cfg.stochastic_{bwd,fwd} it runs the
    unbiased stochastic-corner estimators; with neither, the exact encode
    (what renders use). `samples` overrides the draws: "u3"
    (3, B*L_eff), "phase", "fphase". The span hashgrid.encode."""
    if cfg.row_gather:
        rows = table if table.dim() == 2 else table.reshape(
            cfg.n_levels * cfg.table_size, cfg.n_features)
    elif table.dim() != 1:
        raise ValueError(
            f"a table of shape {tuple(table.shape)} needs row_gather: the "
            "flat and packed modes read a 1-D (F*L*T,) table")
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

    res, res_u, dense_ok, level_ids = _level_constants(cfg, dev)
    if cfg.fwd_level_sample and keyed and not cfg.stochastic_fwd:
        raise ValueError("fwd_level_sample requires stochastic_fwd")
    fwd_k = cfg.fwd_level_sample if (stoch and cfg.stochastic_fwd) else 0
    fphase = None
    if fwd_k and 0 < fwd_k < l:
        if l % fwd_k:
            raise ValueError(
                f"fwd_level_sample={fwd_k} must divide n_levels={l}")
        fstride = l // fwd_k
        fphase = _draw_phase(gen, samples, "fphase", fstride, dev)
        # take every per-level array down to the sampled levels first, so
        # the index math, corner sampling and gather all shrink by the
        # stride
        res, res_u, dense_ok, level_ids = (
            a.reshape(fwd_k, fstride).index_select(1, fphase).reshape(fwd_k)
            for a in (res, res_u, dense_ok, level_ids))
        l_eff = fwd_k
    else:
        fwd_k = 0
        l_eff = l

    # On the card the exact 8-corner forward is one kernel launch, which
    # builds none of the plain index arrays; only the stochastic corner
    # needs them there
    kernel = _kernel_runs(x) and not (stoch and cfg.stochastic_fwd)

    def cells(x):
        return _cells(x, res, res_u, dense_ok, level_ids, t, l)

    plain = cells(x) if stoch or not kernel else None

    # level-block subsampling of the backward scatter: one shared phase per
    # step; with fwd_level_sample it nests inside the fwd-sampled levels
    bwd_k = cfg.bwd_level_sample if stoch else 0
    phase = 0
    if bwd_k and 0 < bwd_k < l_eff:
        if l_eff % bwd_k:
            raise ValueError(
                f"bwd_level_sample={bwd_k} must divide the "
                f"{'fwd-sampled ' if fwd_k else ''}level count {l_eff}")
        phase = _draw_phase(gen, samples, "phase", l_eff // bwd_k, dev)
    else:
        bwd_k = 0

    chosen_idx = None
    if stoch:
        corner_index, cell, frac = plain
        # separable corner sampling: per-axis Bernoulli(frac)
        # the flat index is query-major (m = query*L_eff + level), so a
        # data-parallel rank's queries are a contiguous run of axis 1
        if samples is not None:
            u3 = rank_rows(samples["u3"], gen, 1)
        else:
            u3 = draw_uniform(gen, (3, b * l_eff), dev, axis=1)
        bits = [(u3[c] < frac[c]).to(torch.int64) for c in range(3)]
        chosen_idx = corner_index(cell[0] + bits[0], cell[1] + bits[1],
                                  cell[2] + bits[2])

    fdim = cfg.n_features
    # one corner a point and level under the stochastic forward, else
    # eight; bfloat16 features where the mode reads them so
    half = (stoch and cfg.fwd_gather_dtype == "bfloat16" if cfg.row_gather
            else cfg.packed_gather and fdim == 2)
    count("hashgrid.gather_bytes",
          (1 if stoch and cfg.stochastic_fwd else 8) * b * l_eff * fdim
          * (2 if half else table.element_size()))
    if kernel:
        # the row modes read bfloat16 only under the stochastic backward,
        # as _RowStochBwd does
        gdtype = (cfg.fwd_gather_dtype if stoch and cfg.stochastic_bwd
                  else None)
        return _KernelEncode.apply(rows if cfg.row_gather else table, x, cfg,
                                   chosen_idx, phase, bwd_k, gdtype,
                                   lambda x: _corners(*cells(x)))
    if not cfg.row_gather:
        return _encode_flat(table, cfg, b, l, l_eff, fwd_k, fphase, bwd_k,
                            phase, stoch, chosen_idx,
                            lambda: _corners(*plain))
    compact = cfg.bwd_scatter_dtype if cfg.bwd_compact_scatter else None
    if stoch and cfg.stochastic_fwd:
        fr = row_stoch(rows, chosen_idx, phase, l_eff, bwd_k, t, compact,
                       cfg.fwd_gather_dtype)
    else:
        idxs, weights = _corners(*plain)
        if stoch and cfg.stochastic_bwd:
            fr = row_stoch_bwd(rows, idxs, weights, chosen_idx, phase, l_eff,
                               bwd_k, t, compact, cfg.fwd_gather_dtype)
        else:
            fr = row_weighted(rows, idxs, weights)
    if fwd_k:
        # kept levels back into the full (B, L) layout, scaled by the
        # stride (inverse dropout); the rest zero
        z = torch.zeros((b, fwd_k, l // fwd_k, fdim), dtype=fr.dtype,
                        device=dev).index_copy(
            2, fphase, (fr * float(l // fwd_k)).reshape(b, fwd_k, 1, fdim))
        return z.reshape(b, l * fdim)
    return fr.reshape(b, l_eff * fdim)


def _kernel_runs(x) -> bool:
    """Whether an exact forward of points x runs as the kernel: on the
    card."""
    return x.device.type == "cuda"


def _cells(x, res, res_u, dense_ok, level_ids, t, l):
    """The plain index math at the levels of the (L_eff,) constants:
    (corner_index, cell, frac), cell and frac three flat (M,) = (B*L_eff,)
    arrays, m = query*L_eff + level, and corner_index the table index of
    a corner's cells. int64: the low log2(T) bits of the products and XORs
    are those of the JAX package's uint32 math, and masks keep only
    those."""
    b, l_eff = x.shape[0], res.shape[0]
    level_off = level_ids * t
    x = torch.clamp(x, 0.0, 1.0)
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
    return corner_index, cell, frac


class _KernelEncode(torch.autograd.Function):
    """The exact 8-corner forward as one kernel launch on the card
    (cuda_hashgrid.encode), in the mode's final layout: (B, F*L) or, in row
    mode, (B, L*F). The backward is the plain version's: with chosen_idx
    the stochastic estimators' one-corner scatter (_LookupStochBwd,
    _RowStochBwd), else the exact scatter to all eight corners
    (_WeightedLookup, _RowWeighted), whose indices and weights
    `corners(x)` recomputes from the saved points with the plain index
    math."""

    @staticmethod
    def forward(ctx, table, x, cfg, chosen_idx, phase, bwd_k, gdtype,
                corners):
        ctx.save_for_backward(chosen_idx, x)
        ctx.args = (cfg, phase, bwd_k, corners, table.shape[0])
        l, t, nf = cfg.n_levels, cfg.table_size, cfg.n_features
        if cfg.row_gather:
            mode = "rows_bf16" if gdtype == "bfloat16" else "rows"
        elif cfg.packed_gather and nf == 2:
            mode, table = "packed", cuda_hashgrid.pack(table, l * t)
        else:
            mode = "flat"
        return cuda_hashgrid.encode(
            table, x.contiguous(), _level_constants(cfg, x.device)[:3], mode,
            l, nf, cfg.log2_table_size)

    @staticmethod
    @spanned("hashgrid.encode_bwd")
    def backward(ctx, g):
        chosen_idx, x = ctx.saved_tensors
        cfg, phase, bwd_k, corners, n = ctx.args
        l, t, nf, b = cfg.n_levels, cfg.table_size, cfg.n_features, x.shape[0]
        if cfg.row_gather:
            g = g.reshape(b * l, nf)
            if chosen_idx is None:
                d = _row_bwd(g, *corners(x), n)
            else:
                d = _row_scatter_chosen(
                    g, chosen_idx, phase, n, l, bwd_k, t,
                    cfg.bwd_scatter_dtype if cfg.bwd_compact_scatter
                    else None)
        else:
            # (B, F*L) -> the plain lookups' (F, M)
            g = g.reshape(b, nf, l).transpose(0, 1).reshape(nf, b * l)
            if chosen_idx is None:
                d = _flat_bwd(g, *corners(x), nf, l * t, n)
            else:
                d = _scatter_chosen(g, chosen_idx, phase, nf, l * t, n, l,
                                    bwd_k, t, cfg.bwd_compact_scatter)
        return (d,) + (None,) * 7


def _corners(corner_index, cell, frac):
    """The eight corners' table indices (8, M) and trilinear weights."""
    idxs, weights = [], []
    for k in range(8):
        kx, ky, kz = (k >> 2) & 1, (k >> 1) & 1, k & 1
        idxs.append(corner_index(cell[0] + kx, cell[1] + ky, cell[2] + kz))
        wx = frac[0] if kx else 1.0 - frac[0]
        wy = frac[1] if ky else 1.0 - frac[1]
        wz = frac[2] if kz else 1.0 - frac[2]
        weights.append(wx * wy * wz)
    return torch.stack(idxs, 0), torch.stack(weights, 0)


def _encode_flat(table, cfg, b, l, l_eff, fwd_k, fphase, bwd_k, phase,
                 stoch, chosen_idx, corners):
    """The lookups and output order of the flat and packed modes
    (hashgrid.py:693-708, 739-749, 762-780)."""
    t = cfg.table_size
    blk = l * t
    nf = cfg.n_features
    packed = cfg.packed_gather and nf == 2
    if stoch and cfg.stochastic_fwd:
        # one gather and (in the backward) one scatter per feature at the
        # sampled corner; the 8-corner arrays are never built
        feats = stoch_lookup(table, chosen_idx, phase, nf, blk, packed,
                             l_eff, bwd_k, t, cfg.bwd_compact_scatter,
                             cfg.fwd_block_gather)
    else:
        idxs, weights = corners()
        if stoch and cfg.stochastic_bwd:
            feats = lookup_stoch_bwd(table, idxs, weights, chosen_idx, phase,
                                     nf, blk, packed, l_eff, bwd_k, t,
                                     cfg.bwd_compact_scatter)
        elif packed:
            feats = weighted_lookup_packed(table, idxs, weights, blk)
        else:
            feats = weighted_lookup(table, idxs, weights, nf, blk)
    # (F, B*L_eff) -> (B, F*L), feature-major
    if fwd_k:
        # each feature's kept levels back into its (B, L) columns, scaled
        # by the stride (inverse dropout); the rest zero
        z = torch.zeros((nf, b, fwd_k, l // fwd_k), dtype=feats.dtype,
                        device=feats.device).index_copy(
            3, fphase, (feats * float(l // fwd_k)).reshape(nf, b, fwd_k, 1))
        return z.reshape(nf, b, l).permute(1, 0, 2).reshape(b, nf * l)
    return feats.reshape(nf, b, l).permute(1, 0, 2).reshape(b, nf * l)
