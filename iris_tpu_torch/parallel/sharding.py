"""Data-parallel sharding over rays (counterpart of
iris_tpu/parallel/sharding.py).

The workload is parallel over the ray batch. The JAX package shards axis 0
of one logical global batch over a ('data',) mesh and lets GSPMD insert the
collectives. The port has no mesh: each rank of a RankGroup
(parallel/distributed.py) is one process on one device, and takes the
contiguous rows [r*B/N, (r+1)*B/N) of the global batch, the split that
GSPMD's P("data") makes.

Random draws follow the same split. A rank's generator is a RankGenerator:
every rank seeds it alike, and a per-ray draw is made at the GLOBAL batch's
shape, of which the rank keeps its own rows (draw_uniform with a row
axis). So every rank's generator advances alike, and each ray gets the
numbers one process would draw for it on the whole batch. The draws cost N
times their work on each rank, which is small beside the traversal.
"""

from __future__ import annotations

import numpy as np
import torch


class RankGenerator(torch.Generator):
    """A torch.Generator of rank `rank` of `world_size`: draw_uniform and
    rank_rows read these two to take the rank's rows of a per-ray draw.
    With world_size 1 it draws what a plain generator draws."""

    def __new__(cls, device, rank: int, world_size: int):
        return super().__new__(cls, device)

    def __init__(self, device, rank: int, world_size: int):
        self.rank, self.world_size = int(rank), int(world_size)


def rank_rows(x, gen, axis: int = 0):
    """The rank's rows of `x` along `axis`, where x holds the rows of every
    rank of gen (a RankGenerator); x itself for any other generator or
    None. A replayed draw (the `samples` hook) comes at the global shape
    and goes through here."""
    n = getattr(gen, "world_size", 1)
    if n == 1:
        return x
    m = x.shape[axis] // n
    return x.narrow(axis, gen.rank * m, m)


def draw_uniform(gen: torch.Generator | None, shape, dev, lo=0.0, hi=1.0,
                 axis: int | None = None):
    """Uniform f32 draws in [lo, hi) from `gen`. `axis` names the ray axis
    of a per-ray draw: under a RankGenerator of N ranks the draw is made
    with that axis N times longer and the rank's rows are returned. With
    axis None (a draw every rank makes whole) or any other generator, the
    draw has `shape`."""
    n = getattr(gen, "world_size", 1)
    full = list(shape)
    if axis is not None:
        full[axis] *= n
    u = torch.rand(full, generator=gen, dtype=torch.float32, device=dev)
    if (lo, hi) != (0.0, 1.0):
        u = u * (hi - lo) + lo
    return u if axis is None else rank_rows(u, gen, axis)


def shard_rows(x, group):
    """The rank's contiguous rows [r*B/N, (r+1)*B/N) of a global batch: a
    numpy array or tensor, or a dict of them (None stays None). `group`
    None is one process: x itself. B must be a multiple of N
    (pipeline.common.mesh_batch_size rounds it so)."""
    if group is None:
        return x
    if isinstance(x, dict):
        return {k: shard_rows(v, group) for k, v in x.items()}
    if x is None:
        return None
    b, n = x.shape[0], group.world_size
    if b % n:
        raise ValueError(f"a batch of {b} rows does not split over {n} "
                         "ranks")
    m = b // n
    return x[group.rank * m:(group.rank + 1) * m]


def pad_to_multiple(x, m: int, axis: int = 0):
    """Pad axis to a multiple of m by repeating the edge (batch
    divisibility for sharding). Returns (padded, original_size)."""
    n = x.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(np.asarray(x), widths, mode="edge"), n


def host_shard_indices(n_total: int, batch_size: int, seed: int, step: int,
                       group):
    """The rank's pixel indices of step `step`: a permutation of n_total
    drawn from (seed, step), alike on every rank, of which each rank takes
    its contiguous batch_size // N (the JAX package draws the permutation
    from fold_in(key, step); the streams differ). Across the ranks the
    slices are disjoint and together the first (batch_size // N) * N
    entries of the permutation."""
    perm = np.random.default_rng((int(seed), int(step))).permutation(
        n_total)
    rank, n = (0, 1) if group is None else (group.rank, group.world_size)
    per = batch_size // n
    return perm[rank * per:(rank + 1) * per]
