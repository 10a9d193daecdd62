"""Deterministic segment sums for the bakes (the port's stand-in for the
JAX package's `.at[].add` and `jax.ops.segment_sum`, models/slf.py:73-74,
pipeline/extract_emitter.py:30-35).

`index_add_` on a CUDA tensor adds with atomics, in an order that changes
from run to run, so a bake would not give the same bits twice. Here the
rows are stably sorted by segment id and each segment is added in that
order by `torch.segment_reduce`, which on both devices runs one sequential
sum per output value for data of two or more dimensions: the order of
every addition is fixed by the ids alone, so two runs, and the CPU and the
card, give the same bits. The sum is sequential, as the JAX package's
scatter on the CPU is, but it starts from zero where the JAX package adds
into the running total, so the two agree to float rounding, not bit for
bit.
"""

from __future__ import annotations

import math

import torch


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """values (N, ...) summed into (num_segments, ...) by segment_ids (N,)
    in [0, num_segments); empty segments are zero."""
    order = torch.argsort(segment_ids, stable=True)
    # (N, 1) at the least: 1-D data would take CUDA's tree reduction
    v = values[order].reshape(values.shape[0],
                              math.prod(values.shape[1:]))
    lengths = torch.bincount(segment_ids, minlength=num_segments)
    out = torch.segment_reduce(v, "sum", lengths=lengths, axis=0)
    return out.reshape((num_segments,) + tuple(values.shape[1:]))
