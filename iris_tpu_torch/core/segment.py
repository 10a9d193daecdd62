"""Deterministic segment sums: the port's stand-in for `index_add_`, the
JAX package's `.at[].add` and `jax.ops.segment_sum` (models/slf.py:73-74,
pipeline/extract_emitter.py:30-35, and every scatter of the training
path: the hash-grid backward, the emitter radiance gradient, the gathers'
backward and the segment means of the losses).

`index_add_` on a CUDA tensor adds with atomics, in an order that changes
from run to run, so neither a bake nor a training step would give the same
bits twice. Here the rows are stably sorted by segment id and added in an
order that the ids alone fix, by `torch.segment_reduce`, which on both
devices runs one sequential sum per output value for data of two or more
dimensions: two runs give the same bits, and so do the card and the CPU.

One sequential sum per segment would leave a segment of many rows (the
queries of a training step that fall into one coarse hash-grid cell) to a
single thread, so the sum runs in two passes: runs of at most SPAN
consecutive rows of a segment first, then each segment's run sums in
order. The order differs from the JAX package's sequential scatter, so
the two agree to float rounding, not bit for bit.

Nothing here reads the device from the host: the run and segment offsets
come from binary searches of sorted ids over a bound on the run count, and
segment_reduce's checks of them (which would read the device) are skipped
as `unsafe`.
"""

from __future__ import annotations

import math

import torch

from iris_tpu_torch.utils.profiling import count, spanned

# rows one thread adds in the first pass
SPAN = 64


def _offsets(sorted_ids: torch.Tensor, n: int) -> torch.Tensor:
    """(n + 1,) start of each id 0..n-1 in ascending sorted_ids, then its
    end: the offsets of segment_reduce."""
    return torch.searchsorted(sorted_ids, torch.arange(
        n + 1, dtype=sorted_ids.dtype, device=sorted_ids.device))


def _sum(data: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    return torch.segment_reduce(data, "sum", offsets=offsets, axis=0,
                                unsafe=True)


@spanned("segment.sum")
def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """values (N, ...) summed into (num_segments, ...) by segment_ids (N,)
    in [0, num_segments); empty segments are zero. Half-precision values
    are summed in float32 and rounded once; the result keeps the values'
    dtype. The span segment.sum; the rows it sorts count as
    segment.rows."""
    n = values.shape[0]
    count("segment.rows", n)
    wide = num_segments + n // SPAN + 1 >= 2 ** 31
    idt = torch.int64 if wide else torch.int32
    sorted_ids, order = torch.sort(segment_ids.to(idt), stable=True)
    acc = torch.float32 if values.dtype in (torch.bfloat16, torch.float16) \
        else values.dtype
    # (N, 1) at the least: 1-D data would take CUDA's tree reduction
    v = values[order].reshape(n, math.prod(values.shape[1:])).to(acc)
    seg_off = _offsets(sorted_ids, num_segments)
    # pass 1: runs of at most SPAN rows, each inside one segment; at most
    # num_segments + n // SPAN of them, the rest empty
    rank = torch.arange(n, dtype=idt, device=v.device) - seg_off[
        sorted_ids.long()]
    run_id = torch.cumsum((rank % SPAN == 0).to(idt), 0, dtype=idt) - 1
    runs = _sum(v, _offsets(run_id, num_segments + n // SPAN + 1))
    # pass 2: each segment's runs, in order
    n_runs = torch.div(seg_off[1:] - seg_off[:-1] + SPAN - 1, SPAN,
                       rounding_mode="floor")
    run_off = torch.cat([torch.zeros(1, dtype=idt, device=v.device),
                         torch.cumsum(n_runs, 0, dtype=idt)])
    out = _sum(runs, run_off)
    return out.to(values.dtype).reshape(
        (num_segments,) + tuple(values.shape[1:]))
