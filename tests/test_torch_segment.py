"""The training path's deterministic scatters (core/segment.segment_sum in
place of index_add_, which on the card adds with atomics in an order that
changes run to run; tests/test_torch_cuda.py holds the card to the same
bits twice). segment_sum adds in an order the ids alone fix: runs of at
most SPAN consecutive rows of a segment, then the runs in order; the tests
hold it bit for bit to that order written out in Python, and to float64
sums within 1e-6 relative. Where every segment is at most SPAN rows long
(the scatters below at these shapes) a segment is one run, added in its
rows' order from zero: the bits of index_add_ on the CPU."""

import numpy as np
import pytest
import torch

from iris_tpu_torch.core.segment import SPAN, segment_sum
from iris_tpu_torch.models import hashgrid as H
from iris_tpu_torch.models.emitter import radiance_rows
from iris_tpu_torch.train.steps import _gather1d
from iris_tpu_torch.utils.losses import segment_mean


def _ids(n, k, seed):
    return torch.randint(0, k, (n,), generator=torch.Generator().manual_seed(
        seed))


def _in_order(v, ids, k):
    """segment_sum's order, one addition at a time in float32."""
    v = v.float().reshape(v.shape[0], -1).numpy()
    out = np.zeros((k, v.shape[1]), np.float32)
    for s in range(k):
        rows = v[np.flatnonzero(ids.numpy() == s)]
        total = np.zeros(v.shape[1], np.float32)
        for lo in range(0, len(rows), SPAN):
            run = np.zeros(v.shape[1], np.float32)
            for r in rows[lo:lo + SPAN]:
                run = run + r
            total = total + run
        out[s] = total
    return out


@pytest.mark.parametrize("shape,dtype", [((3000,), torch.float32),
                                         ((3000, 3), torch.float32),
                                         ((3000, 16), torch.bfloat16),
                                         ((3000, 2, 3), torch.float32)])
def test_segment_sum_order(shape, dtype):
    """Runs of SPAN rows, then the runs: bit for bit; float64 within 1e-6
    relative (bf16: the float32 sum rounded once to bf16)."""
    gen = torch.Generator().manual_seed(1)
    v = torch.randn(shape, generator=gen).to(dtype)
    ids = _ids(shape[0], 17, 2)
    ids[:400] = 3                    # a segment of many runs
    got = segment_sum(v, ids, 20)
    assert got.dtype == dtype and got.shape == (20,) + shape[1:]
    want = torch.from_numpy(_in_order(v, ids, 20)).to(dtype)
    assert torch.equal(got.reshape(20, -1), want)
    exact = torch.zeros((20,) + shape[1:], dtype=torch.float64).index_add_(
        0, ids, v.double())
    tol = 1e-6 if dtype == torch.float32 else 2 ** -8
    assert torch.allclose(got.double(), exact, rtol=tol, atol=1e-5)
    assert torch.equal(segment_sum(v[:0], ids[:0], 4),
                       torch.zeros((4,) + shape[1:], dtype=dtype))


def test_short_segments_are_index_add():
    gen = torch.Generator().manual_seed(3)
    v = torch.randn(3000, 4, generator=gen)
    ids = _ids(3000, 1000, 4)
    assert int(torch.bincount(ids).max()) <= SPAN
    assert torch.equal(segment_sum(v, ids, 1000),
                       torch.zeros(1000, 4).index_add_(0, ids, v))


LEVELS, TSIZE, B = 8, 1024, 700


def _chosen():
    lvl = torch.arange(LEVELS).repeat(B)
    return lvl * TSIZE + _ids(B * LEVELS, TSIZE, 3)


@pytest.mark.parametrize("bwd_k,compact", [(0, None), (2, "bfloat16"),
                                           (2, "float32"), (4, "bfloat16")])
def test_row_scatter_is_index_add(bwd_k, compact):
    """The row-mode stochastic backward, whole table or compact level
    blocks (several slots in one segment sum)."""
    chosen = _chosen()
    g = torch.randn(B * LEVELS, 16, generator=torch.Generator().manual_seed(4))
    lt, phase = LEVELS * TSIZE, 1
    got = H._row_scatter_chosen(g, chosen, phase, lt, LEVELS, bwd_k, TSIZE,
                                compact)
    ci, gr, k = chosen, g, LEVELS
    if bwd_k:
        stride, k = LEVELS // bwd_k, bwd_k
        ci = chosen.reshape(B, k, stride)[:, :, phase].reshape(-1)
        gr = g.reshape(B, k, stride, 16)[:, :, phase].reshape(-1, 16) \
            * float(stride)
    want = torch.zeros(lt, 16)
    if compact is None:
        want.index_add_(0, ci, gr)
    else:
        acc = torch.bfloat16 if compact == "bfloat16" else torch.float32
        for j in range(k):
            idx = ci.reshape(B, k)[:, j]
            buf = torch.zeros(TSIZE, 16, dtype=acc).index_add_(
                0, idx & (TSIZE - 1), gr.to(acc).reshape(B, k, 16)[:, j])
            want.view(LEVELS, TSIZE, 16)[idx[0] // TSIZE] = buf.float()
    assert torch.equal(got, want)


@pytest.mark.parametrize("compact", [False, True])
def test_flat_scatter_is_index_add(compact):
    """The flat table's stochastic backward (2 features, 2 of 8 level
    blocks), one segment sum for every feature and slot."""
    chosen, block, phase = _chosen(), LEVELS * TSIZE, 2
    g = torch.randn(2, B * LEVELS, generator=torch.Generator().manual_seed(5))
    got = H._scatter_chosen(g, chosen, phase, 2, block, 2 * block, LEVELS, 2,
                            TSIZE if compact else 0, compact)
    stride = LEVELS // 2
    ci = chosen.reshape(B, 2, stride)[:, :, phase].reshape(-1)
    cols = [c.reshape(B, 2, stride)[:, :, phase].reshape(-1) * float(stride)
            for c in g]
    want = torch.zeros(2 * block)
    if not compact:
        for j, c in enumerate(cols):
            want.index_add_(0, ci + j * block, c)
    else:
        for s in range(2):
            local = ci.reshape(B, 2)[:, s] & (TSIZE - 1)
            base = (s * stride + phase) * TSIZE
            for j, c in enumerate(cols):
                want[base + j * block:base + j * block + TSIZE].index_add_(
                    0, local, c.reshape(B, 2)[:, s])
    assert torch.equal(got, want)


@pytest.mark.parametrize("row", [False, True])
def test_exact_backward_is_index_add(row):
    """The exact 8-corner encode's backward, corner-major as index_add_
    per feature and corner."""
    gen = torch.Generator().manual_seed(6)
    m = 900
    idxs = torch.randint(0, TSIZE, (8, m), generator=gen)
    w = torch.rand(8, m, generator=gen)
    if row:
        g = torch.randn(m, 4, generator=gen)
        table = torch.randn(TSIZE, 4, requires_grad=True)
        (got,) = torch.autograd.grad(H.row_weighted(table, idxs, w), table, g)
        want = torch.zeros(TSIZE, 4)
        for k in range(8):
            want.index_add_(0, idxs[k], g * w[k][:, None])
    else:
        g = torch.randn(2, m, generator=gen)
        got = H._flat_bwd(g, idxs, w, 2, TSIZE, 2 * TSIZE)
        want = torch.zeros(2 * TSIZE)
        for j in range(2):
            for k in range(8):
                want.index_add_(0, idxs[k] + j * TSIZE, g[j] * w[k])
    assert torch.equal(got, want)


def test_gathers_backward_is_index_add():
    """The propagation loss's partner gather and the emitter radiance rows
    past 256 emitters."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(300, requires_grad=True)
    idx = torch.randint(0, 300, (5000,), generator=gen)
    g = torch.randn(5000, generator=gen)
    (got,) = torch.autograd.grad(_gather1d(x, idx), x, g)
    assert torch.equal(got, torch.zeros(300).index_add_(0, idx, g))
    rad = torch.randn(400, 3, requires_grad=True)
    g3 = torch.randn(5000, 3, generator=gen)
    (got,) = torch.autograd.grad(radiance_rows(rad, idx + 100), rad, g3)
    assert torch.equal(got, torch.zeros(400, 3).index_add_(0, idx + 100, g3))


def test_segment_mean_matches_float64():
    """The losses' segment means (values and weights in one sum), with
    segments of many runs: within 1e-6 of the float64 means, and gathered
    back to the elements."""
    gen = torch.Generator().manual_seed(8)
    v = torch.rand(4000, 3, generator=gen)
    w = torch.rand(4000, generator=gen)
    ids = _ids(4000, 50, 9)
    mean, per_elem = segment_mean(v, ids, 64, w)
    wsum = torch.zeros(64, dtype=torch.float64).index_add_(0, ids, w.double())
    vsum = torch.zeros(64, 3, dtype=torch.float64).index_add_(
        0, ids, (v * w[:, None]).double())
    want = vsum / torch.clamp(wsum, min=1e-8)[:, None]
    assert torch.allclose(mean.double(), want, rtol=1e-6, atol=1e-7)
    assert torch.equal(per_elem, mean[ids])
    m1, _ = segment_mean(v[:, 0], ids, 64)
    cnt = torch.bincount(ids, minlength=64).double()
    assert torch.allclose(m1.double(), torch.zeros(64, dtype=torch.float64)
                          .index_add_(0, ids, v[:, 0].double())
                          / torch.clamp(cnt, min=1e-8), rtol=1e-6)
