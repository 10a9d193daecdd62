"""The row-mode hash grid's training estimators, PyTorch port vs the JAX
package: the three custom-gradient lookups forward and backward on the
same indices, and hashgrid_encode under a replayed key.

Tolerances: float32 paths 1e-6 absolute (the same gathers, products and
scatter targets; sums of a few terms in another order). The bfloat16
compact scatter accumulates in bf16, where index_add_ and XLA's scatter sum
colliding rows in another order and round differently: cosine > 0.999.
The stochastic encode compares `u3 < frac`, which flips where the two
packages' frac differ in the last bit, so a stated share of queries may
pick another corner."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_tpu.models import hashgrid as jh
from iris_tpu_torch.models import hashgrid as th
from torch_parity import cosine, jax_hashgrid_draws, tt

L, T, F = 4, 64, 8
LT = L * T
B = 96
M = B * L


def _inputs(seed):
    rng = np.random.default_rng(seed)
    rows = rng.uniform(-1, 1, (LT, F)).astype(np.float32)
    # every index of level column l lies in level block l, as the encode
    # makes them
    lvl = np.tile(np.arange(L), B)
    idxs = (rng.integers(0, T, (8, M)) + lvl * T).astype(np.int32)
    w = rng.uniform(0, 1, (8, M)).astype(np.float32)
    chosen = (rng.integers(0, T, M) + lvl * T).astype(np.int32)
    g = rng.normal(size=(M, F)).astype(np.float32)
    return rows, idxs, w, chosen, g


def _torch_vjp(fn, rows, g):
    r = tt(rows).requires_grad_(True)
    out = fn(r)
    (d_rows,) = torch.autograd.grad(out, r, tt(g))
    return out.detach().numpy(), d_rows.numpy()


def test_row_weighted_forward_and_backward():
    rows, idxs, w, _, g = _inputs(0)
    ref, vjp = jax.vjp(lambda r: jh._row_weighted_p(
        r, jnp.asarray(idxs), jnp.asarray(w)), jnp.asarray(rows))
    out, d_rows = _torch_vjp(lambda r: th.row_weighted(
        r, tt(idxs, torch.int64), tt(w)), rows, g)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(d_rows, np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=2e-6)


CASES = [(bwd_k, phase, compact)
         for bwd_k, phases in ((0, (0,)), (1, (0, 3)), (2, (0, 1)))
         for phase in phases
         for compact in (None, "float32", "bfloat16")]


def _check_scatter(d_rows, d_ref, compact, bwd_k, phase):
    d_ref = np.asarray(d_ref)
    # the same level blocks receive gradient
    blocks = np.abs(d_rows).reshape(L, -1).sum(1) > 0
    np.testing.assert_array_equal(
        blocks, np.abs(d_ref).reshape(L, -1).sum(1) > 0)
    if bwd_k:
        stride = L // bwd_k
        assert list(np.flatnonzero(blocks)) == \
            [j * stride + phase for j in range(bwd_k)]
    if compact == "bfloat16":
        assert cosine(d_rows, d_ref) > 0.999
        np.testing.assert_allclose(d_rows, d_ref, atol=0.1, rtol=0.05)
    else:
        np.testing.assert_allclose(d_rows, d_ref, atol=1e-6 * max(
            1, L // max(bwd_k, 1)))


@pytest.mark.parametrize("bwd_k,phase,compact", CASES)
def test_row_stoch_bwd(bwd_k, phase, compact):
    """Exact forward, one-corner backward (_row_stoch_bwd_p)."""
    rows, idxs, w, chosen, g = _inputs(1)
    ref, vjp = jax.vjp(lambda r: jh._row_stoch_bwd_p(
        r, jnp.asarray(idxs), jnp.asarray(w), jnp.asarray(chosen),
        jnp.int32(phase), L, bwd_k, T, compact, "float32"),
        jnp.asarray(rows))
    out, d_rows = _torch_vjp(lambda r: th.row_stoch_bwd(
        r, tt(idxs, torch.int64), tt(w), tt(chosen, torch.int64), phase, L,
        bwd_k, T, compact, "float32"), rows, g)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-6)
    _check_scatter(d_rows, vjp(jnp.asarray(g))[0], compact, bwd_k, phase)


@pytest.mark.parametrize("bwd_k,phase,compact", CASES)
def test_row_stoch(bwd_k, phase, compact):
    """One-corner forward and backward (_row_stoch_p)."""
    rows, _, _, chosen, g = _inputs(2)
    ref, vjp = jax.vjp(lambda r: jh._row_stoch_p(
        r, jnp.asarray(chosen), jnp.int32(phase), L, bwd_k, T, compact,
        "float32"), jnp.asarray(rows))
    out, d_rows = _torch_vjp(lambda r: th.row_stoch(
        r, tt(chosen, torch.int64), phase, L, bwd_k, T, compact, "float32"),
        rows, g)
    np.testing.assert_array_equal(out, np.asarray(ref))
    _check_scatter(d_rows, vjp(jnp.asarray(g))[0], compact, bwd_k, phase)


@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
def test_forward_gather_dtype(gdtype):
    rows, idxs, w, chosen, _ = _inputs(3)
    ref = jh._row_stoch_p(jnp.asarray(rows), jnp.asarray(chosen),
                          jnp.int32(0), L, 0, T, None, gdtype)
    out = th.row_stoch(tt(rows), tt(chosen, torch.int64), 0, L, 0, T, None,
                       gdtype)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    ref = jh._row_stoch_bwd_p(jnp.asarray(rows), jnp.asarray(idxs),
                              jnp.asarray(w), jnp.asarray(chosen),
                              jnp.int32(0), L, 0, T, None, gdtype)
    out = th.row_stoch_bwd(tt(rows), tt(idxs, torch.int64), tt(w),
                           tt(chosen, torch.int64), 0, L, 0, T, None, gdtype)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_full_scatter_past_16_slots():
    """More than 16 slots take the single full-table scatter in both
    packages, compact or not."""
    rng = np.random.default_rng(4)
    levels, t = 32, 8
    m = 20 * levels
    rows = rng.uniform(-1, 1, (levels * t, 2)).astype(np.float32)
    chosen = (rng.integers(0, t, m)
              + np.tile(np.arange(levels), 20) * t).astype(np.int32)
    g = rng.normal(size=(m, 2)).astype(np.float32)
    d_ref = jh._row_scatter_chosen(jnp.asarray(g), jnp.asarray(chosen),
                                   jnp.int32(0), levels * t, levels, 0, t,
                                   "bfloat16")
    d = th._row_scatter_chosen(tt(g), tt(chosen, torch.int64), 0,
                               levels * t, levels, 0, t, "bfloat16")
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 12, 32])
def test_auto_bwd_level_sample(n):
    assert th.auto_bwd_level_sample(n) == jh.auto_bwd_level_sample(n)
    assert th.auto_bwd_level_sample(n, 2) == jh.auto_bwd_level_sample(n, 2)


# ------------------------------------------------ the encode, replayed key

ENC = dict(n_levels=4, n_features=8, log2_table_size=10, base_resolution=4,
           per_level_scale=2.0, row_gather=True)


def _encode_pair(extra, seed, b=200):
    jcfg = jh.HashGridConfig(**ENC, **extra)
    tcfg = th.HashGridConfig(**ENC, **extra)
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (jcfg.n_levels * jcfg.table_size
                                * jcfg.n_features)).astype(np.float32)
    x = rng.uniform(0, 1, (b, 3)).astype(np.float32)
    g = rng.normal(size=(b, jcfg.n_levels * jcfg.n_features)
                   ).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    ref, vjp = jax.vjp(lambda tb: jh.hashgrid_encode(
        tb, jcfg, jnp.asarray(x), key), jnp.asarray(table))
    d_ref = np.asarray(vjp(jnp.asarray(g))[0]).reshape(-1, jcfg.n_features)
    rows = tt(table.reshape(-1, jcfg.n_features)).requires_grad_(True)
    out = th.hashgrid_encode(rows, tcfg, tt(x),
                             samples=jax_hashgrid_draws(key, jcfg, b))
    (d_rows,) = torch.autograd.grad(out, rows, tt(g))
    return (out.detach().numpy(), np.asarray(ref), d_rows.numpy(), d_ref,
            jcfg)


@pytest.mark.parametrize("bwd_k,dtype", [(0, "float32"), (1, "float32"),
                                         (2, "float32"), (1, "bfloat16")])
def test_encode_stochastic_bwd(bwd_k, dtype):
    """Exact forward (1e-6); the one-corner backward lands on the same
    rows except where a corner bit flipped (<= 0.5% of (query, level)
    pairs may differ)."""
    out, ref, d_rows, d_ref, cfg = _encode_pair(
        dict(stochastic_bwd=True, stochastic_fwd=False,
             bwd_level_sample=bwd_k, bwd_scatter_dtype=dtype), 5)
    np.testing.assert_allclose(out, ref, atol=1e-6)
    hit, hit_ref = np.abs(d_rows).sum(1) > 0, np.abs(d_ref).sum(1) > 0
    assert (hit != hit_ref).sum() <= 0.005 * 2 * hit_ref.sum() + 1e-9
    same = hit == hit_ref
    if dtype == "float32":
        close = np.isclose(d_rows, d_ref, atol=1e-5).all(1)
        assert (~close).sum() <= 0.005 * 2 * hit_ref.sum()
    assert cosine(d_rows[same], d_ref[same]) > 0.999
    blocks = np.abs(d_rows).reshape(cfg.n_levels, -1).sum(1) > 0
    assert blocks.sum() == (bwd_k or cfg.n_levels)


@pytest.mark.parametrize("fwd_k,bwd_k", [(0, 0), (0, 1), (2, 0), (2, 1)])
def test_encode_stochastic_fwd(fwd_k, bwd_k):
    """One-corner forward: >= 99.5% of queries read the same corner rows
    (features equal to 1e-6), kept levels scaled and placed alike."""
    out, ref, d_rows, d_ref, cfg = _encode_pair(
        dict(stochastic_bwd=True, stochastic_fwd=True,
             fwd_level_sample=fwd_k, bwd_level_sample=bwd_k,
             bwd_scatter_dtype="float32"), 6)
    rows_equal = np.isclose(out, ref, atol=1e-6).all(1)
    assert rows_equal.mean() >= 0.995
    np.testing.assert_array_equal(out == 0, ref == 0)
    hit, hit_ref = np.abs(d_rows).sum(1) > 0, np.abs(d_ref).sum(1) > 0
    assert (hit != hit_ref).sum() <= 0.005 * 2 * hit_ref.sum() + 1e-9
    assert cosine(d_rows, d_ref) > 0.99


def test_encode_without_draws_is_exact_and_ignores_estimators():
    """No generator and no samples: the exact encode whatever the
    estimator fields say (what renders rely on), with the exact 8-corner
    backward."""
    out, ref, d_rows, d_ref, _ = _encode_pair(
        dict(stochastic_bwd=False, stochastic_fwd=False), 7)
    np.testing.assert_allclose(out, ref, atol=1e-6)
    np.testing.assert_allclose(d_rows, d_ref, atol=1e-5)
    cfg = th.HashGridConfig(**ENC, stochastic_fwd=True, bwd_level_sample=1)
    rows = tt(np.random.default_rng(8).uniform(-1, 1, (4 << 10, 8)))
    x = tt(np.random.default_rng(9).uniform(0, 1, (50, 3)))
    exact = th.hashgrid_encode(rows, dataclasses.replace(
        cfg, stochastic_fwd=False, bwd_level_sample=0), x)
    assert torch.equal(th.hashgrid_encode(rows, cfg, x), exact)


def test_encode_draws_from_generator_are_unbiased():
    """With a generator (no samples) the one-corner forward averages to
    the exact encode."""
    cfg = th.HashGridConfig(**ENC, stochastic_fwd=True, stochastic_bwd=True)
    rows = tt(np.random.default_rng(10).uniform(-1, 1, (4 << 10, 8)))
    x = tt(np.random.default_rng(11).uniform(0, 1, (8, 3)))
    exact = th.hashgrid_encode(rows, cfg, x)
    gen = torch.Generator().manual_seed(0)
    mean = sum(th.hashgrid_encode(rows, cfg, x, gen)
               for _ in range(3000)) / 3000
    assert float((mean - exact).abs().max()) < 0.08


def test_encode_rejects_bad_settings():
    rows = torch.zeros((4 << 10, 8))
    x = torch.zeros((4, 3))
    gen = torch.Generator().manual_seed(0)
    # a 2-D table is a row-mode table: the flat and packed modes refuse it
    with pytest.raises(ValueError, match="needs row_gather"):
        th.hashgrid_encode(rows, th.HashGridConfig(), x)
    with pytest.raises(ValueError, match="bwd_scatter_dtype"):
        th.hashgrid_encode(rows, th.HashGridConfig(
            **ENC, bwd_scatter_dtype="bf16"), x)
    with pytest.raises(ValueError, match="requires stochastic_fwd"):
        th.hashgrid_encode(rows, th.HashGridConfig(
            **ENC, fwd_level_sample=2), x, gen)
    with pytest.raises(ValueError, match="must divide"):
        th.hashgrid_encode(rows, th.HashGridConfig(
            **ENC, bwd_level_sample=3), x, gen)
