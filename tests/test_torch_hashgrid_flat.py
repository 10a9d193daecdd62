"""The flat and packed hash-grid modes (the reference's 32-level x
2-feature parameterization, here at 8 levels x 2 features x 2^8-2^10
entries), PyTorch port vs the JAX package: each lookup and estimator
called directly on the same indices, forward and backward, and
hashgrid_encode under a replayed key.

Tolerances. Packed features are bit-equal: both packages round the float32
table to bfloat16 to nearest even and gather the same words. Flat forwards
rtol 1e-6 (the same eight products, summed in the same order). Table
gradients atol 1e-6 times the number of colliding terms: index_add_ sums
them in another order than XLA's scatter. The stochastic encode compares
`u3 < frac`, which flips where the two packages' frac differ in the last
bit, so 0.5% of (query, level) pairs may pick another corner."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_tpu.models import hashgrid as jh
from iris_tpu_torch.models import hashgrid as th
from torch_parity import cosine, jax_hashgrid_draws, tt

L, T, F = 8, 256, 2
BLK = L * T
B = 96
M = B * L


def _inputs(seed, n_features=F):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, n_features * BLK).astype(np.float32)
    # every index of level column l lies in level block l, as the encode
    # makes them
    lvl = np.tile(np.arange(L), B)
    idxs = (rng.integers(0, T, (8, M)) + lvl * T).astype(np.int32)
    w = rng.uniform(0, 1, (8, M)).astype(np.float32)
    chosen = (rng.integers(0, T, M) + lvl * T).astype(np.int32)
    g = rng.normal(size=(n_features, M)).astype(np.float32)
    return table, idxs, w, chosen, g


def _torch_vjp(fn, table, g):
    tb = tt(table).requires_grad_(True)
    out = fn(tb)
    (d_table,) = torch.autograd.grad(out, tb, tt(g))
    return out.detach().numpy(), d_table.numpy()


def _i64(a):
    return tt(a, torch.int64)


def test_packed_words_are_jax_bits():
    """bfloat16 round-to-nearest-even of both features in one 32-bit word,
    feature 0 in the low half: the same words, ties and negatives
    included."""
    rng = np.random.default_rng(0)
    table = rng.uniform(-1, 1, 2 * BLK).astype(np.float32)
    # exact ties between two bfloat16 neighbours, both signs
    table[:4] = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0xBF818000],
                         np.uint32).view(np.float32)
    jt = jnp.asarray(table)
    f0 = jax.lax.bitcast_convert_type(
        jt[:BLK].astype(jnp.bfloat16), jnp.uint16).astype(jnp.uint32)
    f1 = jax.lax.bitcast_convert_type(
        jt[BLK:].astype(jnp.bfloat16), jnp.uint16).astype(jnp.uint32)
    want = np.asarray(f0 | (f1 << 16))
    got = th._pack_bf16(tt(table), BLK).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    g0, g1 = th._unpack_bf16(th._pack_bf16(tt(table), BLK))
    np.testing.assert_array_equal(
        g0.numpy(), np.asarray(jt[:BLK].astype(jnp.bfloat16)
                               .astype(jnp.float32)))
    np.testing.assert_array_equal(
        g1.numpy(), np.asarray(jt[BLK:].astype(jnp.bfloat16)
                               .astype(jnp.float32)))


@pytest.mark.parametrize("n_features", [2, 4])
def test_weighted_lookup_flat(n_features):
    """_weighted_lookup_p: per feature 8 gathers at idxs[k] + j*block, and
    one 1-D scatter per feature and corner in the backward."""
    table, idxs, w, _, g = _inputs(1, n_features)
    ref, vjp = jax.vjp(lambda tb: jh.weighted_lookup(
        tb, jnp.asarray(idxs), jnp.asarray(w), n_features, BLK),
        jnp.asarray(table))
    out, d_table = _torch_vjp(lambda tb: th.weighted_lookup(
        tb, _i64(idxs), tt(w), n_features, BLK), table, g)
    assert out.shape == (n_features, M)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(d_table, np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=2e-6)


def test_weighted_lookup_packed():
    """_weighted_lookup_packed_p: bfloat16 features, float32 sums and the
    float32 backward of the flat lookup."""
    table, idxs, w, _, g = _inputs(2)
    ref, vjp = jax.vjp(lambda tb: jh._weighted_lookup_packed_p(
        tb, jnp.asarray(idxs), jnp.asarray(w), BLK), jnp.asarray(table))
    out, d_table = _torch_vjp(lambda tb: th.weighted_lookup_packed(
        tb, _i64(idxs), tt(w), BLK), table, g)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(d_table, np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=2e-6)
    # the packed forward reads bfloat16: not the flat forward
    flat = th.weighted_lookup(tt(table), _i64(idxs), tt(w), 2, BLK).numpy()
    assert 1e-4 < np.abs(out - flat).max() < 0.05


SCATTER = [(bwd_k, phase, compact)
           for bwd_k, phases in ((0, (0,)), (L // 4, (0, 3)), (4, (1,)))
           for phase in phases for compact in (False, True)]


def _check_scatter(d, d_ref, bwd_k, phase):
    d_ref = np.asarray(d_ref)
    np.testing.assert_allclose(d, d_ref, atol=1e-6 * max(
        1, L // max(bwd_k, 1)))
    # the same (feature, level) blocks receive gradient
    blocks = np.abs(d).reshape(F, L, T).sum(2) > 0
    np.testing.assert_array_equal(
        blocks, np.abs(d_ref).reshape(F, L, T).sum(2) > 0)
    if bwd_k:
        stride = L // bwd_k
        for j in range(F):
            assert list(np.flatnonzero(blocks[j])) == \
                [s * stride + phase for s in range(bwd_k)]


@pytest.mark.parametrize("bwd_k,phase,compact", SCATTER)
def test_scatter_chosen(bwd_k, phase, compact):
    """_scatter_chosen: the strided level-block slice, and the compact
    per-(feature, level-block) scatter while slots x features <= 32 (here
    8 x 2 and 2 x 2 take it)."""
    _, _, _, chosen, g = _inputs(3)
    d_ref = jh._scatter_chosen(jnp.asarray(g), jnp.asarray(chosen),
                               jnp.int32(phase), F, BLK, F * BLK, L, bwd_k,
                               T, compact)
    d = th._scatter_chosen(tt(g), _i64(chosen), phase, F, BLK, F * BLK, L,
                           bwd_k, T, compact)
    _check_scatter(d.numpy(), d_ref, bwd_k, phase)


def test_scatter_chosen_past_32_slots_takes_one_scatter():
    """32 levels x 2 features = 64 (slot, feature) pairs: both packages
    fall back to one scatter per feature over the whole table; with
    bwd_k = 8 (16 pairs) the compact path is taken. Same cotangent."""
    rng = np.random.default_rng(4)
    levels, t, b = 32, 16, 20
    blk = levels * t
    chosen = (rng.integers(0, t, b * levels)
              + np.tile(np.arange(levels), b) * t).astype(np.int32)
    g = rng.normal(size=(2, b * levels)).astype(np.float32)
    for bwd_k, phase in ((0, 0), (8, 2)):
        d_ref = jh._scatter_chosen(jnp.asarray(g), jnp.asarray(chosen),
                                   jnp.int32(phase), 2, blk, 2 * blk, levels,
                                   bwd_k, t, True)
        d = th._scatter_chosen(tt(g), _i64(chosen), phase, 2, blk, 2 * blk,
                               levels, bwd_k, t, True)
        np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=4e-6)
        if bwd_k:
            hit = np.abs(d.numpy()).reshape(2, levels, t).sum(2) > 0
            assert list(np.flatnonzero(hit[0])) == [4 * s + 2
                                                    for s in range(8)]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("bwd_k,phase,compact", SCATTER[:4])
def test_lookup_stoch_bwd(packed, bwd_k, phase, compact):
    """Exact forward, one-corner backward (_lookup_stoch_bwd_p)."""
    table, idxs, w, chosen, g = _inputs(5)
    ref, vjp = jax.vjp(lambda tb: jh._lookup_stoch_bwd_p(
        tb, jnp.asarray(idxs), jnp.asarray(w), jnp.asarray(chosen),
        jnp.int32(phase), F, BLK, packed, L, bwd_k, T, compact),
        jnp.asarray(table))
    out, d_table = _torch_vjp(lambda tb: th.lookup_stoch_bwd(
        tb, _i64(idxs), tt(w), _i64(chosen), phase, F, BLK, packed, L, bwd_k,
        T, compact), table, g)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-6, atol=1e-7)
    _check_scatter(d_table, vjp(jnp.asarray(g))[0], bwd_k, phase)


@pytest.mark.parametrize("packed,fwd_block", [(False, False), (True, False),
                                              (True, True)])
@pytest.mark.parametrize("bwd_k,phase,compact", SCATTER[:4])
def test_stoch_lookup(packed, fwd_block, bwd_k, phase, compact):
    """One-corner forward and backward (_stoch_lookup_p): a pure gather,
    so the features are the JAX package's to the last bit, gathered
    globally or level block by level block."""
    table, _, _, chosen, g = _inputs(6)
    ref, vjp = jax.vjp(lambda tb: jh._stoch_lookup_p(
        tb, jnp.asarray(chosen), jnp.int32(phase), F, BLK, packed, L, bwd_k,
        T, compact, fwd_block), jnp.asarray(table))
    out, d_table = _torch_vjp(lambda tb: th.stoch_lookup(
        tb, _i64(chosen), phase, F, BLK, packed, L, bwd_k, T, compact,
        fwd_block), table, g)
    np.testing.assert_array_equal(out, np.asarray(ref))
    _check_scatter(d_table, vjp(jnp.asarray(g))[0], bwd_k, phase)


def test_block_gather_is_the_global_gather():
    table, _, _, chosen, _ = _inputs(7)
    a = th._stoch_gather_impl(tt(table), _i64(chosen), F, BLK, True, L, T,
                              True)
    b = th._stoch_gather_impl(tt(table), _i64(chosen), F, BLK, True, L, T,
                              False)
    assert torch.equal(a, b)
    # the forward-sampled levels {1, 5} of 8: each column's block is read
    # from its own indices
    sub = _i64(chosen).reshape(B, L)[:, [1, 5]].reshape(-1)
    c = th._stoch_gather_impl(tt(table), sub, F, BLK, True, 2, T, True)
    d = th._stoch_gather_impl(tt(table), sub, F, BLK, True, 2, T, False)
    assert torch.equal(c, d)


# ------------------------------------------------ the encode, replayed key

ENC = dict(n_levels=8, n_features=2, log2_table_size=10, base_resolution=4,
           per_level_scale=1.5)


def _encode_pair(extra, seed, b=200, keyed=True):
    jcfg = jh.HashGridConfig(**ENC, **extra)
    tcfg = th.HashGridConfig(**ENC, **extra)
    n = jcfg.n_levels * jcfg.table_size * jcfg.n_features
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, n).astype(np.float32)
    x = rng.uniform(0, 1, (b, 3)).astype(np.float32)
    g = rng.normal(size=(b, jcfg.n_levels * jcfg.n_features)
                   ).astype(np.float32)
    key = jax.random.PRNGKey(seed) if keyed else None
    ref, vjp = jax.vjp(lambda tb: jh.hashgrid_encode(
        tb, jcfg, jnp.asarray(x), key), jnp.asarray(table))
    d_ref = np.asarray(vjp(jnp.asarray(g))[0])
    tb = tt(table).requires_grad_(True)
    out = th.hashgrid_encode(
        tb, tcfg, tt(x),
        samples=jax_hashgrid_draws(key, jcfg, b) if keyed else None)
    (d_table,) = torch.autograd.grad(out, tb, tt(g))
    return out.detach().numpy(), np.asarray(ref), d_table.numpy(), d_ref, jcfg


@pytest.mark.parametrize("packed", [False, True])
def test_encode_exact(packed):
    """No key: the exact 8-corner encode, feature-major (B, F*L), and its
    exact backward."""
    out, ref, d, d_ref, cfg = _encode_pair(dict(packed_gather=packed), 11,
                                           keyed=False)
    assert out.shape == (200, cfg.n_features * cfg.n_levels)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d, d_ref, atol=2e-6)


def test_encode_output_is_feature_major():
    """Column j*L + l is feature j of level l: zeroing feature 1's half of
    the table zeroes exactly the second half of the columns."""
    cfg = th.HashGridConfig(**ENC, packed_gather=False)
    rng = np.random.default_rng(12)
    table = tt(rng.uniform(0.5, 1, 2 * cfg.n_levels * cfg.table_size))
    table[cfg.n_levels * cfg.table_size:] = 0.0
    out = th.hashgrid_encode(table, cfg, tt(rng.uniform(0, 1, (50, 3))))
    assert bool((out[:, :cfg.n_levels] > 0).all())
    assert not bool(out[:, cfg.n_levels:].any())


def _same_entries(d, d_ref):
    """The share bar of the stochastic backward: the two packages scatter
    to the same table entries but for <= 0.5% of (query, level) pairs."""
    hit, hit_ref = d != 0, d_ref != 0
    assert (hit != hit_ref).sum() <= 0.005 * 2 * hit_ref.sum() + 1e-9
    return hit == hit_ref


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("bwd_k,compact", [(0, True), (2, True), (2, False),
                                           (4, True)])
def test_encode_stochastic_bwd(packed, bwd_k, compact):
    out, ref, d, d_ref, cfg = _encode_pair(
        dict(packed_gather=packed, stochastic_bwd=True, stochastic_fwd=False,
             bwd_level_sample=bwd_k, bwd_compact_scatter=compact), 13)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    same = _same_entries(d, d_ref)
    close = np.isclose(d, d_ref, atol=2e-6)
    assert (~close).sum() <= 0.005 * 2 * (d_ref != 0).sum()
    assert cosine(d[same], d_ref[same]) > 0.999
    blocks = np.abs(d).reshape(cfg.n_features, cfg.n_levels, -1).sum(2) > 0
    assert (blocks.sum(1) == (bwd_k or cfg.n_levels)).all()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("fwd_k,bwd_k", [(0, 0), (0, 2), (4, 0), (4, 2)])
def test_encode_stochastic_fwd(packed, fwd_k, bwd_k):
    """One-corner forward: >= 99.5% of queries read the same corners (a
    pure gather: those features are bit-equal), kept levels scaled and
    placed alike in each feature's columns."""
    out, ref, d, d_ref, cfg = _encode_pair(
        dict(packed_gather=packed, stochastic_bwd=True, stochastic_fwd=True,
             fwd_level_sample=fwd_k, bwd_level_sample=bwd_k), 14)
    assert (out == ref).all(1).mean() >= 0.995
    np.testing.assert_array_equal(out == 0, ref == 0)
    if fwd_k:
        kept = (out != 0).any(0).reshape(cfg.n_features, fwd_k, -1)
        assert (kept.sum(2) == 1).all()     # one phase of every stride
        assert (kept == kept[0, 0]).all()   # the same in every column group
    _same_entries(d, d_ref)
    assert cosine(d, d_ref) > 0.99


@pytest.mark.parametrize("fwd_k", [0, 4])
def test_encode_block_gather_on_and_off_are_bit_equal(fwd_k):
    extra = dict(stochastic_bwd=True, stochastic_fwd=True,
                 fwd_level_sample=fwd_k, bwd_level_sample=2)
    on = _encode_pair(dict(fwd_block_gather=True, **extra), 15)
    off = _encode_pair(dict(fwd_block_gather=False, **extra), 15)
    np.testing.assert_array_equal(on[0], off[0])
    np.testing.assert_array_equal(on[2], off[2])
    np.testing.assert_array_equal(on[1], off[1])    # and in JAX


@pytest.mark.parametrize("row", [False, True])
def test_encode_phase_as_int_or_device_tensor(row):
    """The level-block phases are device indices: replayed phases given as
    ints and as (1,) int64 tensors give the same bits, forward and
    backward; the int form is held against the JAX encode under its
    replayed draws (test_encode_stochastic_fwd's bar); and a drawn phase
    is a (1,) int64 tensor in range that a seeded generator repeats."""
    extra = dict(packed_gather=not row, row_gather=row, stochastic_bwd=True,
                 stochastic_fwd=True, fwd_level_sample=4, bwd_level_sample=2)
    b = 200
    jcfg = jh.HashGridConfig(**ENC, **extra)
    tcfg = th.HashGridConfig(**ENC, **extra)
    rng = np.random.default_rng(17)
    table = rng.uniform(-1, 1, jcfg.n_levels * jcfg.table_size * 2) \
        .astype(np.float32)
    x = rng.uniform(0, 1, (b, 3)).astype(np.float32)
    g = rng.normal(size=(b, 2 * jcfg.n_levels)).astype(np.float32)
    key = jax.random.PRNGKey(17)
    draws = jax_hashgrid_draws(key, jcfg, b)
    assert isinstance(draws["phase"], int) and isinstance(draws["fphase"],
                                                          int)

    def encode(samples):
        tb = tt(table).requires_grad_(True)
        out = th.hashgrid_encode(tb, tcfg, tt(x), samples=samples)
        (d,) = torch.autograd.grad(out, tb, tt(g))
        return out.detach(), d

    as_int = encode(draws)
    as_tensor = encode({**draws, **{k: torch.tensor([draws[k]])
                                    for k in ("phase", "fphase")}})
    assert torch.equal(as_int[0], as_tensor[0])
    assert torch.equal(as_int[1], as_tensor[1])
    if not row:
        ref = np.asarray(jh.hashgrid_encode(jnp.asarray(table), jcfg,
                                            jnp.asarray(x), key))
        out = as_int[0].numpy()
        assert (out == ref).all(1).mean() >= 0.995
        np.testing.assert_array_equal(out == 0, ref == 0)
    gen = torch.Generator().manual_seed(3)
    ph = th._draw_phase(gen, None, "phase", 4, torch.device("cpu"))
    assert ph.shape == (1,) and ph.dtype == torch.int64 and 0 <= ph < 4
    again = th._draw_phase(torch.Generator().manual_seed(3), None, "phase",
                           4, torch.device("cpu"))
    assert torch.equal(ph, again)
    drawn = [th.hashgrid_encode(tt(table), tcfg, tt(x),
                                torch.Generator().manual_seed(5))
             for _ in range(2)]
    assert torch.equal(drawn[0], drawn[1])


def test_encode_without_draws_ignores_estimators():
    """No generator and no samples: the exact encode whatever the
    estimator fields say (what renders rely on)."""
    cfg = th.HashGridConfig(**ENC, stochastic_fwd=True, bwd_level_sample=2,
                            fwd_level_sample=4)
    rng = np.random.default_rng(16)
    table = tt(rng.uniform(-1, 1, 2 * cfg.n_levels * cfg.table_size))
    x = tt(rng.uniform(0, 1, (50, 3)))
    exact = th.hashgrid_encode(table, th.HashGridConfig(**ENC), x)
    assert torch.equal(th.hashgrid_encode(table, cfg, x), exact)


@pytest.mark.parametrize("packed", [False, True])
def test_encode_draws_from_generator_are_unbiased(packed):
    """With a generator (no samples) the one-corner forward averages to
    the exact encode, level sampling included."""
    cfg = th.HashGridConfig(**ENC, packed_gather=packed, stochastic_fwd=True,
                            stochastic_bwd=True, fwd_level_sample=4)
    rng = np.random.default_rng(17)
    table = tt(rng.uniform(-1, 1, 2 * cfg.n_levels * cfg.table_size))
    x = tt(rng.uniform(0, 1, (8, 3)))
    exact = th.hashgrid_encode(table, cfg, x)
    gen = torch.Generator().manual_seed(0)
    mean = sum(th.hashgrid_encode(table, cfg, x, gen)
               for _ in range(4000)) / 4000
    assert float((mean - exact).abs().max()) < 0.12


def test_reference_defaults_and_init():
    """HashGridConfig() is the reference's grid in both packages, field by
    field; init_hashgrid returns the flat table unless row_gather."""
    jcfg, tcfg = jh.HashGridConfig(), th.HashGridConfig()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.n_levels, tcfg.n_features, tcfg.log2_table_size,
            tcfg.packed_gather, tcfg.fwd_block_gather, tcfg.row_gather) == \
        (32, 2, 19, True, True, False)
    np.testing.assert_array_equal(tcfg.resolutions(), jcfg.resolutions())
    small = th.HashGridConfig(**ENC)
    gen = torch.Generator().manual_seed(0)
    flat = th.init_hashgrid(gen, small, "cpu")
    assert flat.shape == (2 * 8 * 1024,)
    assert float(flat.abs().max()) <= 1e-4
    rows = th.init_hashgrid(gen, dataclasses.replace(small, row_gather=True),
                            "cpu")
    assert rows.shape == (8 * 1024, 2)


def test_encode_rejects_a_row_table_without_row_gather():
    cfg = th.HashGridConfig(**ENC)
    with pytest.raises(ValueError, match="needs row_gather"):
        th.hashgrid_encode(torch.zeros((8 << 10, 2)), cfg,
                           torch.zeros((4, 3)))


# the kernel path of the exact forward (models/cuda_hashgrid.py), held on
# the CPU with its plain version in the kernel's place: dense levels 0-2
# ((res + 1)^3 <= 256) and hashed levels 3-7
KERNEL_GRID = dict(n_levels=8, log2_table_size=8, base_resolution=2,
                   per_level_scale=1.5)
KERNEL_CASES = [
    ("packed", dict(), False),
    ("packed", dict(bwd_level_sample=4), True),
    ("flat", dict(n_features=3, packed_gather=False), False),
    ("flat", dict(packed_gather=False, bwd_compact_scatter=False), True),
    ("rows", dict(n_features=8, row_gather=True), False),
    ("rows", dict(n_features=16, row_gather=True, bwd_level_sample=2), True),
    ("rows_bf16", dict(n_features=16, row_gather=True, bwd_level_sample=2,
                       fwd_gather_dtype="bfloat16"), True),
]


def _kernel_case(extra):
    cfg = th.HashGridConfig(**KERNEL_GRID, stochastic_bwd=True,
                            stochastic_fwd=False, **extra)
    rng = np.random.default_rng(21)
    table = tt(rng.uniform(-1, 1, cfg.n_levels * cfg.table_size
                           * cfg.n_features).astype(np.float32))
    if cfg.row_gather:
        table = table.reshape(-1, cfg.n_features)
    # past both ends of the box, and on its faces: the clamp and the
    # res + 1 corner
    x = rng.uniform(-0.1, 1.1, (67, 3)).astype(np.float32)
    x[:4] = [[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 1]]
    return cfg, table, tt(x)


@pytest.mark.parametrize("mode,extra,keyed", KERNEL_CASES)
def test_kernel_path_is_the_plain_path(monkeypatch, mode, extra, keyed):
    """hashgrid_encode's kernel path (_KernelEncode), with encode_plain in
    the kernel's place: the features and the table gradient are the plain
    path's, bit for bit (the exact backward from the corners recomputed,
    the stochastic one from the same draws); on a CPU tensor the plain
    path runs and counts no kernel launch."""
    from iris_tpu_torch.models import cuda_hashgrid
    from iris_tpu_torch.utils import profiling

    cfg, table, x = _kernel_case(extra)
    launched = []

    def kernel(*args):
        launched.append(args[3])
        return cuda_hashgrid.encode_plain(*args)

    def run():
        tb = table.clone().requires_grad_(True)
        gen = torch.Generator().manual_seed(5) if keyed else None
        out = th.hashgrid_encode(tb, cfg, x, gen)
        g = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
        (d,) = torch.autograd.grad(out, tb, g)
        return out, d

    monkeypatch.setattr(cuda_hashgrid, "encode", kernel)
    monkeypatch.setattr(cuda_hashgrid, "pack", th._pack_bf16)
    profiling.reset()
    plain = run()
    assert launched == []
    assert "hashgrid.encode_kernel" not in profiling.report()["counts"]
    monkeypatch.setattr(th, "_kernel_runs", lambda x: True)
    got = run()
    assert launched == [mode]
    assert all(torch.equal(a, b) for a, b in zip(got, plain))


def test_kernel_wrapper_refuses_a_cpu_tensor():
    from iris_tpu_torch.models import cuda_hashgrid

    cfg, table, x = _kernel_case(dict(bwd_level_sample=4))
    levels = th._level_constants(cfg, x.device)[:3]
    with pytest.raises(ValueError, match="not on the card"):
        cuda_hashgrid.encode(th._pack_bf16(table, table.numel() // 2), x,
                             levels, "packed", 8, 2, 8)
    with pytest.raises(ValueError, match="not on the card"):
        cuda_hashgrid.pack(table, table.numel() // 2)
