"""PyTorch port vs the JAX package: the exact row-mode hash-grid encode,
the NGP BRDF field, emitter, SLF and CRF, all carried across through
iris_tpu_torch.convert."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_tpu.geometry.procedural import make_box_scene
from iris_tpu.models import crf as jcrf
from iris_tpu.models import emitter as jem
from iris_tpu.models import slf as jslf
from iris_tpu.models.brdf import init_ngp_brdf as jax_init_ngp
from iris_tpu.models.brdf import ngp_brdf_apply as jax_ngp_apply
from iris_tpu.models.hashgrid import HashGridConfig as JCfg
from iris_tpu.models.hashgrid import hashgrid_encode as jax_encode
from iris_tpu_torch.models import crf as tcrf
from iris_tpu_torch.models import emitter as tem
from iris_tpu_torch.models import slf as tslf
from iris_tpu_torch.models.brdf import ngp_brdf_apply
from iris_tpu_torch.models.hashgrid import hashgrid_encode
from torch_parity import port_crf, port_emitter, port_ngp, tt

# (log2 table, base resolution): 2^10 with every level hashed, and 2^12
# with base 8 so that level 0 (9^3 <= 4096 vertices) takes the dense branch
GRIDS = [(10, 16), (12, 8)]


def _cfg(log2, base, levels=4, feats=16):
    return JCfg(n_levels=levels, n_features=feats, log2_table_size=log2,
                base_resolution=base,
                per_level_scale=1.3 ** (31.0 / (levels - 1)),
                row_gather=True)


def _positions(rng, n, lo=-0.05, hi=1.05):
    x = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    x[:4] = [[0, 0, 0], [1, 1, 1], [1, 0, 0.5], [0.5, 1, 0]]
    return x


@pytest.mark.parametrize("log2,base", GRIDS)
def test_hashgrid_row_encode(log2, base):
    cfg = _cfg(log2, base)
    dense = (cfg.resolutions() + 1) ** 3 <= cfg.table_size
    assert dense.any() == (base == 8)
    rng = np.random.default_rng(log2)
    table = rng.uniform(-1, 1, cfg.n_features * cfg.n_levels
                        * cfg.table_size).astype(np.float32)
    x = _positions(rng, 2048)
    ref = np.asarray(jax_encode(jnp.asarray(table), cfg, jnp.asarray(x)))
    ngp = port_ngp(jax_init_ngp(jax.random.PRNGKey(0), 0.0, 1.0, cfg))
    rows = tt(table).reshape(ngp.table.shape)
    out = hashgrid_encode(rows, ngp.cfg, tt(x)).numpy()
    assert out.shape == (2048, 64)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("log2,base", GRIDS)
def test_ngp_brdf_apply(log2, base):
    cfg = _cfg(log2, base)
    rng = np.random.default_rng(3)
    jn = jax_init_ngp(jax.random.PRNGKey(1), -0.1, 2.1, cfg)
    # a table far from its init scale, so the encode drives the MLP
    jn = dataclasses.replace(jn, table=jnp.asarray(rng.uniform(
        -1, 1, jn.table.shape).astype(np.float32)))
    pos = rng.uniform(-0.2, 2.2, (1024, 3)).astype(np.float32)
    ref = jax_ngp_apply(jn, jnp.asarray(pos))
    out = ngp_brdf_apply(port_ngp(jn), tt(pos))
    for k in ("albedo", "roughness", "metallic"):
        # bf16 MLP operands are rounded alike; only the f32 sums of the
        # three products differ in order
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=2e-3, atol=1e-5)


@pytest.fixture(scope="module")
def emitters():
    mesh, is_em = make_box_scene(n_clutter=4, seed=2)
    is_em = is_em.copy()
    is_em[[3, 17]] = True                     # four emitters, uneven areas
    rng = np.random.default_rng(4)
    h = 8
    mask = rng.uniform(size=(h, h, h)) < 0.7
    js = jslf.init_voxel_slf(mask, -0.1, 2.1)
    rad = rng.uniform(0, 2, js.radiance.shape).astype(np.float32)
    rad[::5] = 0.0                             # empty cache entries
    js = dataclasses.replace(js, radiance=jnp.asarray(rad))
    je = jem.make_emitter(is_em, mesh.triangles(),
                          radiance=rng.uniform(1, 5, (int(is_em.sum()), 3)),
                          slf=js)
    return je, port_emitter(je), mesh.n_faces


def test_slf_query(emitters):
    je, te, _ = emitters
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.5, 2.6, (2048, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tslf.spatial_idx(te.slf, tt(x)).numpy(),
        np.asarray(jslf.spatial_idx(je.slf, jnp.asarray(x))))
    np.testing.assert_array_equal(
        tslf.slf_query(te.slf, tt(x)).numpy(),
        np.asarray(jslf.slf_query(je.slf, jnp.asarray(x))))
    np.testing.assert_array_equal(
        tem.slf_forward(te, tt(x)).numpy(),
        np.asarray(jem.slf_forward(je, jnp.asarray(x))))


def test_eval_emitter_with_cache(emitters):
    je, te, n_faces = emitters
    rng = np.random.default_rng(6)
    n = 4096
    pos = rng.uniform(-0.1, 2.1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    tri = rng.integers(-1, n_faces, n)
    tri[:64] = np.asarray(je.triangle_idx)[rng.integers(0, 4, 64)]
    rough = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    ref = jem.eval_emitter(je, jnp.asarray(pos), jnp.asarray(d),
                           jnp.asarray(tri, jnp.int32), jnp.asarray(rough))
    out = tem.eval_emitter(te, tt(pos), tt(d), tt(tri, torch.int64),
                           tt(rough))
    # the cache branch fired: some lanes were terminated into the SLF
    assert (np.asarray(ref[2]) != ((tri >= 0) & ~np.isin(
        tri, np.asarray(je.triangle_idx)))).any()
    for a, b in zip(ref, out):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def test_sample_emitter(emitters):
    je, te, _ = emitters
    rng = np.random.default_rng(8)
    n = 2048
    s1 = rng.uniform(0, 1, n).astype(np.float32)
    s1[:5] = np.asarray(je.emitter_cdf)[[0, 1, 2, 3, 0]]  # searchsorted ties
    s1[5] = 0.0
    s2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    pos = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    ref = jem.sample_emitter(je, jnp.asarray(s1), jnp.asarray(s2),
                             jnp.asarray(pos))
    out = tem.sample_emitter(te, tt(s1), tt(s2), tt(pos))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]),
                               atol=1e-6)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-6)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))


def test_crf_forward():
    jc = jcrf.init_emor_crf(dim=3)
    rng = np.random.default_rng(9)
    jc = dataclasses.replace(jc, weight=jnp.asarray(
        rng.normal(0, 0.3, (3, 3)).astype(np.float32)))
    tc = port_crf(jc)
    # the port's own EMoR table copy loads the same curves
    own = tcrf.init_emor_crf(dim=3, device="cpu")
    np.testing.assert_array_equal(own.f0.numpy(), np.asarray(jc.f0))
    np.testing.assert_array_equal(own.basis.numpy(), np.asarray(jc.basis))
    hdr = rng.uniform(-0.2, 1.5, (4096, 3)).astype(np.float32)
    exp = rng.uniform(0.5, 2, (4096, 1)).astype(np.float32)
    ref = jcrf.crf_forward(jc, jnp.asarray(hdr), jnp.asarray(exp))
    out = tcrf.crf_forward(tc, tt(hdr), tt(exp))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
