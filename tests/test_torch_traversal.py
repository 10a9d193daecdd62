"""PyTorch port vs the JAX package: BVH build, the paired re-pack, each
traversal kernel's plain version against its Pallas kernel (interpret
mode), and ray_intersect against JAX's XLA path.

Bar (tests/torch_parity.assert_hits_agree): hit/miss equal on >= 99.9% of
rays, t within 1e-5 relative where both hit, face ids equal except at t
ties within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest

from iris_tpu.geometry.bvh import build_bvh as jax_build_bvh
from iris_tpu.geometry.intersect import ray_intersect as jax_ray_intersect
from iris_tpu.geometry.pallas_intersect import (
    _pack_paired, pallas_ray_trace, pallas_ray_trace_paired)
from iris_tpu.geometry.procedural import camera_rays, make_box_scene
from iris_tpu.geometry.procedural import random_rays
from iris_tpu_torch.geometry import cuda_intersect as ci
from iris_tpu_torch.geometry.bvh import build_bvh
from iris_tpu_torch.geometry.intersect import (
    ray_intersect, ray_intersect_brute, uses_paired)
from torch_parity import assert_hits_agree, port_tracer, tt


def _rays(kind, n_side=16, seed=5):
    if kind == "random":
        return random_rays(n_side * n_side, seed=seed)
    return camera_rays(n_side)[:2]


@pytest.fixture(scope="module")
def scene12():
    mesh, _ = make_box_scene(n_clutter=12, seed=3)
    return mesh.triangles()


@pytest.mark.parametrize("method", ["sah", "morton"])
def test_port_tracer_matches_jax_build(scene12, method):
    jt = jax_build_bvh(scene12, method=method)
    pt = build_bvh(scene12, method=method, device="cpu")
    assert pt.layout == jt.layout
    assert (pt.n_nodes, pt.leaf_size, pt.n_faces, pt.depth) == \
        (jt.n_nodes, jt.leaf_size, jt.n_faces, jt.depth)
    for name in ("nodes", "tris", "face_normals"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(jt, name)))


def test_pack_paired_bit_exact(scene12):
    jt = jax_build_bvh(scene12)
    n_leaf_rows = jt.tris.shape[0] // jt.leaf_size
    jp, jl = _pack_paired(jt, jt.n_nodes - n_leaf_rows, n_leaf_rows)
    pp, pl_, n_pairs, n_rows = ci.pack_paired(port_tracer(jt))
    assert (n_pairs, n_rows) == (jt.n_nodes - n_leaf_rows, n_leaf_rows)
    # bit for bit, -0.0 leaf descriptors included
    np.testing.assert_array_equal(pp.numpy().view(np.uint32),
                                  np.asarray(jp).view(np.uint32))
    np.testing.assert_array_equal(pl_.numpy().view(np.uint32),
                                  np.asarray(jl).view(np.uint32))


@pytest.mark.parametrize("method,kind", [("sah", "random"), ("sah", "camera"),
                                         ("morton", "random")])
def test_union_plain_matches_pallas(scene12, method, kind):
    jt = jax_build_bvh(scene12, method=method)
    o, d = _rays(kind)
    jr = pallas_ray_trace(jt, jnp.asarray(o), jnp.asarray(d), tile=128,
                          interpret=True)
    t, u, v, f = ci.trace_union_plain(port_tracer(jt), tt(o), tt(d))
    assert_hits_agree(np.asarray(jr[0]), np.asarray(jr[3]), t, f)
    ok = np.asarray(jr[4])
    # same walk order and arithmetic: the same hits to the last bit
    np.testing.assert_array_equal(f.numpy(), np.asarray(jr[3]))
    np.testing.assert_allclose(u.numpy()[ok], np.asarray(jr[1])[ok],
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["random", "camera"])
def test_paired_plain_matches_pallas(scene12, kind):
    jt = jax_build_bvh(scene12)
    o, d = _rays(kind)
    jr = pallas_ray_trace_paired(jt, jnp.asarray(o), jnp.asarray(d),
                                 tile=128, interpret=True)
    t, u, v, f = ci.trace_paired_plain(port_tracer(jt), tt(o), tt(d))
    assert_hits_agree(np.asarray(jr[0]), np.asarray(jr[3]), t, f)


def test_plain_walks_match_brute(scene12):
    pt = build_bvh(scene12, device="cpu")
    o, d = random_rays(1024, seed=11)
    _, _, _, ib, vb = ray_intersect_brute(tt(scene12), tt(o), tt(d))
    for walk in (ci.trace_union_plain, ci.trace_paired_plain):
        t, _, _, f = walk(pt, tt(o), tt(d))
        np.testing.assert_array_equal((f >= 0).numpy(), vb.numpy())
        assert (f.long() == ib)[vb].float().mean() > 0.99


@pytest.mark.parametrize("n_clutter,sort", [(12, False), (420, True)])
def test_ray_intersect_matches_jax(n_clutter, sort):
    mesh, _ = make_box_scene(n_clutter=n_clutter, seed=1)
    jt = jax_build_bvh(mesh.triangles())
    pt = port_tracer(jt)
    # >= 5000 faces takes the paired walk, with the secondary-ray sort
    assert uses_paired(pt) == (n_clutter == 420)
    o, d = random_rays(512, seed=2, origin=(0.7, 1.3, 0.4))
    jr = jax_ray_intersect(jt, jnp.asarray(o), jnp.asarray(d), sort=sort)
    pr = ray_intersect(pt, tt(o), tt(d), sort=sort)
    jpos, jn, juv, jidx, jvalid = [np.asarray(x) for x in jr]
    ppos, pn, puv, pidx, pvalid = [x.numpy() for x in pr]
    t_j = np.linalg.norm(jpos - o, axis=-1)
    t_p = np.linalg.norm(ppos - o, axis=-1)
    assert_hits_agree(t_j, jidx, t_p, pidx)
    same = jvalid & pvalid & (jidx == pidx)
    np.testing.assert_allclose(ppos[same], jpos[same], atol=1e-5)
    np.testing.assert_allclose(pn[same], jn[same], atol=1e-6)
    np.testing.assert_allclose(puv[same], juv[same], atol=1e-5)
    assert not np.any(pn[~pvalid]) and np.all(pidx[~pvalid] == -1)
