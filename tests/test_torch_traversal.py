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
    _pack_paired, paired_vmem_bytes, pallas_ray_trace,
    pallas_ray_trace_ordered, pallas_ray_trace_paired,
    pallas_ray_trace_paired_streamed)
from iris_tpu.geometry.procedural import camera_rays, make_box_scene
from iris_tpu.geometry.procedural import random_rays
from iris_tpu_torch.geometry import cuda_intersect as ci
from iris_tpu_torch.geometry.bvh import build_bvh
from iris_tpu_torch.geometry.intersect import (
    kernel_for, ray_intersect, ray_intersect_brute)
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


def test_build_tracer_matches_jax(scene12):
    """bvh.build_tracer(mesh): the tree of the mesh's triangles, the JAX
    package's bit for bit."""
    from iris_tpu.geometry.bvh import build_tracer as jax_build_tracer
    from iris_tpu_torch.geometry.bvh import build_tracer

    mesh, _ = make_box_scene(n_clutter=12, seed=3)
    jt, pt = jax_build_tracer(mesh), build_tracer(mesh, device="cpu")
    assert (pt.layout, pt.n_nodes, pt.n_faces) == (jt.layout, jt.n_nodes,
                                                   jt.n_faces)
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


@pytest.mark.parametrize("method", ["sah", "morton"])
@pytest.mark.parametrize("leaf_size", [1, 10, 16])
def test_union_plain_matches_pallas_at_leaf_sizes(scene12, method,
                                                  leaf_size):
    """The union walk's leaf fold at one triangle a leaf, at the widest
    leaf the unrolled kernels take (10) and past it (16, a tree under 5K
    faces built so goes to trace_union), on a preorder and a heap tree:
    the same hits as the Pallas kernel to the last bit."""
    jt = jax_build_bvh(scene12, method=method, leaf_size=leaf_size)
    assert jt.leaf_size == leaf_size
    o, d = _rays("random", seed=7)
    jr = pallas_ray_trace(jt, jnp.asarray(o), jnp.asarray(d), tile=128,
                          interpret=True)
    t, u, v, f = ci.trace_union_plain(port_tracer(jt), tt(o), tt(d))
    assert_hits_agree(np.asarray(jr[0]), np.asarray(jr[3]), t, f)
    ok = np.asarray(jr[4])
    assert ok.sum() > 0
    np.testing.assert_array_equal(f.numpy(), np.asarray(jr[3]))
    np.testing.assert_array_equal(t.numpy()[ok], np.asarray(jr[0])[ok])


@pytest.mark.parametrize("kind", ["random", "camera"])
def test_paired_plain_matches_pallas(scene12, kind):
    jt = jax_build_bvh(scene12)
    o, d = _rays(kind)
    jr = pallas_ray_trace_paired(jt, jnp.asarray(o), jnp.asarray(d),
                                 tile=128, interpret=True)
    t, u, v, f = ci.trace_paired_plain(port_tracer(jt), tt(o), tt(d))
    assert_hits_agree(np.asarray(jr[0]), np.asarray(jr[3]), t, f)


@pytest.mark.parametrize("kind", ["random", "camera"])
@pytest.mark.parametrize("leaf_size", [4, 16])
def test_ordered_plain_matches_pallas(scene12, kind, leaf_size):
    jt = jax_build_bvh(scene12, leaf_size=leaf_size)
    o, d = _rays(kind)
    jr = pallas_ray_trace_ordered(jt, jnp.asarray(o), jnp.asarray(d),
                                  tile=128, interpret=True)
    t, u, v, f = ci.trace_ordered_plain(port_tracer(jt), tt(o), tt(d))
    assert_hits_agree(np.asarray(jr[0]), np.asarray(jr[3]), t, f)


@pytest.mark.parametrize("kind", ["random", "camera"])
def test_paired_streamed_plain_matches_pallas(scene12, kind):
    """The packet walk at the Pallas tile's width (128 lanes per cursor)
    against the streamed Pallas kernel with 32-row windows."""
    jt = jax_build_bvh(scene12)
    o, d = _rays(kind)
    jr = pallas_ray_trace_paired_streamed(
        jt, jnp.asarray(o), jnp.asarray(d), tile=128, interpret=True,
        pair_win=32, leaf_win=32)
    counts = {}
    t, u, v, f = ci.trace_paired_streamed_plain(
        port_tracer(jt), tt(o), tt(d), counts=counts, width=128)
    assert_hits_agree(np.asarray(jr[0]), np.asarray(jr[3]), t, f)
    assert counts["pops"] > 0 and counts["pair_loads"] <= counts["pops"]


def test_packet_width_and_tail_do_not_change_hits(scene12):
    """Packets of 32 (the kernel's warp) and of 8, with a ragged last
    packet (1000 rays), find the per-ray paired walk's hits."""
    pt = build_bvh(scene12, device="cpu")
    o, d = random_rays(1000, seed=13)
    want = ci.trace_paired_plain(pt, tt(o), tt(d))
    for width in (32, 8):
        got = ci.trace_paired_streamed_plain(pt, tt(o), tt(d), width=width)
        assert got[0].shape == (1000,)
        assert_hits_agree(want[0], want[3], got[0], got[3])
    with pytest.raises(ValueError, match="power of two"):
        ci.trace_paired_streamed_plain(pt, tt(o), tt(d), width=24)


@pytest.mark.parametrize("n_clutter,leaf_size,want", [
    (12, 4, "trace_union"), (420, 4, "trace_paired"),
    (420, 16, "trace_ordered")])
def test_dispatch_rule(n_clutter, leaf_size, want):
    """The JAX package's split points: < 5000 faces -> union; >= 5000 with
    a leaf row that fits the paired layout -> paired (within the 10 MB
    gate) or paired_streamed (past it); a wider leaf row -> ordered."""
    mesh, _ = make_box_scene(n_clutter=n_clutter, seed=1)
    jt = jax_build_bvh(mesh.triangles(), leaf_size=leaf_size)
    pt = port_tracer(jt)
    assert kernel_for(pt).__name__ == want
    assert ci.paired_layout_bytes(pt) == paired_vmem_bytes(jt)
    # the same tree past the gate streams (the gate is the one constant)
    if want == "trace_paired":
        old = ci.PAIRED_RESIDENT_BYTES
        ci.PAIRED_RESIDENT_BYTES = ci.paired_layout_bytes(pt) - 1
        try:
            assert kernel_for(pt) is ci.trace_paired_streamed
        finally:
            ci.PAIRED_RESIDENT_BYTES = old
    # a heap tree of any size walks the union kernel
    heap = port_tracer(jax_build_bvh(mesh.triangles(), method="morton"))
    assert kernel_for(heap) is ci.trace_union


def test_plain_walks_match_brute(scene12):
    pt = build_bvh(scene12, device="cpu")
    o, d = random_rays(1024, seed=11)
    _, _, _, ib, vb = ray_intersect_brute(tt(scene12), tt(o), tt(d))
    for walk in (ci.trace_union_plain, ci.trace_paired_plain,
                 ci.trace_ordered_plain, ci.trace_paired_streamed_plain):
        t, _, _, f = walk(pt, tt(o), tt(d))
        np.testing.assert_array_equal((f >= 0).numpy(), vb.numpy())
        assert (f.long() == ib)[vb].float().mean() > 0.99


@pytest.mark.parametrize("n_clutter,sort", [(12, False), (420, True)])
def test_ray_intersect_matches_jax(n_clutter, sort):
    mesh, _ = make_box_scene(n_clutter=n_clutter, seed=1)
    jt = jax_build_bvh(mesh.triangles())
    pt = port_tracer(jt)
    # >= 5000 faces takes the paired walk, with the secondary-ray sort
    assert kernel_for(pt) is (ci.trace_paired if n_clutter == 420
                              else ci.trace_union)
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
