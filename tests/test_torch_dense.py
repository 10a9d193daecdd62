"""PyTorch port vs the JAX package: the dense re-pack, the plain versions
of trace_streamed, trace_dense and trace_dense_streamed against their
Pallas kernels (interpret mode, small windows), and the traversal policy
(kernel_for) against the lines of _pallas_mode it follows.

Bar (tests/torch_parity.assert_hits_agree): hit/miss equal on >= 99.9% of
rays, t within 1e-5 relative where both hit, face ids equal except at t
ties within 1e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_tpu.geometry import pallas_intersect as jpi
from iris_tpu.geometry.bvh import build_bvh as jax_build_bvh
from iris_tpu.geometry.procedural import (camera_rays, make_box_scene,
                                          random_rays)
from iris_tpu_torch.geometry import cuda_intersect as ci
from iris_tpu_torch.geometry.bvh import build_bvh
from iris_tpu_torch.geometry.intersect import (
    TraversalPolicy, kernel_for, ray_intersect_brute, traversal_mode)
from torch_parity import assert_hits_agree, port_tracer, tt


def _rays(kind, n_side=16, seed=5):
    if kind == "random":
        return random_rays(n_side * n_side, seed=seed)
    return camera_rays(n_side)[:2]


@pytest.fixture(scope="module")
def scene40():
    """~500 faces: ~250 leaves and ~500 nodes, so 64-row node and leaf
    windows and 8-row dense windows are crossed many times."""
    mesh, _ = make_box_scene(n_clutter=40, seed=3)
    return mesh.triangles()


def _bits(x):
    return np.ascontiguousarray(np.asarray(x)).view(np.uint32)


@pytest.mark.parametrize("leaf_size", [4, 5])
def test_pack_dense_bit_exact(scene40, leaf_size):
    jt = jax_build_bvh(scene40, leaf_size=leaf_size)
    n_leaf_rows = jt.tris.shape[0] // jt.leaf_size
    n_pairs = jt.n_nodes - n_leaf_rows
    jp, jl = jpi._pack_dense(jt, n_pairs, n_leaf_rows)
    pt = port_tracer(jt)
    pp, pl_, got_pairs, got_rows = ci.pack_dense(pt)
    assert (got_pairs, got_rows) == (n_pairs, n_leaf_rows)
    # bit for bit, -0.0 leaf descriptors included
    np.testing.assert_array_equal(_bits(pp.numpy()), _bits(jp))
    np.testing.assert_array_equal(_bits(pl_.numpy()), _bits(jl))
    # the dense pair rows are pairs16's bytes, then zero records
    p16 = ci.pack_paired_compact(pt)[0]
    flat = pp.numpy().reshape(-1, 16)
    np.testing.assert_array_equal(_bits(flat[:n_pairs]), _bits(p16.numpy()))
    assert not flat[n_pairs:].any()
    assert ci.pack_dense(pt) is pt.dense      # cached on the tracer


def test_pack_dense_refuses_wide_leaves(scene40):
    pt = build_bvh(scene40, leaf_size=6, device="cpu")
    with pytest.raises(ValueError, match="64-float slot"):
        ci.pack_dense(pt)
    heap = build_bvh(scene40, method="morton", device="cpu")
    with pytest.raises(ValueError, match="preorder"):
        ci.pack_dense(heap)


@pytest.mark.parametrize("leaf_size", [4, 5, 10, 16])
def test_layout_bytes_and_gates_match_jax(scene40, leaf_size):
    jt = jax_build_bvh(scene40, leaf_size=leaf_size)
    pt = port_tracer(jt)
    assert ci.dense_layout_bytes(pt) == jpi.dense_vmem_bytes(jt)
    assert ci.paired_layout_bytes(pt) == jpi.paired_vmem_bytes(jt)
    assert ci.resident_layout_bytes(pt) == jpi.vmem_bytes(jt)
    for mine, theirs in [
            (ci.paired_available, jpi.paired_available),
            (ci.dense_available, jpi.dense_available),
            (ci.resident_available, jpi.pallas_available),
            (ci.streamable, jpi.pallas_streamable),
            (ci.paired_streamed_available, jpi.paired_streamed_available),
            (ci.dense_streamed_available, jpi.dense_streamed_available)]:
        assert mine(pt) == theirs(jt), mine.__name__


@pytest.mark.parametrize("kind", ["random", "camera"])
def test_streamed_plain_matches_pallas(scene40, kind):
    """The stackless packet walk at the Pallas tile's width (128 lanes per
    cursor) against the streamed Pallas kernel with 64-row windows. Same
    visiting order and arithmetic: the same faces."""
    jt = jax_build_bvh(scene40)
    o, d = _rays(kind)
    jr = jpi.pallas_ray_trace_streamed(
        jt, jnp.asarray(o), jnp.asarray(d), tile=128, interpret=True,
        node_win=64, tri_win=64)
    counts = {}
    t, u, v, f = ci.trace_streamed_plain(
        port_tracer(jt), tt(o), tt(d), counts=counts, width=128,
        node_win=64, leaf_win=64)
    assert_hits_agree(np.asarray(jr[0]), np.asarray(jr[3]), t, f)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jr[3]))
    # forward-only windows: many crossings, none twice
    n_windows = -(-jt.n_nodes // 64)
    assert n_windows > 4
    n_packets = o.shape[0] // 128
    assert n_packets < counts["node_loads"] <= n_packets * n_windows
    assert counts["visits"] >= counts["node_loads"]


@pytest.mark.parametrize("kind", ["random", "camera"])
@pytest.mark.parametrize("leaf_size", [4, 5])
def test_dense_plain_matches_pallas(scene40, kind, leaf_size):
    jt = jax_build_bvh(scene40, leaf_size=leaf_size)
    o, d = _rays(kind)
    jr = jpi.pallas_ray_trace_dense(jt, jnp.asarray(o), jnp.asarray(d),
                                    tile=128, interpret=True)
    t, u, v, f = ci.trace_dense_plain(port_tracer(jt), tt(o), tt(d))
    assert_hits_agree(np.asarray(jr[0]), np.asarray(jr[3]), t, f)


@pytest.mark.parametrize("kind", ["random", "camera"])
def test_dense_streamed_plain_matches_pallas(scene40, kind):
    """The dense packet walk at width 128 against the dense streamed
    Pallas kernel with 8-row windows (64 pairs, 16 leaves)."""
    jt = jax_build_bvh(scene40)
    o, d = _rays(kind)
    jr = jpi.pallas_ray_trace_dense_streamed(
        jt, jnp.asarray(o), jnp.asarray(d), tile=128, interpret=True,
        pair_win=8, leaf_win=8)
    counts = {}
    t, u, v, f = ci.trace_dense_streamed_plain(
        port_tracer(jt), tt(o), tt(d), counts=counts, width=128, pair_win=8,
        leaf_win=8)
    assert_hits_agree(np.asarray(jr[0]), np.asarray(jr[3]), t, f)
    # the packet takes the Pallas tile's turns: the same faces
    np.testing.assert_array_equal(f.numpy(), np.asarray(jr[3]))
    assert counts["pops"] > 0
    assert 2 < counts["pair_loads"] <= counts["pops"]
    assert counts["leaf_loads"] > 2


def test_new_walks_find_their_twins_hits(scene40):
    """Bit for bit: trace_streamed finds trace_union's hits at any packet
    width and window size, trace_dense trace_paired's, and
    trace_dense_streamed trace_paired_streamed's; a ragged last packet
    (1000 rays) changes nothing."""
    pt = build_bvh(scene40, device="cpu")
    o, d = random_rays(1000, seed=13)
    o, d = tt(o), tt(d)

    def same(a, b):
        assert a[0].shape == (1000,)
        for x, y in zip(a, b):
            assert torch.equal(x, y)

    union = ci.trace_union_plain(pt, o, d)
    for width, node_win, leaf_win in ((32, 64, 8), (8, 16, 4), (128, 8, 64)):
        same(ci.trace_streamed_plain(pt, o, d, width=width,
                                     node_win=node_win, leaf_win=leaf_win),
             union)
    same(ci.trace_dense_plain(pt, o, d), ci.trace_paired_plain(pt, o, d))
    for width in (32, 8):
        twin = ci.trace_paired_streamed_plain(pt, o, d, width=width)
        for pair_win, leaf_win in ((4, 4), (1, 2)):
            same(ci.trace_dense_streamed_plain(
                pt, o, d, width=width, pair_win=pair_win, leaf_win=leaf_win),
                twin)
    for walk in (ci.trace_streamed_plain, ci.trace_dense_streamed_plain):
        with pytest.raises(ValueError, match="power of two"):
            walk(pt, o, d, width=24)


def test_counts_of_the_dense_walks(scene40):
    """The per-ray counts the roofline bound reads: trace_dense_plain's are
    trace_paired_plain's; the packet walks count window reloads."""
    pt = build_bvh(scene40, device="cpu")
    o, d = random_rays(512, seed=3)
    o, d = tt(o), tt(d)
    c_pair, c_dense, c_ds, c_s, c_u = {}, {}, {}, {}, {}
    ci.trace_paired_plain(pt, o, d, counts=c_pair)
    ci.trace_dense_plain(pt, o, d, counts=c_dense)
    ci.trace_dense_streamed_plain(pt, o, d, counts=c_ds)
    ci.trace_streamed_plain(pt, o, d, counts=c_s)
    ci.trace_union_plain(pt, o, d, counts=c_u)
    assert c_dense == c_pair
    # a packet walks the union of its rays' paths
    assert c_ds["slab"] >= c_pair["slab"] and c_s["slab"] >= c_u["slab"]
    assert set(c_ds) == {"slab", "mt", "pops", "pair_loads", "leaf_loads",
                         "pair_loads_next", "leaf_loads_next", "far_pops",
                         "next_pops", "max_stack"}
    assert set(c_s) == {"slab", "mt", "visits", "node_loads", "leaf_loads",
                        "node_loads_next", "leaf_loads_next",
                        "backward_loads", "longest_walk"}


def test_new_plain_walks_match_brute(scene40):
    pt = build_bvh(scene40, device="cpu")
    o, d = random_rays(1024, seed=11)
    _, _, _, ib, vb = ray_intersect_brute(tt(scene40), tt(o), tt(d))
    for walk in (ci.trace_streamed_plain, ci.trace_dense_plain,
                 ci.trace_dense_streamed_plain):
        t, _, _, f = walk(pt, tt(o), tt(d))
        np.testing.assert_array_equal((f >= 0).numpy(), vb.numpy())
        assert (f.long() == ib)[vb].float().mean() > 0.99


def test_cpu_wrappers_take_the_plain_versions(scene40):
    pt = build_bvh(scene40, device="cpu")
    o, d = random_rays(64, seed=2)
    for name in ("trace_streamed", "trace_dense", "trace_dense_streamed"):
        wrapper = getattr(ci, name)
        before = ci.launch_counts()[name]
        got = wrapper(pt, tt(o), tt(d))
        want = getattr(ci, name + "_plain")(pt, tt(o), tt(d))
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert ci.launch_counts()[name] == before   # no kernel launched
    assert set(ci.KERNELS) == {
        "trace_union", "trace_streamed", "trace_ordered", "trace_paired",
        "trace_paired_streamed", "trace_dense", "trace_dense_streamed"}


# ------------------------------------------------------------- the policy

P = TraversalPolicy


@pytest.fixture(scope="module")
def trees():
    """Port tracers by name: a 5,054-face tree at leaf sizes 4, 6 and 16,
    its heap twin, and a small tree."""
    big, _ = make_box_scene(n_clutter=420, seed=1)
    small, _ = make_box_scene(n_clutter=12, seed=1)
    out = {"small": build_bvh(small.triangles(), device="cpu"),
           "heap": build_bvh(big.triangles(), method="morton", device="cpu")}
    for leaf_size in (4, 6, 16):
        out[f"big{leaf_size}"] = build_bvh(big.triangles(),
                                           leaf_size=leaf_size, device="cpu")
    return out


@pytest.fixture
def reduced_gates(trees):
    """All three 10 MiB gates moved (the constants, not the rule) to sit
    between the 5,054-face tree's dense layout and its paired layout, which
    is where the 102,014-face tree sits between the real gates: dense fits,
    paired and the resident rows do not."""
    t = trees["big4"]
    gate = (ci.dense_layout_bytes(t) + ci.paired_layout_bytes(t)) // 2
    assert ci.dense_layout_bytes(t) <= gate < ci.paired_layout_bytes(t) \
        < ci.resident_layout_bytes(t)
    old = (ci.PAIRED_RESIDENT_BYTES, ci.DENSE_RESIDENT_BYTES,
           ci.RESIDENT_BYTES)
    ci.PAIRED_RESIDENT_BYTES = ci.DENSE_RESIDENT_BYTES = ci.RESIDENT_BYTES \
        = gate
    yield gate
    ci.PAIRED_RESIDENT_BYTES, ci.DENSE_RESIDENT_BYTES, ci.RESIDENT_BYTES = old


# (tree, policy, kernel, mode, the line of _pallas_mode or ray_intersect
# (iris_tpu/geometry/intersect.py) that decides)
REDUCED = [
    ("big4", P(), "trace_paired_streamed", "paired_streamed", ":436-439"),
    ("big4", P(paired_streamed=False), "trace_dense", "dense", ":440-449"),
    ("big4", P(paired_streamed=False, dense=False), "trace_streamed",
     "streamed", ":450-465"),
    ("big4", P(paired_streamed=False, dense=False, dense_streamed=True),
     "trace_dense_streamed", "dense_streamed", ":459-461"),
    ("big4", P(dense=True), "trace_dense", "dense", ":412"),
    ("big4", P(dense=False, dense_streamed=True), "trace_paired_streamed",
     "paired_streamed", ":436 before :459"),
    ("big6", P(paired_streamed=False, dense_streamed=True),
     "trace_streamed", "streamed", ":460 (72-float leaf), :465"),
    ("big6", P(), "trace_paired_streamed", "paired_streamed", ":436"),
    ("big16", P(), "trace_ordered", "streamed",
     ":465, where pallas_intersect.py:386 asserts"),
    ("heap", P(), "trace_union", None, ":466"),
    ("small", P(), "trace_union", "resident", ":450, :522"),
    ("small", P(paired=True), "trace_paired", "paired", ":421"),
]

DEFAULT_GATES = [
    ("small", P(), "trace_union", "resident", ":450, :522"),
    ("small", P(paired=True), "trace_paired", "paired", ":421"),
    ("small", P(dense=True), "trace_dense", "dense", ":412"),
    ("big4", P(), "trace_paired", "paired", ":414-423"),
    ("big4", P(paired=False), "trace_ordered", "resident", ":450, :516"),
    ("big4", P(dense=True), "trace_dense", "dense", ":412"),
    ("big4", P(paired_streamed=False, dense_streamed=True), "trace_paired",
     "paired", ":414 before :459"),
    ("big6", P(dense=True), "trace_paired", "paired",
     ":412 (72-float leaf), :414"),
    ("big16", P(), "trace_ordered", "resident", ":450, :516"),
    ("big16", P(paired=True, dense=True), "trace_ordered", "resident",
     ":412, :414 (192-float leaf), :450"),
    ("heap", P(), "trace_union", "resident", ":450, :522"),
    ("heap", P(paired=True, dense=True, dense_streamed=True), "trace_union",
     "resident", ":450, :522"),
]


def _ids(rows):
    return [f"{r[0]}-{r[2]}-{i}" for i, r in enumerate(rows)]


@pytest.mark.parametrize("tree,policy,kernel,mode,line", REDUCED,
                         ids=_ids(REDUCED))
def test_policy_at_reduced_gates(trees, reduced_gates, tree, policy, kernel,
                                 mode, line):
    t = dataclasses.replace(trees[tree], policy=policy)
    assert traversal_mode(t) == mode, line
    assert kernel_for(t).__name__ == kernel, line


@pytest.mark.parametrize("tree,policy,kernel,mode,line", DEFAULT_GATES,
                         ids=_ids(DEFAULT_GATES))
def test_policy_at_default_gates(trees, tree, policy, kernel, mode, line):
    assert (ci.PAIRED_RESIDENT_BYTES, ci.DENSE_RESIDENT_BYTES,
            ci.RESIDENT_BYTES) == (10 << 20,) * 3
    t = dataclasses.replace(trees[tree], policy=policy)
    assert traversal_mode(t) == mode, line
    assert kernel_for(t).__name__ == kernel, line


def test_policy_is_carried_frozen_and_checked(trees):
    t = trees["small"]
    assert t.policy == TraversalPolicy() == P("auto", "auto", True, False)
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.policy.dense = True
    with pytest.raises(ValueError, match="'auto', True or False"):
        TraversalPolicy(dense="1")
    mesh, _ = make_box_scene(n_clutter=12, seed=1)
    built = build_bvh(mesh.triangles(), device="cpu", policy=P(dense=True))
    assert built.policy.dense is True
    assert kernel_for(built) is ci.trace_dense
    # the replaced tracer shares the arrays and decides anew
    again = dataclasses.replace(built, policy=P())
    assert again.nodes is built.nodes and kernel_for(again) is ci.trace_union


def test_no_environment_variable_is_read():
    """The dials are TraversalPolicy fields: nothing in the port reads the
    environment but the lookups of build tools (nvcc, the C++ compiler)."""
    import pathlib
    import re

    import iris_tpu_torch

    root = pathlib.Path(iris_tpu_torch.__file__).parent
    hits = []
    for path in sorted(root.rglob("*.py")):
        for n, text in enumerate(path.read_text().splitlines(), 1):
            if re.search(r"os\.environ|getenv", text):
                hits.append((path.name, n, text.strip()))
    assert all("IRIS" not in text for _, _, text in hits), hits
    assert {name for name, _, _ in hits} <= {
        "cuda_intersect.py", "native_build.py", "bvh_native.py"}, hits
