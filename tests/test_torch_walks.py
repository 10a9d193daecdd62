"""The per-ray walks of the PyTorch port (CPU, plain versions, small
trees): the pop counts and what they make of a warp's steps (warp_counts),
on the 7-node tree of tests/test_torch_packets.py walked by hand; the pair
records of the ordered walk for any leaf size, against the records read
straight from the nodes; a deep chain tree (the deepest the kernels'
stacks admit is built the same way in tests/test_torch_cuda.py); and the
leaf sizes walk_config admits against the kernels traverse.cu
instantiates."""

import numpy as np
import pytest
import torch

from iris_tpu_torch.geometry import cuda_intersect as ci
from iris_tpu_torch.geometry.bvh import Tracer, build_bvh
from iris_tpu_torch.geometry.procedural import (
    camera_rays, make_box_scene, random_rays)
from test_torch_packets import _hand_rays, _hand_tree
from torch_parity import tt


def chain_tree(depth: int, leaf_size: int = 1, device="cpu") -> Tracer:
    """A preorder tree of the given depth: a spine of `depth` internal
    nodes n_0 .. n_{depth-1}, n_i with leaf i as its left child and n_{i+1}
    as its right one (n_{depth-1}: leaves depth-1 and depth). Leaf i holds
    one unit right triangle at x = i in the plane z = 0 (face i), then
    leaf_size - 1 padding rows."""
    d, L = depth, leaf_size
    n = 2 * d + 1

    def box(x0, x1):
        return [x0, 0.0, -0.1, x1, 1.0, 0.1]

    nodes = np.zeros((n, 8), np.float32)
    for i in range(d):
        nodes[2 * i] = box(i, d + 1) + [0, 2 * i + 2]        # n_i
        nodes[2 * i + 1] = box(i, i + 1) + [2 * i + 3, -i * L]  # leaf i
    nodes[2 * d] = box(d, d + 1) + [0, -d * L]             # leaf depth
    tris = np.zeros(((d + 1) * L, 12), np.float32)
    tris[:, 9] = -1.0
    for i in range(d + 1):
        tris[i * L] = [i, 0, 0, 1, 0, 0, 0, 1, 0, i, 0, 0]
    normals = np.tile(np.float32([0, 0, 1]), (d + 1, 1))
    return Tracer(nodes=torch.from_numpy(nodes).to(device),
                  tris=torch.from_numpy(tris).to(device),
                  face_normals=torch.from_numpy(normals).to(device),
                  n_nodes=n, leaf_size=L, n_faces=d + 1, layout="preorder",
                  depth=d)


def chain_rays(depth: int, n: int, seed: int = 0):
    """Rays down onto the chain's triangles and rays along it (each enters
    every box, so every level pushes a far child), from a seed."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, depth + 1.5, n)
    y = rng.uniform(0.05, 0.95, n)
    down = np.stack([x, y, np.full(n, 3.0)], 1)
    along = np.stack([np.full(n, depth + 3.0), y, rng.uniform(0.01, 0.09, n)],
                     1)
    o = np.concatenate([down, along]).astype(np.float32)
    d_down = np.tile([0.0, 0.0, -1.0], (n, 1))
    d_along = np.stack([np.full(n, -1.0), np.zeros(n),
                        -rng.uniform(1e-3, 1e-2, n)], 1)
    d = np.concatenate([d_down, d_along]).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tt(o), tt(d)


# ---------------------------------------------------- pops and warp steps

@pytest.mark.parametrize("walk,pops", [
    ("trace_paired_plain", [2, 2, 2, 1]), ("trace_dense_plain", [2, 2, 2, 1]),
    ("trace_ordered_plain", [3, 3, 3, 1]),
    ("trace_union_plain", [5, 5, 5, 1])])
def test_pop_counts_on_a_tree_walked_by_hand(walk, pops):
    """The pair walks pop the root's record, then L's (rays onto A) or R's
    (the ray onto D); the ray past the tree pops the root's alone. The
    ordered walk pops root, L, A (or root, R, D), and the root alone for
    the ray that misses it. The union walk visits root, L, A, then B and
    R by skip pointers (rays onto A), or root, L (missed), R, C (missed),
    D (the ray onto D): five visits; the root alone for the ray past the
    tree. 32 copies of one ray keep every lane busy; 33
    rays make a ragged second warp that steps as long as the first."""
    tracer = _hand_tree()
    o, d = _hand_rays()
    c = {}
    t, _, _, f = getattr(ci, walk)(tracer, o, d, counts=c)
    assert f.tolist() == [0, 0, 3, -1]
    longest = max(pops)
    assert (c["pops"], c["warp_steps"]) == (sum(pops), longest)
    assert c["lane_busy"] == sum(pops) / (32 * longest)
    for n, steps in ((32, 1), (33, 2)):
        c = {}
        getattr(ci, walk)(tracer, o[:1].repeat(n, 1), d[:1].repeat(n, 1),
                          counts=c)
        assert c["pops"] == n * pops[0]
        assert c["warp_steps"] == steps * pops[0]
        assert c["lane_busy"] == n / (32 * steps)


@pytest.mark.parametrize("method", ["sah", "morton"])
@pytest.mark.parametrize("kind", ["random", "camera"])
def test_union_pops_are_its_slab_tests(method, kind):
    """trace_union_plain visits one node per slab test: on the flagship
    tree (398 faces), preorder and heap, its per-ray visits sum to its
    slab count, and a warp steps as long as its longest walk."""
    mesh, _ = make_box_scene(n_clutter=32, seed=0)
    tracer = build_bvh(mesh.triangles(), method=method, device="cpu")
    assert tracer.n_faces == 398
    o, d = (random_rays(1000, seed=6) if kind == "random"
            else camera_rays(24)[:2])
    c = {}
    ci.trace_union_plain(tracer, tt(o), tt(d), counts=c)
    assert c["pops"] == c["slab"] > 0
    assert c["pops"] / o.shape[0] > 1
    assert c["warp_steps"] * 32 >= c["pops"]
    assert 0 < c["lane_busy"] <= 1


def test_warp_counts_of_ragged_runs():
    pops = torch.tensor([5] + [1] * 31 + [2, 7, 0])
    assert ci.warp_counts(pops) == {"pops": 45, "warp_steps": 12,
                                    "lane_busy": 45 / (32 * 12)}
    assert ci.warp_counts(torch.zeros(0, dtype=torch.int64)) == {
        "pops": 0, "warp_steps": 0, "lane_busy": 0.0}


def test_ordered_counts_take_the_kernels_tests():
    """trace_ordered_plain counts the slab tests of the kernel's walk: one
    at the root per ray and two per internal node entered (the pop-time
    test is a compare of the pushed entry distance)."""
    tracer = _hand_tree()
    o, d = _hand_rays()
    c = {}
    ci.trace_ordered_plain(tracer, o, d, counts=c)
    # rays 0-2 enter the root and one inner node, ray 3 nothing
    assert c["slab"] == 4 + 3 * 2 * 2
    assert c["mt"] == 3


# --------------------------------------------------- the ordered records

def _records_from_nodes(tracer):
    """Pair records read straight from the nodes, one internal node at a
    time in preorder: both children's boxes and their desc' (internal:
    its record + 1; leaf: -(first triangle row / leaf_size))."""
    nodes = tracer.nodes.numpy()
    internal = np.flatnonzero(nodes[:, 7] > 0)
    rec_of = {int(k): r for r, k in enumerate(internal)}
    out = []
    for k in internal:
        left = int(nodes[k, 7]) - 1
        right = int(nodes[left, 6]) - 1
        row = []
        for c in (left, right):
            code = (rec_of[c] + 1 if nodes[c, 7] > 0
                    else -(-nodes[c, 7] / tracer.leaf_size))
            row += list(nodes[c, :6]) + [code, 0.0]
        out.append(row)
    return torch.tensor(np.float32(out))


@pytest.mark.parametrize("leaf_size", [1, 4, 10, 16, 32])
def test_ordered_records_are_exact_for_any_leaf_size(leaf_size):
    mesh, _ = make_box_scene(n_clutter=30, seed=5)
    tracer = build_bvh(mesh.triangles(), leaf_size=leaf_size, device="cpu")
    rec = ci.pair_records(tracer)
    assert tracer.pairs16 is rec                    # cached on the tracer
    want = _records_from_nodes(tracer)
    assert rec.shape == (tracer.n_nodes // 2, 16)
    assert torch.equal(rec, want)
    # leaf rows address whole leaves of tris
    codes = torch.cat([rec[:, 6], rec[:, 14]])
    leaf_rows = (-codes[codes <= 0]).long()
    assert int(leaf_rows.max()) < tracer.tris.shape[0] // leaf_size
    if leaf_size * 12 <= 128:
        # where the paired layout applies, the records are its rows
        fresh = build_bvh(mesh.triangles(), leaf_size=leaf_size,
                          device="cpu")
        pairs16, _, n_pairs, _ = ci.pack_paired_compact(fresh)
        assert torch.equal(pairs16, want) and n_pairs == rec.shape[0]
    else:
        with pytest.raises(ValueError, match="leaf row"):
            ci.pack_paired_compact(tracer)
        assert not ci.paired_available(tracer)


def test_ordered_walk_of_a_leaf_root_and_a_deep_chain():
    """A one-node tree (the root is a leaf) and a chain of depth 40: the
    ordered walk finds the union walk's hits, and on the chain the paired
    and dense walks find the same bits."""
    mesh, _ = make_box_scene(n_clutter=0, seed=1)
    one = build_bvh(mesh.triangles()[:2], leaf_size=2, device="cpu")
    assert one.n_nodes == 1
    o, d = random_rays(256, seed=4)
    t, _, _, f = ci.trace_ordered_plain(one, tt(o), tt(d))
    u = ci.trace_union_plain(one, tt(o), tt(d))
    assert torch.equal(f, u[3]) and torch.equal(t, u[0])
    chain = chain_tree(40)
    o, d = chain_rays(40, 300)
    c = {}
    want = ci.trace_ordered_plain(chain, o, d, counts=c)
    assert int((want[3] >= 0).sum()) > 200
    assert c["pops"] > 40 * 300             # the rays along the chain
    for walk in (ci.trace_paired_plain, ci.trace_dense_plain):
        for g, w in zip(walk(chain, o, d), want):
            assert torch.equal(g, w)
    assert ci.walk_stack_depth(chain) == 44



# ------------------------------------------- the kernels' instantiations

def test_walk_config_names_the_instantiated_leaf_sizes():
    """walk_config admits the leaf sizes traverse.cu instantiates for the
    pair walk (the cases of paired_kernel_of and dense_kernel_of), and
    trace_ordered's one kernel at any leaf size."""
    import re

    with open(ci.SOURCE) as f:
        src = f.read()
    for name, of in (("trace_paired", "paired_kernel_of"),
                     ("trace_dense", "dense_kernel_of")):
        body = src[src.index(f"inline WalkKernel {of}("):]
        body = body[:body.index("default:")]
        cases = re.findall(rf"case (\d+): return {name}_kernel<(\d+)>",
                           body)
        assert all(c == t for c, t in cases)
        assert [int(c) for c, _ in cases] == list(ci._WALK_LEAVES[name])
    assert "trace_ordered" not in ci._WALK_LEAVES
    # the union walk: leaves of 1-10 triangles unrolled, any other leaf
    # size by the runtime-size instantiation
    body = src[src.index("inline UnionKernel union_kernel_of("):]
    body = body[:body.index("\n}")]
    cases = re.findall(r"case (\d+): return trace_union_kernel<(\d+)>", body)
    assert all(c == t for c, t in cases)
    assert [int(c) for c, _ in cases] == list(range(1, 11))
    assert "leaf_size >= 1 ? trace_union_kernel<0> : nullptr" in body
    assert "trace_union" not in ci._WALK_LEAVES


@pytest.mark.parametrize("name, leaf_size", [
    ("trace_dense", 6), ("trace_paired", 11), ("trace_paired", 0),
    ("trace_ordered", 0), ("trace_union", 0), ("trace_union", -4),
    ("trace_streamed", 4)])
def test_walk_config_refuses_what_has_no_kernel(name, leaf_size):
    """Refused on the host, before the library is built or a card asked."""
    with pytest.raises(ValueError):
        ci.walk_config(name, leaf_size)
