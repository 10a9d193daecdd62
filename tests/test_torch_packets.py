"""The packet walks of the PyTorch port at every packet width the CUDA
kernels instantiate (CPU, plain versions, small trees): trace_streamed's
hits are the per-ray walk's bit for bit at any width, the pair walks agree
with the per-ray paired walk off equal-t ties, the counters of window
reloads, forward reloads and far pops obey their invariants and match a
7-node tree walked by hand, and the widths and window sizes of
cuda_intersect.py are the constants of csrc/traverse.cu.

Bar off ties (tests/torch_parity.assert_hits_agree): hit/miss equal on
>= 99.9% of rays, t within 1e-5 relative where both hit, face ids equal
except at t ties within 1e-6."""

import pathlib
import re

import numpy as np
import pytest
import torch

from iris_tpu_torch.geometry import cuda_intersect as ci
from iris_tpu_torch.geometry.bvh import Tracer, build_bvh
from iris_tpu_torch.geometry.intersect import spatial_sort_perm
from iris_tpu_torch.geometry.procedural import camera_rays, make_box_scene
from torch_parity import assert_hits_agree, tt

WIDTHS = ci.PACKET_WIDTHS


@pytest.fixture(scope="module")
def tree():
    """~500 faces with 4-triangle leaves: ~250 leaves, ~500 nodes."""
    mesh, _ = make_box_scene(n_clutter=40, seed=3)
    return build_bvh(mesh.triangles(), device="cpu")


@pytest.fixture(scope="module")
def bounce_rays(tree):
    """Secondary rays as a train step traces them: from the camera rays'
    hit points in random directions, in spatial_sort_perm order; 1,003
    rays, so the last packet is ragged at every width."""
    o, d = (tt(x) for x in camera_rays(40)[:2])
    t, _, _, face = ci.trace_union_plain(tree, o, d)
    hit = face >= 0
    rng = np.random.default_rng(7)
    dirs = rng.normal(size=(int(hit.sum()), 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    xs = (o + 0.999 * t[:, None] * d)[hit][:1003].contiguous()
    ds = tt(dirs)[:1003].contiguous()
    perm = spatial_sort_perm(tree, xs, ds)
    assert xs.shape[0] == 1003
    return xs[perm].contiguous(), ds[perm].contiguous()


@pytest.mark.parametrize("width", WIDTHS)
def test_streamed_plain_is_the_per_ray_walk_bit_for_bit(tree, bounce_rays,
                                                        width):
    o, d = bounce_rays
    want = ci.trace_union_plain(tree, o, d)
    counts = {}
    got = ci.trace_streamed_plain(tree, o, d, counts=counts, width=width)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[3] >= 0).sum()) > 500
    # the windows default to the kernel's at this width
    again = {}
    ci.trace_streamed_plain(tree, o, d, counts=again, width=width,
                            node_win=ci.node_win_for(width),
                            leaf_win=ci.leaf_win_for(width))
    assert again == counts


@pytest.mark.parametrize("walk", ["trace_paired_streamed_plain",
                                  "trace_dense_streamed_plain"])
@pytest.mark.parametrize("width", WIDTHS)
def test_pair_packet_walks_agree_with_the_per_ray_walk(tree, bounce_rays,
                                                       width, walk):
    o, d = bounce_rays
    want = ci.trace_paired_plain(tree, o, d)
    got = getattr(ci, walk)(tree, o, d, width=width)
    assert got[0].shape == (1003,)
    assert_hits_agree(want[0], want[3], got[0], got[3])
    # both layouts hold the same records: the same turns, the same bits
    twin = ci.trace_paired_streamed_plain(tree, o, d, width=width)
    for g, w in zip(got, twin):
        assert torch.equal(g, w)


@pytest.mark.parametrize("width", WIDTHS)
def test_streamed_counts_obey_their_invariants(tree, bounce_rays, width):
    o, d = bounce_rays
    c, per_ray = {}, {}
    ci.trace_streamed_plain(tree, o, d, counts=c, width=width)
    ci.trace_union_plain(tree, o, d, counts=per_ray)
    n_packets = -(-o.shape[0] // width)
    assert c["backward_loads"] == 0          # windows only move forward
    assert 0 <= c["node_loads_next"] <= c["node_loads"] <= c["visits"]
    assert 0 <= c["leaf_loads_next"] <= c["leaf_loads"] <= c["visits"]
    assert c["node_loads"] >= n_packets      # every packet loads the root
    assert c["slab"] == c["visits"] * width - \
        _padding_tests(c, o.shape[0], width)
    # a packet walks the union of its rays' paths, never less
    assert c["slab"] >= per_ray["slab"] and c["mt"] == per_ray["mt"]
    assert c["visits"] / n_packets <= c["longest_walk"] <= tree.n_nodes


def _padding_tests(c, n_rays, width):
    """Lane tests the padding lanes of the ragged last packet do not make:
    that packet's visits times its padding lanes."""
    pad = (-n_rays) % width
    if not pad:
        return 0
    assert (c["visits"] * width - c["slab"]) % pad == 0
    return c["visits"] * width - c["slab"]


@pytest.mark.parametrize("width", WIDTHS)
def test_pair_counts_obey_their_invariants(tree, bounce_rays, width):
    o, d = bounce_rays
    c, per_ray = {}, {}
    ci.trace_paired_streamed_plain(tree, o, d, counts=c, width=width)
    ci.trace_paired_plain(tree, o, d, counts=per_ray)
    n_packets = -(-o.shape[0] // width)
    assert 0 <= c["pair_loads_next"] <= c["pair_loads"] <= c["pops"]
    assert 0 <= c["leaf_loads_next"] <= c["leaf_loads"]
    # every pop but a packet's root is of a far or of a near child
    assert c["far_pops"] + c["next_pops"] <= c["pops"] - n_packets
    assert 0 < c["far_pops"] < c["pops"] and c["next_pops"] > 0
    assert c["slab"] >= per_ray["slab"]
    assert 2 <= c["max_stack"] <= tree.depth + 1


def test_narrower_packets_walk_smaller_unions(tree, bounce_rays):
    """Lane slab tests fall and visits rise as the packet narrows, down to
    the per-ray walk's own tests at width 1."""
    o, d = bounce_rays
    per_ray = {}
    ci.trace_union_plain(tree, o, d, counts=per_ray)
    slab, visits = [], []
    for width in (1,) + WIDTHS:
        c = {}
        ci.trace_streamed_plain(tree, o, d, counts=c, width=width)
        slab.append(c["slab"])
        visits.append(c["visits"])
    assert slab[0] == per_ray["slab"] == visits[0]
    assert slab == sorted(slab) and visits == sorted(visits, reverse=True)


# ------------------------------------------------- a tree walked by hand

def _hand_tree():
    """Seven nodes in preorder, one triangle per leaf, four unit right
    triangles in the plane z = 0 at x = 0, 2, 4, 6:

        1 root ─┬─ 2 L ─┬─ 3 leaf A (x 0..1)
                │       └─ 4 leaf B (x 2..3)
                └─ 5 R ─┬─ 6 leaf C (x 4..5)
                        └─ 7 leaf D (x 6..7)
    """
    def box(x0, x1):
        return [x0, 0.0, -0.1, x1, 1.0, 0.1]

    # [min, max, skip, desc], cursors 1-based, leaf desc = -first row
    nodes = torch.tensor([
        box(0, 7) + [0, 2], box(0, 3) + [5, 3], box(0, 1) + [4, -0.0],
        box(2, 3) + [5, -1], box(4, 7) + [0, 6], box(4, 5) + [7, -2],
        box(6, 7) + [0, -3]], dtype=torch.float32)
    tris = torch.tensor([[x, 0, 0, 1, 0, 0, 0, 1, 0, f, 0, 0]
                         for f, x in enumerate((0, 2, 4, 6))],
                        dtype=torch.float32)
    normals = torch.tensor([[0.0, 0.0, 1.0]] * 4)
    return Tracer(nodes=nodes, tris=tris, face_normals=normals, n_nodes=7,
                  leaf_size=1, n_faces=4, layout="preorder", depth=2)


def _hand_rays():
    """One packet of four: two rays down onto A, one onto D, one past the
    tree."""
    o = torch.tensor([[0.25, 0.25, 5], [0.5, 0.25, 5], [6.25, 0.25, 5],
                      [10, 0.25, 5]], dtype=torch.float32)
    d = torch.tensor([[0.0, 0.0, -1.0]] * 4)
    return o, d


def test_streamed_counts_on_a_tree_walked_by_hand():
    """The packet visits all seven nodes in storage order (root, L, A, B,
    R, C, D: every internal node is entered by some lane, B and C are
    tested and missed): 7 visits x 4 lanes, triangle tests by the lanes
    that entered A (2) and D (1). Two-node windows are loaded for nodes
    {1,2}, {3,4}, {5,6}, {7}: four loads, each but the first the window
    right after the one held. One-leaf windows: A, then D, which is not
    the window after A's."""
    tracer = _hand_tree()
    o, d = _hand_rays()
    c = {}
    t, u, v, f = ci.trace_streamed_plain(tracer, o, d, counts=c, width=4,
                                         node_win=2, leaf_win=1)
    assert f.tolist() == [0, 0, 3, -1]
    assert t[:3].tolist() == [5.0, 5.0, 5.0] and u[0] == 0.25 and v[0] == 0.25
    assert c == dict(slab=28, mt=3, visits=7, node_loads=4, leaf_loads=2,
                     node_loads_next=3, leaf_loads_next=0, backward_loads=0,
                     longest_walk=7)
    # a window that holds the whole tree is loaded once
    ci.trace_streamed_plain(tracer, o, d, counts=c, width=4, node_win=8,
                            leaf_win=4)
    assert (c["node_loads"], c["node_loads_next"], c["leaf_loads"]) == \
        (1, 0, 1)
    # two packets of two. The first visits root, L, A, B and tests R and
    # misses it (windows {1,2}, {3,4}, {5,6}: three loads, two forward);
    # the second visits root, tests L and skips to R, C, D (windows {1,2},
    # {5,6}, {7}: three loads, the last one forward)
    ci.trace_streamed_plain(tracer, o, d, counts=c, width=2, node_win=2,
                            leaf_win=1)
    assert (c["visits"], c["slab"], c["mt"]) == (5 + 5, 20, 3)
    assert (c["node_loads"], c["node_loads_next"]) == (3 + 3, 2 + 1)
    assert c["longest_walk"] == 5


@pytest.mark.parametrize("walk", ["trace_paired_streamed_plain",
                                  "trace_dense_streamed_plain"])
def test_pair_counts_on_a_tree_walked_by_hand(walk):
    """Three pair records: (L, R), (A, B), (C, D). The packet pops the
    root's record; lanes 0-1 enter L and lane 2 enters R at the same mean
    distance, so L is near (<=): R is pushed as the far child, L as the
    near one, and L's record is the row after the root's. Then L's record
    (A folded by two lanes, B missed), then R's, a far pop (C missed, D
    folded by one lane)."""
    tracer = _hand_tree()
    o, d = _hand_rays()
    c = {}
    kw = dict(pair_win=1, leaf_win=1)
    if walk == "trace_paired_streamed_plain":
        t, u, v, f = ci.trace_paired_streamed_plain(tracer, o, d, counts=c,
                                                    width=4, **kw)
    else:
        # the dense walk counts its windows in dense rows: one row is 8
        # pair records or 2 leaves, so all three records share a window
        # and A (leaf 0) and D (leaf 3) lie in rows 0 and 1
        t, u, v, f = ci.trace_dense_streamed_plain(tracer, o, d, counts=c,
                                                   width=4, **kw)
    assert f.tolist() == [0, 0, 3, -1]
    want = dict(slab=24, mt=3, pops=3, pair_loads=3, leaf_loads=2,
                pair_loads_next=2, leaf_loads_next=0, far_pops=1,
                next_pops=1, max_stack=2)
    if walk == "trace_dense_streamed_plain":
        want.update(pair_loads=1, pair_loads_next=0, leaf_loads_next=1)
    assert c == want
    for g, w in zip((t, u, v, f), ci.trace_paired_plain(tracer, o, d)):
        assert torch.equal(g, w)


# --------------------------------------------- the kernels' constants

def _cu_constants():
    src = pathlib.Path(ci.SOURCE).read_text()
    return src, {k: int(v) for k, v in re.findall(
        r"^constexpr int (k\w+) = (\d+);", src, flags=re.M)}


def test_shipped_widths_are_the_kernels():
    _, k = _cu_constants()
    assert ci.STREAMED_PACKET == k["kStreamedPacket"]
    assert ci.PACKET == k["kPairPacket"]
    assert ci.STREAMED_PACKET in WIDTHS and ci.PACKET in WIDTHS
    assert ci.STREAMED_PACKET > 1 and ci.PACKET > 1


def test_window_sizes_are_the_kernels():
    src, k = _cu_constants()
    assert ci.PAIR_WIN_PER_LANE == k["kPairWinPerLane"]
    assert ci.LANES_PER_LEAF == k["kLanesPerLeaf"]
    assert ci.NODE_WIN == ci.node_win_for(ci.STREAMED_PACKET)
    assert ci.PAIR_WIN == ci.pair_win_for(ci.PACKET)
    assert ci.LEAF_WIN == ci.leaf_win_for(ci.PACKET)
    # the widths the source instantiates, in each kernel's switch
    for fn in ("streamed_kernel_of", "paired_streamed_kernel_of",
               "dense_streamed_kernel_of"):
        body = src[src.index(f"Kernel {fn}("):]
        body = body[:body.index("default:")]
        assert tuple(int(w) for w in re.findall(r"case (\d+):", body)) == \
            WIDTHS
    # each of the seven kernels is a __global__ function of its own name
    for name in ci.KERNELS:
        assert re.search(rf"__global__[^;{{]*?\b{name}_kernel\(", src), name
    # at a warp's width the windows are 64 nodes, 32 records, 8 leaves
    assert (ci.node_win_for(32), ci.pair_win_for(32), ci.leaf_win_for(32)) \
        == (64, 32, 8)
    assert [ci.leaf_win_for(w) for w in WIDTHS] == [1, 2, 4, 8]


@pytest.mark.parametrize("name", ["trace_streamed", "trace_paired_streamed",
                                  "trace_dense_streamed"])
def test_cpu_wrappers_take_width_and_refuse_unknown_widths(tree, name):
    """On CPU tensors a wrapper takes its plain version at the asked width
    (the shipped one by default) and launches nothing; a launch's width
    lookup refuses widths the source does not instantiate."""
    o, d = (tt(x) for x in camera_rays(8)[:2])
    wrapper, plain = getattr(ci, name), getattr(ci, name + "_plain")
    shipped = ci.STREAMED_PACKET if name == "trace_streamed" else ci.PACKET
    before = ci.launch_counts()[name]
    for width in (None, 4, 32):
        got = wrapper(tree, o, d, width=width)
        want = plain(tree, o, d, width=shipped if width is None else width)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert ci.launch_counts()[name] == before
    assert ci._packet_width(name, None) == 0     # the kernel's own constant
    assert ci._packet_width(name, shipped) == shipped
    with pytest.raises(ValueError, match="packet width"):
        ci._packet_width(name, 2)
