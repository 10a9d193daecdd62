"""Card-only checks of the port's CUDA traversal kernels against their
plain PyTorch versions (marked `cuda`; each test skips without a card).
The full-size comparison runs in chip_smoke.py; these are small and quick:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from iris_tpu_torch.geometry import cuda_intersect as ci
from iris_tpu_torch.geometry.bvh import build_bvh
from iris_tpu_torch.geometry.procedural import (
    camera_rays, make_box_scene, random_rays)
from test_torch_walks import chain_rays, chain_tree

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n_clutter,method", [(12, "sah"), (12, "morton"),
                                              (500, "sah")])
def test_kernels_match_plain(card, n_clutter, method):
    mesh, _ = make_box_scene(n_clutter=n_clutter, seed=4)
    tracer = build_bvh(mesh.triangles(), method=method, device=card)
    o1, d1 = random_rays(2048, seed=1)
    o2, d2, *_ = camera_rays(40)
    o = torch.from_numpy(np.concatenate([o1, o2])).to(card)
    d = torch.from_numpy(np.concatenate([d1, d2])).to(card)
    walks = [(ci.trace_union, ci.trace_union_plain)]
    if method == "sah":
        walks.append((ci.trace_paired, ci.trace_paired_plain))
    for kernel, plain in walks:
        got = kernel(tracer, o, d)
        torch.cuda.synchronize()
        want = plain(tracer, o, d)
        # built with --fmad=false: the same float operations in the same
        # order, so the same bits
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("leaf_size", [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 16])
def test_union_matches_plain_at_every_leaf_size(card, leaf_size):
    """trace_union at every unrolled leaf size (1-10) and past them (16,
    the runtime-size fold), on the flagship scene's tree (398 faces, under
    48 KB: the size the previous kernel staged in shared memory), on a
    6,014-face preorder tree and on its Morton tree (past 48 KB); 2,600
    rays, not a multiple of the block, bit for bit."""
    o1, d1 = random_rays(1000, seed=11)
    o2, d2, *_ = camera_rays(40)
    o = torch.from_numpy(np.concatenate([o1, o2])).to(card)
    d = torch.from_numpy(np.concatenate([d1, d2])).to(card)
    for n_clutter, method in ((32, "sah"), (500, "sah"), (500, "morton")):
        mesh, _ = make_box_scene(n_clutter=n_clutter, seed=4)
        tracer = build_bvh(mesh.triangles(), leaf_size=leaf_size,
                           method=method, device=card)
        tree = tracer.n_nodes * 32 + tracer.tris.shape[0] * 48
        assert (tree <= 48 * 1024) == (n_clutter == 32)
        before = ci.trace_union.launches
        got = ci.trace_union(tracer, o, d)
        torch.cuda.synchronize()
        assert ci.trace_union.launches == before + 1
        want = ci.trace_union_plain(tracer, o, d)
        assert int((want[3] >= 0).sum()) > 500
        for g, w in zip(got, want):
            assert torch.equal(g, w), (n_clutter, method, leaf_size)


@pytest.mark.parametrize("n_rays", [1, 31, 33, 128, 129, 4097])
def test_union_ragged_ray_counts(card, n_rays):
    """Ray counts that leave a warp or a block part-filled: the lanes past
    the last ray walk nothing and write nothing."""
    mesh, _ = make_box_scene(n_clutter=32, seed=4)
    tracer = build_bvh(mesh.triangles(), device=card)
    o, d = random_rays(n_rays, seed=12)
    o, d = torch.from_numpy(o).to(card), torch.from_numpy(d).to(card)
    got = ci.trace_union(tracer, o, d)
    torch.cuda.synchronize()
    for g, w in zip(got, ci.trace_union_plain(tracer, o, d)):
        assert g.shape == (n_rays,) and torch.equal(g, w)


def test_union_of_no_rays(card):
    """Zero rays: four empty outputs, nothing launched or counted."""
    mesh, _ = make_box_scene(n_clutter=32, seed=4)
    tracer = build_bvh(mesh.triangles(), device=card)
    empty = torch.zeros((0, 3), device=card)
    before = ci.trace_union.launches
    got = ci.trace_union(tracer, empty, empty)
    torch.cuda.synchronize()
    assert [g.shape for g in got] == [(0,)] * 4
    assert got[3].dtype == torch.int32
    assert ci.trace_union.launches == before


def test_union_refuses_what_it_does_not_take(card):
    """The C entry refuses a leaf size below 1, fewer triangle rows than a
    leaf and an empty tree, before any launch."""
    mesh, _ = make_box_scene(n_clutter=12, seed=4)
    tracer = build_bvh(mesh.triangles(), device=card)
    o = torch.zeros((8, 3), device=card)
    d = torch.ones((8, 3), device=card)
    hits = ci._outputs(8, card)
    lib = ci.get_lib()
    n, p = tracer.n_nodes, tracer.tris.shape[0]
    for n_nodes, rows, leaf in ((n, p, 0), (n, 3, 4), (0, p, 4)):
        rc = lib.iris_trace_union(
            tracer.nodes.data_ptr(), n_nodes, tracer.tris.data_ptr(), rows,
            leaf, o.data_ptr(), d.data_ptr(), 8,
            *(h.data_ptr() for h in hits),
            torch.cuda.current_stream().cuda_stream)
        assert rc == 1                     # cudaErrorInvalidValue
    torch.cuda.synchronize()


@pytest.mark.parametrize("n_clutter,leaf_size,n_rays", [
    (12, 4, 2048), (500, 4, 2048), (500, 4, 1000), (500, 10, 777)])
def test_paired_streamed_matches_plain(card, n_clutter, leaf_size, n_rays):
    """The packet kernel against its plain version at the kernel's packet
    width, with whole and ragged last packets. The warp's butterfly sum
    and the plain version's halving sum add in the same order, so the
    walks take the same turns and the hits are the same bits."""
    mesh, _ = make_box_scene(n_clutter=n_clutter, seed=4)
    tracer = build_bvh(mesh.triangles(), leaf_size=leaf_size, device=card)
    o1, d1 = random_rays(n_rays, seed=2)
    o2, d2, *_ = camera_rays(40)
    o = torch.from_numpy(np.concatenate([o1, o2])).to(card)
    d = torch.from_numpy(np.concatenate([d1, d2])).to(card)
    before = ci.trace_paired_streamed.launches
    got = ci.trace_paired_streamed(tracer, o, d)
    torch.cuda.synchronize()
    assert ci.trace_paired_streamed.launches == before + 1
    want = ci.trace_paired_streamed_plain(tracer, o, d)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # and the per-ray paired walk finds the same closest hits (ties aside)
    ref = ci.trace_paired_plain(tracer, o, d)
    assert torch.equal(got[3] >= 0, ref[3] >= 0)
    both = got[3] >= 0
    assert torch.allclose(got[0][both], ref[0][both], rtol=1e-5, atol=0)


@pytest.mark.parametrize("n_clutter,leaf_size", [
    (12, 4), (500, 4), (500, 16), (500, 32), (1500, 16)])
def test_ordered_matches_plain(card, n_clutter, leaf_size):
    """trace_ordered against its plain version, bit for bit, on record
    arrays of up to 35 KB (500 boxes at leaf 16 or 32: its path's size)
    and past 48 KB (500 at leaf 4, 1,500 at leaf 16), the size that a
    design staging them in shared memory would have had to read from
    global memory (staging measured slower and was dropped); 3,648 rays,
    not a multiple of the block."""
    mesh, _ = make_box_scene(n_clutter=n_clutter, seed=4)
    tracer = build_bvh(mesh.triangles(), leaf_size=leaf_size, device=card)
    records = ci.pair_records(tracer).shape[0] * 64
    assert records > 48 * 1024 if (n_clutter, leaf_size) in (
        (500, 4), (1500, 16)) else records <= 48 * 1024
    o1, d1 = random_rays(2048, seed=3)
    o2, d2, *_ = camera_rays(40)
    o = torch.from_numpy(np.concatenate([o1, o2])).to(card)
    d = torch.from_numpy(np.concatenate([d1, d2])).to(card)
    before = ci.trace_ordered.launches
    got = ci.trace_ordered(tracer, o, d)
    torch.cuda.synchronize()
    assert ci.trace_ordered.launches == before + 1
    want = ci.trace_ordered_plain(tracer, o, d)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("leaf_size", [1, 2, 3, 4, 5, 10])
def test_per_ray_pair_walks_match_plain(card, leaf_size):
    """trace_paired (leaf sizes 1-10) and trace_dense (1-5), one template
    instantiation per leaf size, against their plain versions on a
    6,014-face tree and 2,600 rays (not a multiple of the block)."""
    mesh, _ = make_box_scene(n_clutter=500, seed=4)
    tracer = build_bvh(mesh.triangles(), leaf_size=leaf_size, device=card)
    o1, d1 = random_rays(1000, seed=8)
    o2, d2, *_ = camera_rays(40)
    o = torch.from_numpy(np.concatenate([o1, o2])).to(card)
    d = torch.from_numpy(np.concatenate([d1, d2])).to(card)
    walks = [(ci.trace_paired, ci.trace_paired_plain)]
    if leaf_size <= 5:
        walks.append((ci.trace_dense, ci.trace_dense_plain))
    for kernel, plain in walks:
        before = kernel.launches
        got = kernel(tracer, o, d)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        for g, w in zip(got, plain(tracer, o, d)):
            assert torch.equal(g, w), (kernel.__name__, leaf_size)


def test_ordered_of_a_tree_whose_root_is_a_leaf(card):
    mesh, _ = make_box_scene(n_clutter=0, seed=1)
    tracer = build_bvh(mesh.triangles()[:2], leaf_size=2, device=card)
    assert tracer.n_nodes == 1
    o, d = random_rays(1000, seed=9)
    o, d = torch.from_numpy(o).to(card), torch.from_numpy(d).to(card)
    got = ci.trace_ordered(tracer, o, d)
    torch.cuda.synchronize()
    for g, w in zip(got, ci.trace_ordered_plain(tracer, o, d)):
        assert torch.equal(g, w)


def test_deepest_tree_the_stacks_admit(card):
    """A chain of depth 124 needs 128 stack entries (depth + 4), all the
    kernels hold: the three per-ray walks match their plain versions on
    rays that push a far child at every level. Depth 125 is refused with
    a ValueError before anything is launched."""
    deep = chain_tree(124, device=card)
    o, d = (x.to(card) for x in chain_rays(124, 500))
    for kernel, plain in ((ci.trace_ordered, ci.trace_ordered_plain),
                          (ci.trace_paired, ci.trace_paired_plain),
                          (ci.trace_dense, ci.trace_dense_plain)):
        got = kernel(deep, o, d)
        torch.cuda.synchronize()
        for g, w in zip(got, plain(deep, o, d)):
            assert torch.equal(g, w), kernel.__name__
    too_deep = chain_tree(125, device=card)
    for kernel in (ci.trace_ordered, ci.trace_paired, ci.trace_dense):
        before = kernel.launches
        with pytest.raises(ValueError, match="128"):
            kernel(too_deep, o, d)
        assert kernel.launches == before


def test_new_kernels_refuse_what_they_do_not_take(card):
    mesh, _ = make_box_scene(n_clutter=12, seed=4)
    o = torch.zeros((8, 3), device=card)
    d = torch.ones((8, 3), device=card)
    heap = build_bvh(mesh.triangles(), method="morton", device=card)
    with pytest.raises(ValueError, match="preorder"):
        ci.trace_ordered(heap, o, d)
    with pytest.raises(ValueError, match="preorder"):
        ci.trace_paired_streamed(heap, o, d)
    wide = build_bvh(mesh.triangles(), leaf_size=16, device=card)
    with pytest.raises(ValueError, match="leaf row"):
        ci.trace_paired_streamed(wide, o, d)


@pytest.mark.parametrize("n_clutter,leaf_size,n_rays", [
    (12, 4, 2048), (500, 4, 2048), (500, 4, 1000), (500, 5, 777),
    (500, 10, 777)])
def test_streamed_and_dense_kernels_match_plain(card, n_clutter, leaf_size,
                                                n_rays):
    """trace_streamed, trace_dense and trace_dense_streamed against their
    plain versions, whole and ragged last packets: the same float
    operations in the same order, so the same bits. trace_streamed finds
    trace_union's hits and trace_dense trace_paired's, bit for bit."""
    mesh, _ = make_box_scene(n_clutter=n_clutter, seed=4)
    tracer = build_bvh(mesh.triangles(), leaf_size=leaf_size, device=card)
    o1, d1 = random_rays(n_rays, seed=5)
    o2, d2, *_ = camera_rays(40)
    o = torch.from_numpy(np.concatenate([o1, o2])).to(card)
    d = torch.from_numpy(np.concatenate([d1, d2])).to(card)
    walks = [(ci.trace_streamed, ci.trace_streamed_plain, ci.trace_union)]
    if leaf_size * 12 <= 64:
        walks += [(ci.trace_dense, ci.trace_dense_plain, ci.trace_paired),
                  (ci.trace_dense_streamed, ci.trace_dense_streamed_plain,
                   ci.trace_paired_streamed)]
    for kernel, plain, twin in walks:
        before = kernel.launches
        got = kernel(tracer, o, d)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        for g, w in zip(got, plain(tracer, o, d)):
            assert torch.equal(g, w), kernel.__name__
        for g, w in zip(got, twin(tracer, o, d)):
            assert torch.equal(g, w), (kernel.__name__, twin.__name__)


def test_streamed_and_dense_kernels_refuse_what_they_do_not_take(card):
    mesh, _ = make_box_scene(n_clutter=12, seed=4)
    o = torch.zeros((8, 3), device=card)
    d = torch.ones((8, 3), device=card)
    heap = build_bvh(mesh.triangles(), method="morton", device=card)
    for kernel in (ci.trace_streamed, ci.trace_dense,
                   ci.trace_dense_streamed):
        with pytest.raises(ValueError, match="preorder"):
            kernel(heap, o, d)
    wide = build_bvh(mesh.triangles(), leaf_size=6, device=card)
    for kernel in (ci.trace_dense, ci.trace_dense_streamed):
        with pytest.raises(ValueError, match="64-float slot"):
            kernel(wide, o, d)


@pytest.mark.parametrize("n_clutter,leaf_size,ragged", [
    (12, 4, True), (600, 4, False), (600, 5, False)])
def test_every_packet_width_matches_plain(card, n_clutter, leaf_size, ragged):
    """Every instantiated width of the three packet walks against the
    plain version at that width, on a small and a 7,214-face tree; on the
    small tree also with ragged ray counts (1, 31, 33, a whole number of
    packets plus one): the same bits."""
    mesh, _ = make_box_scene(n_clutter=n_clutter, seed=4)
    tracer = build_bvh(mesh.triangles(), leaf_size=leaf_size, device=card)
    o1, d1 = random_rays(1500, seed=6)
    o2, d2, *_ = camera_rays(24)
    o_all = torch.from_numpy(np.concatenate([o1, o2])).to(card)
    d_all = torch.from_numpy(np.concatenate([d1, d2])).to(card)
    walks = [(ci.trace_streamed, ci.trace_streamed_plain),
             (ci.trace_paired_streamed, ci.trace_paired_streamed_plain),
             (ci.trace_dense_streamed, ci.trace_dense_streamed_plain)]
    for kernel, plain in walks:
        for width in ci.PACKET_WIDTHS:
            sizes = [o_all.shape[0]]
            if ragged:
                sizes += [1, 31, 33, 16 * width + 1]
            for n in sizes:
                o, d = o_all[-n:].contiguous(), d_all[-n:].contiguous()
                want = plain(tracer, o, d, width=width)
                before = kernel.launches
                got = kernel(tracer, o, d, width=width)
                torch.cuda.synchronize()
                assert kernel.launches == before + 1
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (kernel.__name__, width, n)


def test_shipped_packet_widths(card):
    """The kernels ship the widths cuda_intersect.py names, each keeps at
    least 2 blocks and 16 warps resident on an SM at leaf_size 4, and a
    width that is not instantiated is refused."""
    for name in ("trace_streamed", "trace_paired_streamed",
                 "trace_dense_streamed"):
        cfg = ci.packet_config(name, 4)
        assert cfg["packet_width"] == (
            ci.STREAMED_PACKET if name == "trace_streamed" else ci.PACKET)
        assert cfg["blocks_per_sm"] >= 2
        assert cfg["blocks_per_sm"] * cfg["threads_per_block"] >= 16 * 32
        assert cfg["smem_bytes_per_block"] <= cfg["smem_limit_bytes"]
        assert cfg["smem_limit_bytes"] > 48 * 1024
    assert ci.packet_config("trace_streamed", 4)["smem_bytes_per_block"] == 0
    mesh, _ = make_box_scene(n_clutter=12, seed=4)
    tracer = build_bvh(mesh.triangles(), device=card)
    o = torch.zeros((8, 3), device=card)
    d = torch.ones((8, 3), device=card)
    with pytest.raises(ValueError, match="packet width"):
        ci.trace_streamed(tracer, o, d, width=2)


def test_walk_config_of_the_per_ray_walks(card):
    """Every instantiation of the per-ray walks reports 128-thread blocks,
    no shared memory, and keeps at least 2 blocks resident on an SM; the
    three stack walks a local stack of at least kStackCap entries, the
    stackless union walk no stack."""
    cap = ci.get_lib().iris_paired_stack_cap()
    for name, leaves in (("trace_ordered", (4, 16, 32)),
                         ("trace_paired", range(1, 11)),
                         ("trace_dense", range(1, 6)),
                         ("trace_union", range(1, 17))):
        for leaf_size in leaves:
            cfg = ci.walk_config(name, leaf_size)
            assert cfg["threads_per_block"] == 128, (name, leaf_size)
            assert cfg["registers"] > 0 and cfg["blocks_per_sm"] >= 2
            assert cfg["smem_bytes_per_block"] == 0
            if name == "trace_union":
                assert cfg["local_bytes_per_thread"] < 4 * cap
            else:
                assert cfg["local_bytes_per_thread"] >= 4 * cap


def test_windows_past_the_shared_memory_limit_raise(card):
    """The pair walk's windows grow with the leaf row. The layouts the
    wrappers accept (leaf_size <= 10) take under 24 KB a block; the C entry
    takes any leaf_size, so it is asked directly: 128-triangle leaves need
    202 KB a block (4 warps x (a 512 B stack + 2 KB of records + 8 leaves x 6 KB)), past
    the default 48 KB and inside what a block may opt into, and the kernel
    is opted in (one block resident); 160-triangle leaves need 250 KB, past
    the card's limit: the launch is refused with an error before anything
    runs, at every width, and nothing runs instead."""
    cfg = ci.packet_config("trace_paired_streamed", 128)
    assert cfg["smem_bytes_per_block"] == 4 * (512 + 2048 + 8 * 6144)
    assert 48 * 1024 < cfg["smem_bytes_per_block"] <= cfg["smem_limit_bytes"]
    assert cfg["blocks_per_sm"] == 1
    cfg = ci.packet_config("trace_paired_streamed", 160)
    assert cfg["smem_bytes_per_block"] > cfg["smem_limit_bytes"]
    assert cfg["blocks_per_sm"] == 0
    x = torch.zeros((64, 16), device=card)
    o = torch.zeros((8, 3), device=card)
    d = torch.ones((8, 3), device=card)
    hits = ci._outputs(8, card)
    for width in ci.PACKET_WIDTHS:
        rc = ci.get_lib().iris_trace_paired_streamed(
            x.data_ptr(), 1, x.data_ptr(), 1, 160, 64, o.data_ptr(),
            d.data_ptr(), 8, *(h.data_ptr() for h in hits),
            torch.cuda.current_stream().cuda_stream, width)
        assert rc == 1                     # cudaErrorInvalidValue
    torch.cuda.synchronize()
