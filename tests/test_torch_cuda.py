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
    rays, not a multiple of the block, bit for bit; the kernel counts its
    launch once, with its rays."""
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
        before = ci.kernel_counts()["trace_union"]
        got = ci.trace_union(tracer, o, d)
        assert ci.kernel_counts()["trace_union"] == (
            before[0] + 1, before[1] + o.shape[0])
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
    before = ci.launch_counts()["trace_union"]
    got = ci.trace_union(tracer, empty, empty)
    torch.cuda.synchronize()
    assert [g.shape for g in got] == [(0,)] * 4
    assert got[3].dtype == torch.int32
    assert ci.launch_counts()["trace_union"] == before


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
    before = ci.launch_counts()["trace_paired_streamed"]
    got = ci.trace_paired_streamed(tracer, o, d)
    torch.cuda.synchronize()
    assert ci.launch_counts()["trace_paired_streamed"] == before + 1
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
    before = ci.launch_counts()["trace_ordered"]
    got = ci.trace_ordered(tracer, o, d)
    torch.cuda.synchronize()
    assert ci.launch_counts()["trace_ordered"] == before + 1
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
        before = ci.launch_counts()[kernel.__name__]
        got = kernel(tracer, o, d)
        torch.cuda.synchronize()
        assert ci.launch_counts()[kernel.__name__] == before + 1
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
        before = ci.launch_counts()[kernel.__name__]
        with pytest.raises(ValueError, match="128"):
            kernel(too_deep, o, d)
        assert ci.launch_counts()[kernel.__name__] == before


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
        before = ci.launch_counts()[kernel.__name__]
        got = kernel(tracer, o, d)
        torch.cuda.synchronize()
        assert ci.launch_counts()[kernel.__name__] == before + 1
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
                before = ci.launch_counts()[kernel.__name__]
                got = kernel(tracer, o, d, width=width)
                torch.cuda.synchronize()
                assert ci.launch_counts()[kernel.__name__] == before + 1
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


def test_segment_sum_same_bits_twice(card):
    """The bakes' segment sum adds in an order fixed by the ids alone: two
    runs on the card give the same bits (index_add_ would add with
    atomics, in an order that changes from run to run), and so does the
    CPU."""
    from iris_tpu_torch.core.segment import segment_sum

    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 97, (1 << 20,), generator=gen)
    vals = torch.rand((1 << 20, 4), generator=gen)
    a = segment_sum(vals.to(card), ids.to(card), 98)
    b = segment_sum(vals.to(card), ids.to(card), 98)
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), segment_sum(vals, ids, 98))
    want = torch.zeros(98, 4, dtype=torch.float64).index_add_(
        0, ids, vals.double())
    assert torch.allclose(a.cpu().double(), want, rtol=1e-5)


def test_slf_bake_same_bits_twice(card, tmp_path):
    """bake_slf on the card twice, on a small dataset of the port's
    generator: the same mask and the same bits of radiance and counts."""
    from iris_tpu_torch.data.datasets import load_dataset
    from iris_tpu_torch.data.make_demo_dataset import make_dataset
    from iris_tpu_torch.models.crf import init_emor_crf
    from iris_tpu_torch.pipeline.common import load_scene
    from iris_tpu_torch.pipeline.slf_bake import bake_slf

    root = str(tmp_path / "ds")
    make_dataset(root, img_hw=(32, 40), n_train=2, n_val=1, spp=4,
                 indir_depth=2, n_clutter=12, device=card)
    _, tracer = load_scene("synthetic", root, device=card)
    dataset = load_dataset("synthetic", root, split="train", img_dir="ldr",
                           load_gt=False)
    crf = init_emor_crf(dim=11, device=card)
    (a, ma), (b, mb) = (bake_slf(tracer, dataset, crf, 64,
                                 log=lambda *_: None) for _ in range(2))
    assert ma.any() and np.array_equal(ma, mb)
    assert torch.equal(a.radiance, b.radiance)
    assert torch.equal(a.count, b.count)
    assert float(a.radiance.max()) > 0


def _card_scene(card):
    """A small production-layout scene on the card (4 x 16 row-mode grid
    with the trainers' estimators: stochastic forward and backward, one
    level block of four, compact bf16 scatter) and 1,024 camera rays."""
    import dataclasses

    from iris_tpu_torch.demo import make_demo_scene
    from iris_tpu_torch.models.hashgrid import auto_bwd_level_sample

    tracer, em, ngp, crf, _ = make_demo_scene(
        n_clutter=12, slf_res=16, hash_levels=4, hash_features=16,
        per_level_scale=-1.0, log2_table=14, device=card)
    ngp = dataclasses.replace(ngp, cfg=dataclasses.replace(
        ngp.cfg, stochastic_fwd=True, stochastic_bwd=True,
        bwd_level_sample=auto_bwd_level_sample(4)))
    o, d, dxdu, dydv = camera_rays(32)
    rays = torch.from_numpy(np.concatenate([o, d, dxdu, dydv], -1)
                            .astype(np.float32)).to(card)
    return tracer, em, ngp, crf, rays


def _grads_twice(loss_fn, params, batch, card):
    from iris_tpu_torch.train.loop import step_generator, value_and_grad

    out = [value_and_grad(loss_fn, params, batch,
                          step_generator(0, 7, card)) for _ in range(2)]
    (la, _, ga), (lb, _, gb) = out
    assert torch.equal(la, lb) and ga.keys() == gb.keys()
    for name in ga:
        assert torch.equal(ga[name], gb[name]), name
    return ga


def test_benchmark_step_same_gradient_bits_twice(card):
    """One step of the benchmark loss (fwd+bwd of
    crf_forward(path_tracing_single) against 0.5, spp 8), twice from the
    same parameters and the same generator: the same loss and gradient
    bits in every leaf. Every scatter of the backward is an order-fixed
    segment sum; index_add_ would add with atomics in an order that
    changes from run to run."""
    import dataclasses
    import functools

    from iris_tpu_torch.models.brdf import ngp_brdf_apply
    from iris_tpu_torch.models.crf import crf_forward
    from iris_tpu_torch.render.integrator import path_tracing_single

    tracer, em, ngp, crf, rays = _card_scene(card)
    o, d, dxdu, dydv = (rays[:, i:i + 3] for i in (0, 3, 6, 9))

    def loss_fn(p, batch, gen, samples=None):
        em2 = dataclasses.replace(em, radiance=p["radiance"])
        crf2 = dataclasses.replace(crf, weight=p["crf_w"])
        mat_fn = functools.partial(ngp_brdf_apply, p["material"], gen=gen)
        l = path_tracing_single(gen, tracer, em2, mat_fn, o, d, dxdu, dydv,
                                8)
        loss = torch.mean((crf_forward(crf2, l, 1.0) - 0.5) ** 2)
        return loss, {}

    grads = _grads_twice(loss_fn, {"material": ngp,
                                   "radiance": em.radiance.clone(),
                                   "crf_w": crf.weight.clone()}, {}, card)
    assert float(grads["material.table"].abs().max()) > 0


def test_brdf_crf_step_same_gradient_bits_twice(card):
    """A train_brdf_crf step with the semantic propagation loss (its
    partner gather's backward) and the albedo anchor (segment means),
    twice under the same generator: the same gradient bits."""
    from iris_tpu_torch.models.crf import init_emor_crf
    from iris_tpu_torch.train.steps import LossConfig, make_brdf_crf_loss

    tracer, _, ngp, _, rays = _card_scene(card)
    gen = torch.Generator(device=card).manual_seed(3)
    b = rays.shape[0]
    batch = {"rays": rays, "rgbs": torch.rand((b, 3), generator=gen,
                                              device=card),
             "diffuse": torch.rand((b, 3), generator=gen, device=card),
             "specular0": torch.rand((b, 6, 3), generator=gen, device=card),
             "specular1": torch.rand((b, 6, 3), generator=gen, device=card),
             "segmentation": torch.randint(0, 9, (b,), generator=gen,
                                           device=card).float(),
             "int_albedo": torch.rand((b, 3), generator=gen, device=card)}
    cfg = LossConfig(has_part=False, la=0.01, n_pairs=64)
    crf = init_emor_crf(device=card)
    loss_fn = make_brdf_crf_loss(tracer, crf, cfg, float(ngp.voxel_min),
                                 float(ngp.voxel_max))
    grads = _grads_twice(loss_fn, {"material": ngp,
                                   "crf_weight": crf.weight.clone()},
                         batch, card)
    assert float(grads["material.table"].abs().max()) > 0


def test_segment_mean_same_bits_twice(card):
    """The losses' segment means, forward and backward, twice on the card:
    the same bits; within float rounding of the CPU's."""
    from iris_tpu_torch.utils.losses import segment_mean

    gen = torch.Generator().manual_seed(1)
    n = 1 << 18
    vals = torch.rand((n, 3), generator=gen)
    w = torch.rand(n, generator=gen)
    ids = torch.randint(0, 128, (n,), generator=gen)
    outs = []
    for _ in range(2):
        v = vals.to(card).requires_grad_(True)
        mean, per_elem = segment_mean(v, ids.to(card), 128, w.to(card))
        (g,) = torch.autograd.grad(torch.sum(per_elem * per_elem), v)
        outs.append((mean, per_elem, g))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    mean_cpu, _ = segment_mean(vals, ids, 128, w)
    assert torch.allclose(outs[0][0].cpu(), mean_cpu, rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------- relight

def _relight_scene(dev, light_num=8):
    """A small relight scene on `dev`: the 2-clutter room with the 4 x 16
    row-mode material (made on the CPU, so that every device holds the
    same table), a sphere emitter, a conductor and a disco ball of
    `light_num` lights as a sub-scene; and its spots."""
    from iris_tpu_torch.models.brdf import init_ngp_brdf
    from iris_tpu_torch.models.hashgrid import HashGridConfig
    from iris_tpu_torch.render import relight as R
    from iris_tpu_torch.train.checkpoint import from_numpy, to_numpy

    mesh, is_em = make_box_scene(n_clutter=2, seed=0)
    ngp = init_ngp_brdf(0, -0.1, 2.1, HashGridConfig(
        n_levels=4, n_features=16, log2_table_size=8, row_gather=True),
        device="cpu")
    gen = torch.Generator().manual_seed(1)
    ngp.table[:256] = torch.rand((256, 16), generator=gen) * 2 - 1
    ngp = from_numpy(to_numpy(ngp), dev)
    shapes = [
        {"kind": "mesh", "tris": mesh.triangles(), "bsdf": {"type": "fipt"}},
        {"kind": "sphere", "subdiv": 1,
         "to_world": [{"type": "translate", "value": [0.6, 0.6, 0.5]},
                      {"type": "scale", "value": 0.1}],
         "emitter": {"radiance": [30.0, 25.0, 20.0]}},
        {"kind": "sphere", "subdiv": 1,
         "to_world": [{"type": "translate", "value": [1.4, 1.0, 0.3]},
                      {"type": "scale", "value": 0.15}],
         "bsdf": {"type": "conductor", "reflectance": [1.0, 0.86, 0.57]}},
    ]
    disco, spots = R.make_disco_ball([1.0, 1.0, 0.6], 0.12, 60.0,
                                     light_num=light_num,
                                     spot_intensity=20.0, device=dev)
    scene = R.build_relight_scene(
        shapes, ngp=ngp, main_is_emitter=is_em,
        main_emitter_radiance=np.full((int(is_em.sum()), 3), 4.0,
                                      np.float32),
        dynamic_shapes=disco, dynamic_center=[1.0, 1.0, 0.6], device=dev)
    return scene, spots


def _relight_rays(dev, n_side=16):
    o, d, dxdu, dydv = camera_rays(n_side, origin=(1.0, 0.3, 0.8),
                                   look=(0.0, 0.7, -0.5))
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (o, d, dxdu, dydv)]


def test_relight_card_matches_cpu(card):
    """A 16 x 16 relight (spp 4, depth 2, 8 spots, the disco ball at a
    phase) on the card and on the CPU under the same samples: the bf16
    rule, 95% of values within rtol 2e-3 / atol 1e-4."""
    from iris_tpu_torch.render import relight as R

    b, spp, depth = 256, 4, 2
    n = b * spp
    rng = np.random.default_rng(0)

    def u(*shape):
        return torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))

    samples = {"dudv": u(2, b, spp, 1) - 0.5, "s1": u(depth, n),
               "s2": u(depth, n, 2), "s1b": u(depth, n),
               "s2b": u(depth, n, 2)}
    out = []
    for dev in (card, torch.device("cpu")):
        scene, spots = _relight_scene(dev)
        scene = R.set_disco_phase(scene, spots, 0.5)
        out.append(R.relight_path_tracing(
            None, scene, *_relight_rays(dev), spp, depth,
            samples={k: v.to(dev) for k, v in samples.items()}).cpu())
    got, want = out
    assert torch.isfinite(got).all() and float(want.max()) > 1e-2
    close = (got - want).abs() <= 1e-4 + 2e-3 * want.abs()
    assert float(close.float().mean()) >= 0.95


def test_disco_phase_moves_the_lights_without_a_build(card, monkeypatch):
    """set_disco_phase on the card: no BVH built, the sub-scene's emitter
    vertices and the spots moved, the same bits as on the CPU (the
    rotations are elementwise products and sums)."""
    from iris_tpu_torch.render import relight as R

    scenes = {d: _relight_scene(d) for d in (card, torch.device("cpu"))}
    built = []
    monkeypatch.setattr(R, "build_bvh", lambda *a, **k: built.append(a))
    moved = {d: R.set_disco_phase(s, sp, 1.3) for d, (s, sp) in
             scenes.items()}
    assert built == []
    s0, spots0 = scenes[card]
    m = moved[card]
    dyn = s0.emitter.triangle_idx >= s0.dyn_face_offset
    assert not torch.equal(m.emitter.emitter_vertices[dyn],
                           s0.emitter.emitter_vertices[dyn])
    assert torch.equal(m.emitter.emitter_vertices[~dyn],
                       s0.emitter.emitter_vertices[~dyn])
    assert not torch.equal(m.spots.position, spots0.position)
    cpu = moved[torch.device("cpu")]
    for a, b in ((m.emitter.emitter_vertices, cpu.emitter.emitter_vertices),
                 (m.spots.position, cpu.spots.position),
                 (m.spots.direction, cpu.spots.direction),
                 (m.dyn_rot, cpu.dyn_rot)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("with_spots", [True, False])
def test_relight_round_launches(card, with_spots):
    """One relight round launches (1 + D (2 + [spots])) (1 + [sub-scene])
    traversal kernels, every one trace_union on these small trees."""
    import dataclasses

    from iris_tpu_torch.render import relight as R

    scene, spots = _relight_scene(card)
    scene = R.set_disco_phase(scene, spots, 0.2)
    if not with_spots:
        scene = dataclasses.replace(scene, spots=None)
    depth = 3
    before = ci.launch_counts()
    gen = torch.Generator(device=card).manual_seed(0)
    out = R.relight_path_tracing(gen, scene, *_relight_rays(card, 8), 2,
                                 depth)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    launched = {k: v - before[k] for k, v in ci.launch_counts().items()}
    want = (1 + depth * (2 + int(with_spots))) * 2
    assert launched == {k: want if k == "trace_union" else 0
                        for k in ci.KERNELS}


@pytest.fixture(scope="module")
def tools_root(tmp_path_factory):
    """A 24 x 32 demo dataset (3 train frames), written on the CPU."""
    from iris_tpu_torch.data.make_demo_dataset import make_dataset

    root = str(tmp_path_factory.mktemp("tools_card"))
    make_dataset(root, img_hw=(24, 32), n_train=3, n_val=1, spp=4,
                 indir_depth=1, device="cpu")
    return root


def test_dataset_tools_card_match_cpu(card, tools_root):
    """The tools' device functions on the card and on the CPU: labels,
    fused labels (a tie included: the lower label wins on both) and the
    rewritten views equal; the geometry within atol 1e-5; one launch a
    frame for the labels and the geometry, two for the fusion."""
    from iris_tpu_torch.data.datasets import SyntheticDataset
    from iris_tpu_torch.geometry.mesh import load_mesh
    from iris_tpu_torch.utils import fuse_segmentation as fuse
    from iris_tpu_torch.utils.extract_geometry import trace_geometry
    from iris_tpu_torch.utils.render_semantic import (
        face_label_tensor, semantic_labels)

    mesh = load_mesh(f"{tools_root}/scene.obj")
    ds = SyntheticDataset(tools_root, img_dir="ldr", split="train",
                          load_gt=False, load_inverse=True)
    frames = list(ds.frames())
    hw = frames[0]["rays"].shape[0]
    tie = [{"rays": frames[0]["rays"], "segmentation": np.full(hw, s,
                                                             np.float32)}
           for s in (7.0, 3.0)]
    labels = (np.arange(mesh.n_faces) // 12) % 128
    out = []
    for dev in (card, torch.device("cpu")):
        tracer = build_bvh(mesh.triangles(), device=dev)
        before = ci.launch_counts()
        res = {"geo": [], "sem": []}
        for fr in frames:
            rays = torch.from_numpy(fr["rays"]).to(dev)
            res["geo"].append(trace_geometry(tracer, rays))
            res["sem"].append(semantic_labels(tracer, face_label_tensor(
                labels, mesh.n_faces, dev), rays))
        res["fused"] = fuse.fuse_segmentation(tracer, mesh.n_faces, frames,
                                              128)
        res["views"] = [fuse.relabel(
            tracer, torch.from_numpy(res["fused"]).to(dev),
            torch.from_numpy(fr["rays"]).to(dev),
            torch.from_numpy(fr["segmentation"]).to(dev)) for fr in frames]
        res["tie"] = fuse.fuse_segmentation(tracer, mesh.n_faces, tie, 16)
        res["launches"] = {k: v - before[k]
                           for k, v in ci.launch_counts().items()}
        out.append(res)
    got, want = out
    n = len(frames)
    assert got["launches"]["trace_union"] == 2 * n + 2 * n + 2
    for g, w in zip(got["geo"], want["geo"]):
        for a, b in zip(g, w):
            assert float((a.cpu() - b).abs().max()) <= 1e-5
    for g, w in zip(got["sem"] + got["views"], want["sem"] + want["views"]):
        assert torch.equal(g.cpu(), w)
    assert np.array_equal(got["fused"], want["fused"])
    assert np.array_equal(got["tie"], want["tie"])
    seen = got["tie"] >= 0
    assert seen.sum() > 10 and np.all(got["tie"][seen] == 3)


def test_nccl_two_ranks_match_one_process(card, tmp_path):
    """Two NCCL ranks on cuda:0 and cuda:1 (skips below two cards): the
    initialize loss of a 1,024-pixel demo batch, split 512 a rank, against
    one process on cuda:0 under the same generators. The loss within 1e-4
    relative (cuBLAS may add the MLP's products of 512 rows in another
    order than of 1,024); every gradient leaf within 1e-4 of its largest
    entry, the MLP's weights within 1e-2 (their gradients round to bf16,
    each rank's half apart, tests/test_torch_parallel.py); both ranks the
    same bits."""
    from torch_ranks import demo_initialize, spawn

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    r0, r1 = spawn(demo_initialize, 2, tmp_path, 32, device="cuda")
    one = demo_initialize(None, 32)
    assert r0["loss"] == r1["loss"]
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=1e-4)
    for k, g in one["grads"].items():
        assert r0["grads"][k].tobytes() == r1["grads"][k].tobytes(), k
        rel = 1e-2 if ".mlp.w." in k else 1e-4
        assert np.abs(r0["grads"][k] - g).max() <= rel * np.abs(g).max(), k


@pytest.mark.parametrize("argv", [["--ranks", "1"],
                                  ["--ranks", "2", "--dist_backend", "gloo"]])
def test_comms_report_counts_on_the_card(card, argv, capfd):
    """parallel.comms_report's CLI on the card by default: one NCCL rank,
    and two gloo ranks sharing cuda:0; the bytes are the parameters' and
    7 floats a ray of the 256-ray batch."""
    import json

    from iris_tpu_torch.parallel import comms_report

    comms_report.main(["--link_bw", "2.5e10", "--batch", "256",
                       "--hash_levels", "4", "--hash_features", "4",
                       "--log2_table", "10"] + argv)
    lines = [line for line in capfd.readouterr().out.splitlines()
             if line.startswith("{")]
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert r["device"].startswith("cuda")
    assert r["backend"] == ("gloo" if "gloo" in argv else "nccl")
    assert r["allreduce_to_param"] == 1.0
    assert r["gather_bytes_per_step"] == 4 * 256 * 7


def test_time_ms_on_the_card(card):
    from iris_tpu_torch.utils.timing import bench_keyed, time_ms

    flush = torch.empty(1 << 20, device=card)
    x = torch.rand(1 << 22, device=card)
    ms = time_ms(lambda: x.mul(2.0), 5, flush)
    assert ms > 0
    s = bench_keyed(lambda g: torch.rand(1 << 20, generator=g,
                                         device=card), 0, iters=3)
    assert s > 0


def test_device_trace_records_the_card(card, tmp_path):
    import json

    from iris_tpu_torch.utils.profiling import device_trace

    x = torch.rand(256, 256, device=card)
    with device_trace(str(tmp_path), "card") as prof:
        x.matmul(x).sum().item()
    with open(tmp_path / "card.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)
    assert prof.key_averages()


def test_bench_measure_launches_trace_union_alone(card):
    """The benchmark step on the flagship scene, 2 calls a graph: one eager
    warm-up call, then the warm replay and three timed replays of 2 calls
    (9 calls): trace_union alone, 2 launches a call (the camera rays and
    the fused NEE + bounce rays), counted at each replay, and a time for
    each timed replay."""
    from iris_tpu_torch import bench

    m = bench.measure(bench.FLAGSHIP, iters=2, device=card)
    assert m["calls"] == 9 and m["faces"] == 398
    assert m["kernel_mode"] == "trace_union"
    assert m["launches"] == {"trace_union": 2 * m["calls"]}
    assert len(m["s_per_call"]) == 3 and all(t > 0 for t in m["s_per_call"])
    assert m["rays_per_s"] > 0


def _chunk_case(card):
    """The benchmark loss (spp 4) on _card_scene with fresh parameters, and
    a batch stream whose rays move each step (numpy, as RayBatcher yields
    them), for run_training."""
    import dataclasses
    import functools

    from iris_tpu_torch.models.brdf import ngp_brdf_apply
    from iris_tpu_torch.models.crf import crf_forward
    from iris_tpu_torch.render.integrator import path_tracing_single

    tracer, em, ngp, crf, rays = _card_scene(card)
    host = rays.cpu().numpy()

    def loss_fn(p, batch, gen, samples=None):
        r = batch["rays"]
        em2 = dataclasses.replace(em, radiance=p["radiance"])
        crf2 = dataclasses.replace(crf, weight=p["crf_w"])
        mat_fn = functools.partial(ngp_brdf_apply, p["material"], gen=gen)
        l = path_tracing_single(gen, tracer, em2, mat_fn,
                                *(r[:, i:i + 3] for i in (0, 3, 6, 9)), 4)
        loss = torch.mean((crf_forward(crf2, l, 1.0) - 0.5) ** 2)
        return loss, {"mean_l": l.mean()}

    def params():
        return {"material": dataclasses.replace(
                    ngp, table=ngp.table.clone(),
                    mlp={k: [t.clone() for t in v]
                         for k, v in ngp.mlp.items()}),
                "radiance": em.radiance.clone(), "crf_w": crf.weight.clone()}

    def batches(step0=0):
        s = step0
        while True:
            yield {"rays": np.roll(host, 37 * s, 0)}
            s += 1

    return loss_fn, params, batches


def _state_bits(params, state):
    from iris_tpu_torch.train.optim import named_leaves

    out = [t.clone() for _, t in named_leaves(params)]
    for st in state["opt"].state_dict()["state"].values():
        out += [st[k].clone() for k in sorted(st)]
    return out + [state["sched"].last_epoch.clone()]


def test_graphed_chunks_match_eager_steps(card):
    """run_training on the card: 11 Adam steps in chunks of 4 (the first
    chunk eager, the second captured and replayed, the third replayed,
    then a 3-step chunk captured in the same pool) against 11 single
    steps, a milestone at step 6 inside a replayed chunk: the same losses,
    auxes, parameters, moments and schedule, every bit; the launches the
    kernel counted on the card, replays included, equal the eager run's."""
    from iris_tpu_torch.geometry import cuda_intersect as ci
    from iris_tpu_torch.train.loop import run_training
    from iris_tpu_torch.train.optim import make_optimizer

    loss_fn, params, batches = _chunk_case(card)
    runs = {}
    for chunk in (4, 1):
        before = ci.launch_counts()["trace_union"]
        logs = []
        p, st = run_training(
            loss_fn, params(), batches(), make_optimizer(
                learning_rate=1e-2, milestones=(6,)), 11, 3, log_fn=None,
            hooks=[lambda s, p_, l, a: logs.append(
                (s, l.item(), a["mean_l"].item()))],
            return_state=True, chunk_steps=chunk)
        torch.cuda.synchronize()
        runs[chunk] = (logs, _state_bits(p, st),
                       ci.launch_counts()["trace_union"] - before)
    (la, sa, na), (lb, sb, nb) = runs[4], runs[1]
    assert la == lb and [s for s, *_ in la] == list(range(11))
    assert len(sa) == len(sb) and all(torch.equal(a, b)
                                      for a, b in zip(sa, sb))
    assert na == nb == 2 * 11


def test_graphed_brdf_crf_semantic_chunks_match_eager_steps(card):
    """The train_brdf_crf loss with the semantic propagation loss at its
    published sizes (batch 8,192, 1,024 partners a pixel, the 32 x 2 x
    2^19 packed grid's one-corner estimators) through run_training: 7 Adam
    steps in chunks of 3 (eager, captured and replayed, then a one-step
    chunk) against 7 single steps: the same losses, auxes, parameters and
    moments, every bit; the graph counts 8,388,608 partner pairs a step."""
    import dataclasses

    from iris_tpu_torch.demo import make_demo_scene
    from iris_tpu_torch.models.crf import init_emor_crf
    from iris_tpu_torch.train.loop import run_training
    from iris_tpu_torch.train.optim import make_optimizer
    from iris_tpu_torch.train.steps import LossConfig, make_brdf_crf_loss
    from iris_tpu_torch.utils import profiling

    tracer, _, ngp, _, _ = make_demo_scene(
        n_clutter=60, slf_res=8, hash_levels=32, log2_table=19, device=card)
    ngp = dataclasses.replace(ngp, cfg=dataclasses.replace(
        ngp.cfg, stochastic_fwd=True, bwd_level_sample=8))
    o, d, dxdu, dydv = camera_rays(91)
    rays = np.concatenate([o, d, dxdu, dydv], -1).astype(np.float32)[:8192]
    rng = np.random.default_rng(2)
    b = rays.shape[0]

    def batches():
        s = 0
        while True:
            yield {"rays": np.roll(rays, 41 * s, 0),
                   "rgbs": rng.uniform(size=(b, 3)).astype(np.float32),
                   "exposure": np.ones((b, 1), np.float32),
                   "diffuse": rng.uniform(size=(b, 3)).astype(np.float32),
                   "specular0": rng.uniform(size=(b, 6, 3)).astype(
                       np.float32),
                   "specular1": rng.uniform(size=(b, 6, 3)).astype(
                       np.float32),
                   "segmentation": rng.integers(0, 128, b).astype(
                       np.float32),
                   "int_albedo": rng.uniform(size=(b, 3)).astype(
                       np.float32)}
            s += 1

    def params():
        return {"material": dataclasses.replace(
                    ngp, table=(ngp.table * 3000.0).clone(),
                    mlp={k: [t.clone() for t in v]
                         for k, v in ngp.mlp.items()}),
                "crf_weight": torch.zeros((3, 3), device=card)}

    crf = init_emor_crf(device=card)
    loss_fn = make_brdf_crf_loss(
        tracer, crf, LossConfig(has_part=False, la=0.01, n_pairs=1024),
        float(ngp.voxel_min), float(ngp.voxel_max))
    runs = {}
    for chunk in (3, 1):
        rng = np.random.default_rng(2)
        logs = []
        profiling.reset()
        p, st = run_training(
            loss_fn, params(), batches(), make_optimizer(1e-3), 7, 5,
            log_fn=None, hooks=[lambda s, p_, l, a: logs.append(
                (s, l.item(), a["loss_seg"].item(), a["loss_c"].item()))],
            return_state=True, chunk_steps=chunk)
        torch.cuda.synchronize()
        runs[chunk] = (logs, _state_bits(p, st), profiling.report())
    (la, sa, ra), (lb, sb, _) = runs[3], runs[1]
    assert la == lb and [s for s, *_ in la] == list(range(7))
    assert all(x[2] > 0 for x in la)
    assert len(sa) == len(sb) and all(torch.equal(x, y)
                                      for x, y in zip(sa, sb))
    g = ra["graphs"]["train_chunk"]
    assert g["counts"]["loss.partner_pairs"] == 3 * 8192 * 1024
    assert g["counts"]["train.steps"] == 3
    assert {"loss.propagation", "loss.propagation_bwd", "loss.shade",
            "loss.segment_means"} <= set(g["spans"])


def test_card_batches_are_the_host_batches(card):
    """RayBatcher over a bank held on the card (place_bank: each batch
    gathered and spatially ordered there) gives the rows, in the order,
    of the same bank read on the host, every bit, over two epochs of a
    200,000-pixel bank at batch 8,192."""
    from iris_tpu_torch.data.datasets import RayBatcher, place_bank

    rng = np.random.default_rng(9)
    n = 200_000
    o, d, dxdu, dydv = camera_rays(448)
    rays = np.concatenate([o, d, dxdu, dydv], -1).astype(np.float32)[:n]
    bank = {"rays": rays,
            "specular0": rng.uniform(size=(n, 6, 3)).astype(np.float32),
            "segmentation": rng.integers(0, 128, n).astype(np.float32)}
    host = RayBatcher(bank, 8192, seed=2 ** 31 + 1)
    dev = RayBatcher(place_bank(bank, card), 8192, seed=2 ** 31 + 1)
    for a, b, _ in zip(host.iter_from(0), dev.iter_from(0), range(50)):
        for k in bank:
            assert a[k].device.type == "cpu"
            assert b[k].device.type == "cuda"
            assert torch.equal(b[k].cpu(), a[k])


def test_one_capture_replays_at_other_steps(card):
    """One captured chunk of 3 replayed at three step0 (its slot generators
    reseeded each time): each replay equals 3 eager steps from the same
    state at that step0, every bit."""
    from iris_tpu_torch.train.loop import (
        make_train_chunk, make_train_step, step_generator)
    from iris_tpu_torch.train.optim import make_optimizer

    loss_fn, params, batches = _chunk_case(card)
    opt = make_optimizer(learning_rate=1e-2, milestones=(4,))
    pg, pe = params(), params()
    sg, se = opt.init(pg), opt.init(pe)
    chunk = make_train_chunk(loss_fn, opt, 3)
    step = make_train_step(loss_fn, opt)
    for step0 in (0, 9, 3, 20):          # the first call is the warm-up
        bs = [{"rays": torch.from_numpy(b["rays"])} for b, _ in
              zip(batches(step0), range(3))]
        _, _, losses, _ = chunk(pg, sg, [{"rays": b["rays"].numpy()}
                                         for b in bs], 5, step0)
        eager = []
        for j, b in enumerate(bs):
            _, _, loss, _ = step(pe, se, {"rays": b["rays"].to(card)},
                                 step_generator(5, step0 + j, card))
            eager.append(loss)
        assert torch.equal(losses, torch.stack(eager)), step0
        assert all(torch.equal(a, b) for a, b in
                   zip(_state_bits(pg, sg), _state_bits(pe, se))), step0


def test_graphed_bench_scan_is_the_eager_calls(card):
    """bench_scan's graph of 4 chained calls of bench.grad_step returns the
    bits of the same 4 calls run eagerly under the same generators."""
    from iris_tpu_torch import bench
    from iris_tpu_torch.utils import timing
    from iris_tpu_torch.utils.graphs import observing

    loss_fn, params, _ = _chunk_case(card)
    batch = {"rays": _card_scene(card)[4]}
    step = bench.grad_step(lambda p, b, g, s=None: loss_fn(p, batch, g, s),
                           params())
    got = []

    class Keep:
        def captured(self, graph):
            pass

        def replayed(self, graph, seeds, start, end):
            got.append((list(seeds), graph.outputs.clone()))

    with observing(Keep()):
        timing.bench_scan(step, 11, iters=4, device=card)
    seeds, out = got[-1]
    assert seeds == [11, 12, 13, 14] and len(got) == 4
    acc = torch.zeros((), device=card)
    for s in seeds:
        acc = step(torch.Generator(device=card).manual_seed(s)) + acc * 1e-12
    assert torch.equal(out, acc)


def test_replayed_render_round_is_the_eager_round(card):
    """pipeline.render.make_render_round on the card (spp 4, depth 5, the
    flagship scene): over 2 frames of 3 rounds (the first round the eager
    warm-up, the second the capture), every round's radiance and six
    AOVs equal render_chunk + aov_chunk run eagerly under a generator of
    the same seed drawn round after round, every bit; the kernels count 8
    trace_union launches in each replayed round, and one capture."""
    from iris_tpu_torch.demo import demo_mat_fn, make_demo_scene
    from iris_tpu_torch.pipeline.render import (
        make_render_fns, make_render_round)
    from iris_tpu_torch.utils.graphs import observing

    tracer, em, ngp, _, _ = make_demo_scene(
        n_clutter=32, slf_res=16, hash_levels=4, hash_features=16,
        per_level_scale=-1.0, log2_table=14, device=card)
    rays = _card_scene(card)[4]
    rc, ac = make_render_fns(tracer, em, demo_mat_fn(ngp), 4, 5)
    captures = []

    class Captures:
        def captured(self, graph):
            captures.append(graph)

        def replayed(self, graph, seeds, start, end):
            pass

    with observing(Captures()):
        unit = make_render_round(rc, ac, card)
        for frame in (3, 4):
            gen = torch.Generator(device=card).manual_seed(frame)
            for rd in range(3):
                before = ci.launch_counts()["trace_union"]
                got = [x.clone() for x in unit(
                    rays, seed=frame if rd == 0 else None)]
                torch.cuda.synchronize()
                launched = ci.launch_counts()["trace_union"] - before
                want = [rc(rays, gen)] + list(ac(rays, gen))
                assert len(got) == 7 and all(
                    torch.equal(a, b) for a, b in zip(got, want)), (frame, rd)
                assert launched == 8, (frame, rd, launched)
    assert len(captures) == 1


# the hash grid's exact encode kernel (models/cuda_hashgrid.py) at the
# cells' grids: dense levels 0-6 and hashed 7-31 (packed), dense level 0
# and hashed 1-3 (rows)
HASH_GRIDS = {
    "ref32x2": dict(n_levels=32, n_features=2, log2_table_size=19,
                    base_resolution=16, per_level_scale=1.3),
    "prod4x16": dict(n_levels=4, n_features=16, log2_table_size=19,
                     base_resolution=16, per_level_scale=15.045777687353615,
                     row_gather=True),
}
HASH_MODES = {"packed": ("ref32x2", {}),
              "flat": ("ref32x2", {"packed_gather": False}),
              "rows": ("prod4x16", {}),
              "rows_bf16": ("prod4x16", {"fwd_gather_dtype": "bfloat16"})}


def _hash_case(card, mode, n):
    """A grid of the mode's cell, its table uniform in +-0.3, and n points
    in [-0.1, 1.1]^3, the first four on the box's faces and corners."""
    from iris_tpu_torch.models import hashgrid as H

    grid, extra = HASH_MODES[mode]
    cfg = H.HashGridConfig(**HASH_GRIDS[grid], stochastic_fwd=False,
                           **extra)
    gen = torch.Generator(device=card).manual_seed(7)
    table = H.init_hashgrid(gen, cfg, card).uniform_(-0.3, 0.3,
                                                     generator=gen)
    x = torch.rand((n, 3), generator=gen, device=card) * 1.2 - 0.1
    faces = torch.tensor([[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 1]],
                         device=card)
    x[:4] = faces[:min(n, 4)]
    return cfg, table, x


def _kernel_args(cfg, table, x, mode):
    from iris_tpu_torch.models import hashgrid as H

    lt = cfg.n_levels * cfg.table_size
    return (H._pack_bf16(table, lt) if mode == "packed" else table, x,
            H._level_constants(cfg, x.device)[:3], mode, cfg.n_levels,
            cfg.n_features, cfg.log2_table_size)


@pytest.mark.parametrize("mode", list(HASH_MODES))
@pytest.mark.parametrize("n", [0, 1, 4133])
def test_hashgrid_kernel_matches_plain(card, mode, n):
    """The kernel against encode_plain on the card, bit for bit, twice,
    one launch a call (none for no points); hashgrid_encode takes it for
    the mode (rows_bf16: under the stochastic backward)."""
    from iris_tpu_torch.models import cuda_hashgrid
    from iris_tpu_torch.models import hashgrid as H

    cfg, table, x = _hash_case(card, mode, n)
    args = _kernel_args(cfg, table, x, mode)
    before = cuda_hashgrid.launch_counts()["encode"]
    got = cuda_hashgrid.encode(*args)
    again = cuda_hashgrid.encode(*args)
    assert cuda_hashgrid.launch_counts()["encode"] == before + 2 * (n > 0)
    want = cuda_hashgrid.encode_plain(*args)
    assert got.shape == want.shape == (n, cfg.n_levels * cfg.n_features)
    assert torch.equal(got, want) and torch.equal(again, want)
    gen = (torch.Generator(device=card).manual_seed(3)
           if mode == "rows_bf16" else None)
    assert torch.equal(H.hashgrid_encode(table, cfg, x, gen), want)


def test_hashgrid_pack_is_pack_bf16(card):
    """The one-pass pack kernel makes _pack_bf16's words: ties to even of
    both signs, the largest finite floats, infinities and NaN included;
    it counts its launches, and no encode's."""
    from iris_tpu_torch.models import cuda_hashgrid
    from iris_tpu_torch.models import hashgrid as H

    cfg, table, _ = _hash_case(card, "packed", 1)
    special = torch.tensor(
        [0x3F808000, 0x3F818000, 0xBF808000, 0xBF818000, 0x7F7FFFFF,
         0x7F800000, 0xFF800000, 0x7FC00000, 0x80000000],
        dtype=torch.int64).to(torch.int32).view(torch.float32)
    table[:special.numel()] = special.to(card)
    table[-special.numel():] = special.to(card)
    block = table.numel() // 2
    before = cuda_hashgrid.launch_counts()
    assert torch.equal(cuda_hashgrid.pack(table, block),
                       H._pack_bf16(table, block))
    odd = table[:2 * 1001]
    assert torch.equal(cuda_hashgrid.pack(odd, 1001), H._pack_bf16(odd, 1001))
    after = cuda_hashgrid.launch_counts()
    assert after == {"encode": before["encode"], "pack": before["pack"] + 2}
    cuda_hashgrid.reset_launch_counts()
    assert cuda_hashgrid.launch_counts() == {"encode": 0, "pack": 0}


def test_hashgrid_kernel_replays_from_a_graph(card):
    """The encode captured in a utils/graphs.Graph: each replay is an eager
    call's bits, on the points the buffer holds at the replay; the kernel
    counts every replay's launch and the graph's tally counts one
    hashgrid.encode_kernel."""
    from iris_tpu_torch.models import cuda_hashgrid
    from iris_tpu_torch.models import hashgrid as H
    from iris_tpu_torch.utils import graphs

    cfg, table, x = _hash_case(card, "packed", 4133)
    ctx = graphs.GraphContext(card)
    with ctx.on_stream():
        eager = H.hashgrid_encode(table, cfg, x)
    ctx.warm = True
    g = ctx.capture(lambda: H.hashgrid_encode(table, cfg, x),
                    name="probe_encode")
    assert g.marks.tally["hashgrid.encode_kernel"] == 1
    before = cuda_hashgrid.launch_counts()["encode"]
    assert torch.equal(g.replay(), eager)
    x.copy_(x.flip(0))
    got = g.replay().clone()
    assert cuda_hashgrid.launch_counts()["encode"] == before + 2
    assert torch.equal(got, H.hashgrid_encode(table, cfg, x))
    assert not torch.equal(got, eager)


@pytest.mark.parametrize("mode,keyed", [
    ("packed", False), ("packed", True), ("rows", False), ("rows", True),
    ("rows_bf16", True)])
def test_hashgrid_kernel_gradient_is_the_plain_paths(card, monkeypatch, mode,
                                                     keyed):
    """A table that needs a gradient: the kernel path's features and table
    gradient (the exact backward from the recomputed corners, or the
    stochastic one at the same draws) are the plain path's on the card,
    bit for bit."""
    from iris_tpu_torch.models import hashgrid as H

    cfg, table, x = _hash_case(card, mode, 4133)

    def run():
        tb = table.clone().requires_grad_(True)
        gen = torch.Generator(device=card).manual_seed(5) if keyed else None
        out = H.hashgrid_encode(tb, cfg, x, gen)
        g = torch.linspace(-1, 1, out.numel(), device=card).reshape(out.shape)
        (d,) = torch.autograd.grad(out, tb, g)
        return out, d

    got = run()
    monkeypatch.setattr(H, "_kernel_runs", lambda x: False)
    want = run()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_hashgrid_kernel_refuses_what_it_does_not_take(card):
    from iris_tpu_torch.models import cuda_hashgrid

    cfg, table, x = _hash_case(card, "rows", 64)
    args = _kernel_args(cfg, table, x, "rows")
    bad = {0: [table.half(), table.reshape(-1), table.cpu(), table.t()],
           1: [x.double(), x[:, :2].contiguous(), x.cpu(),
               x.t().contiguous().t()],
           3: ["nearest", "packed"]}
    for pos, values in bad.items():
        for v in values:
            with pytest.raises(ValueError, match="encode kernel"):
                cuda_hashgrid.encode(*args[:pos], v, *args[pos + 1:])
    # a row the lanes do not divide: 6 features
    with pytest.raises(ValueError, match="encode kernel"):
        cuda_hashgrid.encode(table[:, :6].contiguous(), *args[1:5], 6,
                             *args[6:])
    flat = table.reshape(-1)
    for t, block in ((flat, flat.numel()), (flat.half(), flat.numel() // 2),
                     (flat.cpu(), flat.numel() // 2), (table, 8),
                     (flat[::2], flat.numel() // 4)):
        with pytest.raises(ValueError, match="encode kernel"):
            cuda_hashgrid.pack(t, block)
