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


@pytest.mark.parametrize("n_clutter,leaf_size", [(12, 4), (500, 4),
                                                 (500, 16)])
def test_ordered_matches_plain(card, n_clutter, leaf_size):
    mesh, _ = make_box_scene(n_clutter=n_clutter, seed=4)
    tracer = build_bvh(mesh.triangles(), leaf_size=leaf_size, device=card)
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
