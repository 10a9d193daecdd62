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
