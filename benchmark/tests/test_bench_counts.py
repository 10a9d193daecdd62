"""The traversal roofline's count and the trace reader's interval union,
on inputs counted by hand."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import bvh, gen, roofline, trace_reader


def test_roofline_counts_a_quad_by_hand():
    # one quad (two faces) fits one leaf: a ray that hits it costs the
    # root's slab test and both triangle tests
    tris = np.asarray(gen._box((0, 0, 0), (1, 1, 1))[:2], np.float32)
    b = bvh.build(tris, "cpu")
    o = torch.tensor([[0.3, 0.4, -1.0], [5.0, 5.0, -1.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    counts: dict = {}
    t, face = bvh.closest_hit(b, o, d, counts)
    assert face.tolist()[1] == -1 and face.tolist()[0] in (0, 1)
    assert float(t[0]) == 1.0
    # the miss stops at the root box
    assert counts == {"rays": 2, "slab": 2, "tri": 2}
    sec, bound, nbytes, ops = roofline.least_time(2, 1, 2, 2, 2)
    assert nbytes == 2 * (24 + 16) + 2 * 36
    assert ops == 2 * 24 + 2 * 55
    assert bound == "bytes" and sec == nbytes / 3.35e12


def test_roofline_count_ignores_the_programs_tree():
    """The count is of the benchmark's own walk over the rays and faces:
    the program's trees of two builders and both leaf sizes find the same
    hits, and nothing of them enters the count."""
    from iris_tpu_torch.geometry.bvh import build_bvh
    from iris_tpu_torch.geometry.intersect import ray_intersect

    tris, _ = gen.box_scene(30)
    rng = np.random.default_rng(1)
    o = torch.tensor(rng.uniform([0.1, 0.1, 0.1], [1.9, 1.9, 0.9],
                                 (500, 3)), dtype=torch.float32)
    d = torch.nn.functional.normalize(torch.tensor(
        rng.normal(size=(500, 3)), dtype=torch.float32), dim=-1)
    counts: dict = {}
    _, face = bvh.closest_hit(bvh.build(tris, "cpu"), o, d, counts)
    for method, leaf in (("sah", 4), ("morton", 4), ("sah", 8)):
        tracer = build_bvh(tris, leaf_size=leaf, method=method,
                           device="cpu")
        idx = ray_intersect(tracer, o, d)[3]
        assert torch.equal(idx, face)
    again: dict = {}
    bvh.closest_hit(bvh.build(tris, "cpu"), o, d, again)
    assert again == counts and counts["rays"] == 500


def test_walk_matches_brute_force():
    from iris_tpu_torch.geometry.intersect import ray_intersect_brute

    tris, _ = gen.box_scene(60)
    rng = np.random.default_rng(0)
    o = torch.tensor(rng.uniform([0.1, 0.1, 0.1], [1.9, 1.9, 0.9],
                                 (2000, 3)), dtype=torch.float32)
    d = torch.nn.functional.normalize(torch.tensor(
        rng.normal(size=(2000, 3)), dtype=torch.float32), dim=-1)
    _, face = bvh.closest_hit(bvh.build(tris, "cpu"), o, d)
    assert torch.equal(face, ray_intersect_brute(torch.tensor(tris), o,
                                                 d)[3])


def _x(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_idle_share_of_overlapping_kernels():
    # a unit of 100 us; kernels [10, 40) and [30, 60) overlap, [80, 90):
    # busy 60 us, idle 0.4; launches 2 of the 3 runtime calls
    ev = [_x("bench_unit", 0, 100, "user_annotation"),
          _x("k_a", 10, 30, "kernel"), _x("k_b", 30, 30, "kernel"),
          _x("trace_paired_streamed_kernel", 80, 10, "kernel"),
          _x("cudaLaunchKernel", 5, 1, "cuda_runtime"),
          _x("cudaGraphLaunch", 65, 1, "cuda_runtime"),
          _x("cudaMemcpyAsync", 71, 1, "cuda_runtime"),
          _x("aten::sort", 60, 20, "cpu_op")]
    s = trace_reader.summarize(ev, 2)
    assert abs(s["idle_share"] - 0.4) < 1e-12
    assert s["busy_s"] == 60e-6 and s["wall_s"] == 100e-6
    assert s["traversal_ms"] == 10 / 2 / 1e3
    assert s["models_ms"] == 60 / 2 / 1e3
    assert s["kernels_per_unit"] == 1.5 and s["host_launch_calls"] == 1.0
    gaps = dict((n, v) for n, v in s["breakdown"]["idle_gaps"])
    assert gaps["aten::sort"] == 20e-6 and len(gaps) == 3
    assert trace_reader.union([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]
