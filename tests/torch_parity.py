"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
carry JAX-package objects into the port through iris_tpu_torch.convert,
and the hit-agreement bar for traversals."""

from __future__ import annotations

import numpy as np
import torch

from iris_tpu_torch import convert

DEV = "cpu"


def port_tracer(jt):
    return convert.tracer(
        nodes=np.asarray(jt.nodes), tris=np.asarray(jt.tris),
        face_normals=np.asarray(jt.face_normals), n_nodes=jt.n_nodes,
        leaf_size=jt.leaf_size, n_faces=jt.n_faces, layout=jt.layout,
        depth=jt.depth, device=DEV)


def port_ngp(jn):
    cfg = {k: getattr(jn.cfg, k) for k in (
        "n_levels", "n_features", "log2_table_size", "base_resolution",
        "per_level_scale", "row_gather")}
    return convert.ngp_brdf(
        table=np.asarray(jn.table),
        mlp_w=[np.asarray(w) for w in jn.mlp["w"]],
        mlp_b=[np.asarray(b) for b in jn.mlp["b"]],
        voxel_min=np.asarray(jn.voxel_min), voxel_max=np.asarray(jn.voxel_max),
        cfg=cfg, device=DEV)


def port_slf(js):
    return convert.voxel_slf(
        inds=np.asarray(js.inds), radiance=np.asarray(js.radiance),
        count=np.asarray(js.count), voxel_min=np.asarray(js.voxel_min),
        voxel_max=np.asarray(js.voxel_max), H=js.H, device=DEV)


def port_emitter(je):
    return convert.emitter(
        is_emitter=np.asarray(je.is_emitter),
        emitter_idx=np.asarray(je.emitter_idx),
        triangle_idx=np.asarray(je.triangle_idx),
        emitter_vertices=np.asarray(je.emitter_vertices),
        emitter_area=np.asarray(je.emitter_area),
        radiance=np.asarray(je.radiance),
        emitter_pdf=np.asarray(je.emitter_pdf),
        emitter_cdf=np.asarray(je.emitter_cdf),
        slf=None if je.slf is None else port_slf(je.slf), device=DEV)


def port_crf(jc):
    return convert.emor_crf(weight=np.asarray(jc.weight),
                            f0=np.asarray(jc.f0), basis=np.asarray(jc.basis),
                            device=DEV)


def tt(a, dtype=torch.float32):
    """numpy -> CPU tensor."""
    return torch.as_tensor(np.array(a), dtype=dtype)


def assert_hits_agree(t1, f1, t2, f2):
    """The traversal bar: hit/miss equal on >= 99.9% of rays; t within
    1e-5 relative where both hit; face ids equal except where the two
    walks met faces at t equal within 1e-6 (the first of equal-t hits in
    visiting order wins, and visiting orders differ)."""
    t1, t2 = np.asarray(t1, np.float64), np.asarray(t2, np.float64)
    f1, f2 = np.asarray(f1).astype(np.int64), np.asarray(f2).astype(np.int64)
    v1, v2 = f1 >= 0, f2 >= 0
    assert (v1 == v2).mean() >= 0.999, (v1 != v2).sum()
    both = v1 & v2
    np.testing.assert_allclose(t1[both], t2[both], rtol=1e-5)
    differ = both & (f1 != f2)
    tie = np.abs(t1 - t2) <= 1e-6 * np.maximum(1.0, np.abs(t1))
    assert np.all(tie[differ]), np.flatnonzero(differ & ~tie)
