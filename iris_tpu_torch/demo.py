"""Self-contained flagship setup on the procedural box scene (counterpart
of iris_tpu/demo.py): BVH tracer, SLF emitter, hash-grid BRDF and EMoR CRF
without any dataset on disk.

The defaults are the JAX demo's (iris_tpu/demo.py:25-33): a 16-level x
2-feature flat grid with 2^15 entries and a 32^3 SLF, row mode chosen by
hash_features > 2. The production model (pipeline/config.py:70-79 of the
JAX package, the model bench.py times) is make_demo_scene(slf_res=64,
hash_levels=4, log2_table=19, hash_features=16, per_level_scale=-1.0); the
reference's is hash_levels=32, log2_table=19 with the other defaults.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from iris_tpu_torch.device import resolve_device
from iris_tpu_torch.geometry.bvh import build_bvh
from iris_tpu_torch.geometry.procedural import camera_rays, make_box_scene
from iris_tpu_torch.models.brdf import init_ngp_brdf, ngp_brdf_apply
from iris_tpu_torch.models.crf import init_emor_crf
from iris_tpu_torch.models.emitter import make_emitter
from iris_tpu_torch.models.hashgrid import HashGridConfig
from iris_tpu_torch.models.slf import init_voxel_slf


def make_demo_scene(n_clutter: int = 8, slf_res: int = 32,
                    hash_levels: int = 16, log2_table: int = 15,
                    seed: int = 0, hash_features: int = 2,
                    per_level_scale: float = 1.3, leaf_size: int = 4,
                    device=None, policy=None):
    """Returns (tracer, emitter, ngp_params, crf, mesh) on `device`;
    `policy` is the tracer's TraversalPolicy (geometry/bvh.py).

    per_level_scale <= 0 = auto: span the reference 32-level resolution
    range (16 .. 16*1.3^31) at any level count. The SLF radiance is zero,
    as in the JAX package; the NGP weights are random from `seed`."""
    dev = resolve_device(device)
    mesh, is_em = make_box_scene(n_clutter=n_clutter, seed=seed)
    tracer = build_bvh(mesh.triangles(), leaf_size=leaf_size, device=dev,
                       policy=policy)
    slf = init_voxel_slf(np.ones((slf_res,) * 3, bool), -0.1, 2.1,
                         device=dev)
    em = make_emitter(
        is_em, mesh.triangles(),
        radiance=np.full((int(is_em.sum()), 3), 10.0, np.float32),
        slf=slf, device=dev)
    if per_level_scale <= 0:
        per_level_scale = 1.3 ** (31.0 / max(hash_levels - 1, 1))
    ngp = init_ngp_brdf(
        seed, -0.1, 2.1,
        HashGridConfig(n_levels=hash_levels, log2_table_size=log2_table,
                       n_features=hash_features,
                       per_level_scale=per_level_scale,
                       row_gather=hash_features > 2),
        device=dev)
    crf = init_emor_crf(dim=3, device=dev)
    return tracer, em, ngp, crf, mesh


def make_demo_batch(n_side: int = 64, seg_grid: int = 8, device=None):
    """A pixel batch shaped like the dataset wire format: rays (B, 12),
    rgbs, segmentation, int_albedo, exposure."""
    dev = resolve_device(device)
    o, d, dxdu, dydv = camera_rays(n_side)
    b = o.shape[0]
    rays = np.concatenate([o, d, dxdu, dydv], -1).astype(np.float32)
    rng = np.random.default_rng(0)
    seg = (np.arange(b) // max(b // seg_grid, 1)).astype(np.float32)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    return {
        "rays": t(rays),
        "rgbs": t(rng.uniform(0, 1, (b, 3)).astype(np.float32)),
        "segmentation": t(seg),
        "int_albedo": t(rng.uniform(0, 1, (b, 3)).astype(np.float32)),
        "exposure": torch.ones((b, 1), dtype=torch.float32, device=dev),
    }


def demo_mat_fn(ngp_params):
    return functools.partial(ngp_brdf_apply, ngp_params)
