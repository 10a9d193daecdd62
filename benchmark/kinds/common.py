"""What both kinds of cell build: the inputs from the seed, the program's
scene and field over them, and the reference's own."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import gen
from benchmark import reference as R


class Inputs:
    """The run's inputs on `device`: scene triangles, emitter faces, the
    views (fixed set, in the seed's order) and the weights."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        sc = cfg["scene"]
        self.tris, self.is_emitter = gen.box_scene(sc["n_clutter"])
        self.hw = tuple(traffic["image_hw"])
        v = gen.views(traffic["n_views"], traffic["view_seed"], self.hw,
                      traffic["fov_deg"])
        self.views = v[gen.view_order(len(v), seed)]
        self.weights = gen.weights(cfg, traffic, int(self.is_emitter.sum()),
                                   seed, device)
        self.bounds = tuple(cfg["field_bounds"])
        self.slf_bounds = tuple(cfg["slf"]["bounds"])
        self.cfg, self.device = cfg, device


def _f32(x, device):
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def program_scene(inp: Inputs):
    """(tracer, emitter, crf, field) of the program over the inputs: the
    program's own BVH and emitter tables, the benchmark's weights."""
    from dataclasses import replace

    from iris_tpu_torch.geometry.bvh import build_bvh
    from iris_tpu_torch.models.brdf import NGPBRDF
    from iris_tpu_torch.models.crf import init_emor_crf
    from iris_tpu_torch.models.emitter import make_emitter
    from iris_tpu_torch.models.hashgrid import HashGridConfig
    from iris_tpu_torch.models.slf import VoxelSLF

    dev, cfg, w = inp.device, inp.cfg, inp.weights
    tracer = build_bvh(inp.tris, device=dev)
    h = cfg["slf"]["resolution"]
    slf = VoxelSLF(inds=torch.arange(h ** 3, device=dev),
                   radiance=w["slf_radiance"],
                   count=torch.ones(h ** 3, device=dev),
                   voxel_min=_f32(inp.slf_bounds[0], dev),
                   voxel_max=_f32(inp.slf_bounds[1], dev), H=h)
    em = make_emitter(inp.is_emitter, inp.tris,
                      radiance=w["radiance"].cpu().numpy(), slf=slf,
                      device=dev)
    crf = replace(init_emor_crf(dim=cfg["crf"]["dim"], device=dev),
                  weight=w["crf_weight"])
    g = cfg["hash_grid"]
    grid = HashGridConfig(
        n_levels=g["n_levels"], n_features=g["n_features"],
        log2_table_size=g["log2_table_size"],
        base_resolution=g["base_resolution"],
        per_level_scale=g["per_level_scale"], row_gather=g["row_gather"],
        packed_gather=g["packed_gather"],
        stochastic_bwd=g["stochastic_bwd"],
        stochastic_fwd=g["stochastic_fwd"],
        bwd_level_sample=g["bwd_level_sample"],
        fwd_level_sample=g["fwd_level_sample"],
        bwd_scatter_dtype=g["bwd_scatter_dtype"])
    field = NGPBRDF(table=w["table"], mlp=w["mlp"],
                    voxel_min=_f32(inp.bounds[0], dev),
                    voxel_max=_f32(inp.bounds[1], dev), cfg=grid)
    return tracer, em, crf, field


def reference_scene(inp: Inputs, weights: dict, dt=torch.float32):
    """(scene, field, (f0, basis)) of the reference over the inputs and
    `weights` (its own copy), computing in `dt`."""
    dev, cfg = inp.device, inp.cfg
    f0, basis = R.emor(cfg["crf"]["dim"])
    lo, hi = (_f32(b, dev).to(dt) for b in inp.bounds)
    slo, shi = (_f32(b, dev).to(dt) for b in inp.slf_bounds)
    scene = R.Scene(inp.tris, inp.is_emitter, weights["radiance"],
                    weights["slf_radiance"], cfg["slf"]["resolution"],
                    (slo, shi), dev, dt)
    field = R.Field(cfg["hash_grid"], weights["table"], weights["mlp"], lo,
                    hi, dt)
    crf = (torch.as_tensor(f0, device=dev).to(dt),
           torch.as_tensor(basis, device=dev).to(dt))
    return scene, field, crf


def as_device(batch: dict, device, dt=torch.float32) -> dict:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        out[k] = t.to(dt) if t.is_floating_point() else t
    return out


def free_cuda():
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

