"""Carry state across from the JAX package and back: its arrays, as numpy,
in, the port's objects out; and the port's parameters and gradients out
again as numpy under the JAX pytree's leaf names. Imports neither JAX nor
iris_tpu: the caller does the np.asarray(...) on the JAX side and passes
the static fields as plain values.

- tracer: the BVH arrays and static fields, unchanged (same layout);
- ngp_brdf: the flat (F*L*T,) row-mode table becomes its (L*T, F) row view,
  element (level*T + entry)*F + feature (hashgrid.py:79-88), so the
  level-major, feature-minor encode order is kept; MLP weights and biases
  as lists; the hash-grid config as a dict of its fields (the estimator
  fields included);
- emitter, voxel_slf: every field;
- emor_crf: weight, f0 and basis;
- leaves_to_numpy: a params tree, or the gradient dict of
  train.loop.value_and_grad, as {leaf name: numpy array}, the table back in
  the JAX package's flat layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from iris_tpu_torch.device import resolve_device
from iris_tpu_torch.geometry.bvh import Tracer
from iris_tpu_torch.models.brdf import NGPBRDF
from iris_tpu_torch.models.crf import EmorCRF
from iris_tpu_torch.models.emitter import Emitter
from iris_tpu_torch.models.hashgrid import HashGridConfig
from iris_tpu_torch.models.slf import VoxelSLF

HASHGRID_FIELDS = tuple(f.name for f in dataclasses.fields(HashGridConfig))


def _t(a, dev, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype, device=dev)


def tracer(nodes, tris, face_normals, n_nodes, leaf_size, n_faces,
           layout, depth, device=None) -> Tracer:
    dev = resolve_device(device)
    return Tracer(nodes=_t(nodes, dev), tris=_t(tris, dev),
                  face_normals=_t(face_normals, dev), n_nodes=int(n_nodes),
                  leaf_size=int(leaf_size), n_faces=int(n_faces),
                  layout=str(layout), depth=int(depth))


def ngp_brdf(table, mlp_w, mlp_b, voxel_min, voxel_max, cfg: dict,
             device=None) -> NGPBRDF:
    """cfg: the JAX HashGridConfig's fields. Those the port has
    (HASHGRID_FIELDS) are carried, absent ones keep the port's defaults,
    and the flat/packed-mode fields are ignored."""
    dev = resolve_device(device)
    hcfg = HashGridConfig(**{k: cfg[k] for k in HASHGRID_FIELDS
                             if k in cfg})
    rows = np.asarray(table, np.float32).reshape(
        hcfg.n_levels * hcfg.table_size, hcfg.n_features)
    return NGPBRDF(
        table=_t(rows, dev),
        mlp={"w": [_t(w, dev) for w in mlp_w],
             "b": [_t(b, dev) for b in mlp_b]},
        voxel_min=_t(voxel_min, dev), voxel_max=_t(voxel_max, dev),
        cfg=hcfg)


def voxel_slf(inds, radiance, count, voxel_min, voxel_max, H,
              device=None) -> VoxelSLF:
    dev = resolve_device(device)
    return VoxelSLF(inds=_t(inds, dev, torch.int64),
                    radiance=_t(radiance, dev), count=_t(count, dev),
                    voxel_min=_t(voxel_min, dev),
                    voxel_max=_t(voxel_max, dev), H=int(H))


def emitter(is_emitter, emitter_idx, triangle_idx, emitter_vertices,
            emitter_area, radiance, emitter_pdf, emitter_cdf,
            slf: VoxelSLF | None = None, device=None) -> Emitter:
    dev = resolve_device(device)
    return Emitter(
        is_emitter=_t(is_emitter, dev, torch.bool),
        emitter_idx=_t(emitter_idx, dev, torch.int64),
        triangle_idx=_t(triangle_idx, dev, torch.int64),
        emitter_vertices=_t(emitter_vertices, dev),
        emitter_area=_t(emitter_area, dev),
        radiance=_t(radiance, dev),
        emitter_pdf=_t(emitter_pdf, dev),
        emitter_cdf=_t(emitter_cdf, dev),
        slf=slf)


def emor_crf(weight, f0, basis, device=None) -> EmorCRF:
    dev = resolve_device(device)
    weight = np.asarray(weight, np.float32)
    return EmorCRF(weight=_t(weight, dev), f0=_t(f0, dev),
                   basis=_t(basis, dev), dim=int(weight.shape[1]))


def leaves_to_numpy(tree) -> dict:
    """{leaf name: numpy array} of a params tree or of a gradient dict
    keyed by leaf name (train.optim.named_leaves gives the names:
    "material.table", "material.mlp.w.0", "radiance", ...). A table's
    (L*T, F) rows go back to the JAX package's flat (L*T*F,) layout."""
    from iris_tpu_torch.train.optim import named_leaves

    flat = (tree if isinstance(tree, dict) and all(
        isinstance(v, torch.Tensor) for v in tree.values())
        else dict(named_leaves(tree)))
    out = {}
    for name, t in flat.items():
        # a copy: the optimizer updates the leaves in place
        a = t.detach().cpu().numpy().copy()
        out[name] = a.reshape(-1) if name.endswith("table") else a
    return out
