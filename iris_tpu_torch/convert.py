"""Carry state across from the JAX package and back: its arrays, as numpy,
in, the port's objects out; and the port's parameters and gradients out
again as numpy under the JAX pytree's leaf names. Imports neither JAX nor
iris_tpu: the caller does the np.asarray(...) on the JAX side and passes
the static fields as plain values.

- tracer: the BVH arrays and static fields, unchanged (same layout);
- ngp_brdf: the table in its own layout. A flat or packed table stays the
  flat (F*L*T,) array, feature j at [j*L*T, (j+1)*L*T) (hashgrid.py:160-178).
  A row-mode table, 1-D or (with row_native_layout) already (L*T, F),
  becomes its (L*T, F) row view, element (level*T + entry)*F + feature
  (hashgrid.py:79-88). MLP weights and biases as lists; the hash-grid
  config as a dict of its fields, every one carried (the table's mode and
  the estimator fields included);
- implicit_mlp: the trunk's and the head's weights and biases as lists,
  and n_freqs (models/mlps.py);
- emitter, voxel_slf: every field;
- emor_crf: weight, f0 and basis;
- leaves_to_numpy: a params tree, or the gradient dict of
  train.loop.value_and_grad, as {leaf name: numpy array}, the table back in
  the layout the JAX package holds it in.
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
    (HASHGRID_FIELDS, all of the JAX package's) are carried; absent ones
    keep the port's defaults."""
    dev = resolve_device(device)
    hcfg = HashGridConfig(**{k: cfg[k] for k in HASHGRID_FIELDS
                             if k in cfg})
    table = np.asarray(table, np.float32)
    n = hcfg.n_levels * hcfg.table_size
    if table.size != n * hcfg.n_features:
        raise ValueError(f"table of {table.size} values for a "
                         f"{hcfg.n_levels} x {hcfg.n_features} x "
                         f"{hcfg.table_size} grid")
    if table.ndim != (2 if hcfg.row_gather and hcfg.row_native_layout
                      else 1):
        raise ValueError(f"a {table.ndim}-D table does not fit row_gather="
                         f"{hcfg.row_gather}, row_native_layout="
                         f"{hcfg.row_native_layout}")
    if hcfg.row_gather:
        table = table.reshape(n, hcfg.n_features)
    return NGPBRDF(
        table=_t(table, dev),
        mlp={"w": [_t(w, dev) for w in mlp_w],
             "b": [_t(b, dev) for b in mlp_b]},
        voxel_min=_t(voxel_min, dev), voxel_max=_t(voxel_max, dev),
        cfg=hcfg)


def implicit_mlp(trunk_w, trunk_b, head_w, head_b, n_freqs,
                 device=None) -> dict:
    """models/mlps.py's parameter dict from the JAX tree's
    params["trunk"]["w"], ["trunk"]["b"], params["head"]["w"] and
    ["head"]["b"] (lists of arrays) and its n_freqs."""
    dev = resolve_device(device)
    return {"trunk": {"w": [_t(w, dev) for w in trunk_w],
                      "b": [_t(b, dev) for b in trunk_b]},
            "head": {"w": [_t(w, dev) for w in head_w],
                     "b": [_t(b, dev) for b in head_b]},
            "n_freqs": int(n_freqs)}


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


def leaves_to_numpy(tree, row_native_layout: bool = False) -> dict:
    """{leaf name: numpy array} of a params tree or of a gradient dict
    keyed by leaf name (train.optim.named_leaves gives the names:
    "material.table", "material.mlp.w.0", "radiance", ...). A table goes
    back in the layout convert.ngp_brdf was given: a 2-D array is a
    row-mode table's (L*T, F) rows and is flattened to (L*T*F,) unless
    `row_native_layout`; a 1-D array is a flat table and stays as it is.
    A gradient dict carries no config, so say row_native_layout=True for
    one whose model has it."""
    from iris_tpu_torch.train.optim import named_leaves

    if isinstance(tree, dict) and all(
            isinstance(v, torch.Tensor) for v in tree.values()):
        flat, native = tree, set()
    else:
        flat = dict(named_leaves(tree))
        native = {name + ".table" if name else "table"
                  for name, field in _ngp_fields(tree)
                  if field.cfg.row_native_layout}
    out = {}
    for name, t in flat.items():
        # a copy: the optimizer updates the leaves in place
        a = t.detach().cpu().numpy().copy()
        keep = row_native_layout or name in native
        out[name] = (a.reshape(-1) if name.endswith("table") and not keep
                     else a)
    return out


def _ngp_fields(tree, prefix: str = ""):
    """(leaf-name prefix, NGPBRDF) of every field in a params tree."""
    if isinstance(tree, NGPBRDF):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [hit for k, v in tree.items() for hit in _ngp_fields(
            v, prefix + "." + str(k) if prefix else str(k))]
    return []
