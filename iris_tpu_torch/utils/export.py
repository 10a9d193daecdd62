"""Texture export: bake the learned BRDF field into albedo and
roughness-metallic textures and a UV-mapped OBJ (counterpart of
iris_tpu/utils/export.py; role parity with reference utils/export.py,
xatlas unwrap + nvdiffrast rasterization):

- `charts` mode (default): the seam-aware chart unwrap of
  utils/uv_unwrap.py (normal-gated region growing, planar projection with
  fold repair, shelf packing, barycentric atlas rasterization, gutter
  dilation);
- `grid` mode: uniform per-face square charts.

The hash-grid BRDF is queried at every covered texel's surface point on
the device of the material (the card unless --device says otherwise), in
chunks of QUERY_CHUNK points (charts) or of 65,536 texels' faces (grid),
the JAX package's chunk sizes.

Usage: python -m iris_tpu_torch.utils.export --mesh scene.obj
           --ckpt checkpoints/x/brdf1/last.pkl --output outputs/x/tex
           [--unwrap charts|grid] [--res 1024]
Writes albedo.png, rm.png (G roughness, B metallic), scene_uv.obj and
scene_uv.mtl.
"""

from __future__ import annotations

import math
import os
from argparse import ArgumentParser

import numpy as np
import torch

from iris_tpu_torch.device import resolve_device
from iris_tpu_torch.geometry.mesh import load_mesh
from iris_tpu_torch.models.brdf import ngp_brdf_apply
from iris_tpu_torch.train.checkpoint import load_pytree
from iris_tpu_torch.utils.image import save_image
from iris_tpu_torch.utils.uv_unwrap import (
    dilate_texture, rasterize_atlas, unwrap,
)

QUERY_CHUNK = 262144


@torch.no_grad()
def _query(material, pts: np.ndarray) -> dict:
    """The exact-encode material at (N, 3) points, as numpy."""
    dev = material.table.device
    mat = ngp_brdf_apply(material, torch.as_tensor(
        np.asarray(pts, np.float32), device=dev))
    return {k: v.cpu().numpy() for k, v in mat.items()}


def export_textures_charts(mesh, material, res: int = 1024,
                           normal_cos: float = 0.8):
    """Chart-atlas texture bake. Returns (albedo, rm, uvs (F, 3, 2))."""
    uv01, _, res = unwrap(mesh, res=res, normal_cos=normal_cos)
    tri = np.asarray(mesh.triangles(), np.float64)
    rows, cols, pts, mask = rasterize_atlas(tri, uv01, res)

    albedo_tex = np.zeros((res, res, 3), np.float32)
    rm_tex = np.zeros((res, res, 3), np.float32)
    for c0 in range(0, len(pts), QUERY_CHUNK):
        c1 = min(c0 + QUERY_CHUNK, len(pts))
        mat = _query(material, pts[c0:c1])
        albedo_tex[rows[c0:c1], cols[c0:c1]] = mat["albedo"]
        rm_tex[rows[c0:c1], cols[c0:c1], 1] = mat["roughness"][:, 0]
        rm_tex[rows[c0:c1], cols[c0:c1], 2] = mat["metallic"][:, 0]
    albedo_tex = dilate_texture(albedo_tex, mask)
    rm_tex = dilate_texture(rm_tex, mask)
    # OBJ vt convention: v up, image row 0 at top
    uvs = np.stack([uv01[..., 0], 1.0 - uv01[..., 1]], -1).astype(
        np.float32)
    # array row r is sampled by a renderer at vt v' = 1 - r/res, which
    # maps back to PNG row r from the top — same convention as the grid
    # path, so no flip
    return albedo_tex, rm_tex, uvs


def export_textures(mesh, material, texels_per_face: int = 8,
                    max_res: int = 4096):
    """Returns (albedo_tex (R,R,3), rm_tex (R,R,3), uvs (F,3,2))."""
    f = mesh.n_faces
    charts_per_row = int(math.ceil(math.sqrt(f)))
    res = min(charts_per_row * texels_per_face, max_res)
    charts_per_row = res // texels_per_face
    tpf = texels_per_face

    tri = mesh.triangles()
    # barycentric lattice per chart (lower triangle of the square)
    ii, jj = np.meshgrid(np.arange(tpf), np.arange(tpf), indexing="ij")
    u = (ii + 0.33) / tpf
    v = (jj + 0.33) / tpf
    w = np.clip(1.0 - u - v, 0.0, 1.0)
    albedo_tex = np.zeros((res, res, 3), np.float32)
    rm_tex = np.zeros((res, res, 3), np.float32)

    chunk = 65536 // (tpf * tpf) or 1
    for c0 in range(0, f, chunk):
        c1 = min(c0 + chunk, f)
        t = tri[c0:c1]
        pts = (t[:, None, None, 0] * w[None, ..., None]
               + t[:, None, None, 1] * u[None, ..., None]
               + t[:, None, None, 2] * v[None, ..., None])
        mat = _query(material, pts.reshape(-1, 3))
        alb = mat["albedo"].reshape(c1 - c0, tpf, tpf, 3)
        rough = mat["roughness"].reshape(c1 - c0, tpf, tpf)
        metal = mat["metallic"].reshape(c1 - c0, tpf, tpf)
        for k in range(c1 - c0):
            fi = c0 + k
            r0 = (fi // charts_per_row) * tpf
            c0_ = (fi % charts_per_row) * tpf
            albedo_tex[r0: r0 + tpf, c0_: c0_ + tpf] = alb[k]
            rm_tex[r0: r0 + tpf, c0_: c0_ + tpf, 1] = rough[k]
            rm_tex[r0: r0 + tpf, c0_: c0_ + tpf, 2] = metal[k]

    # per-face UVs: triangle corners of each chart
    uvs = np.zeros((f, 3, 2), np.float32)
    for fi in range(f):
        r0 = (fi // charts_per_row) * tpf
        c0_ = (fi % charts_per_row) * tpf
        # corners (w=1), (u=1), (v=1) in texel space -> uv space
        corners = np.asarray([[c0_, r0], [c0_ + tpf - 1, r0],
                              [c0_, r0 + tpf - 1]], np.float32)
        uvs[fi] = np.stack([
            (corners[:, 0] + 0.5) / res, 1.0 - (corners[:, 1] + 0.5) / res,
        ], -1)
    return albedo_tex, rm_tex, uvs


def write_obj_with_uvs(path, mesh, uvs, mtl_name="material0"):
    base = os.path.splitext(path)[0]
    with open(base + ".mtl", "w") as m:
        m.write(f"newmtl {mtl_name}\nmap_Kd albedo.png\n")
    with open(path, "w") as f:
        f.write(f"mtllib {os.path.basename(base)}.mtl\nusemtl {mtl_name}\n")
        for vtx in mesh.vertices:
            f.write(f"v {vtx[0]} {vtx[1]} {vtx[2]}\n")
        for face_uv in uvs.reshape(-1, 2):
            f.write(f"vt {face_uv[0]} {face_uv[1]}\n")
        for i, face in enumerate(mesh.faces):
            a, b, c = face + 1
            t = 3 * i + 1
            f.write(f"f {a}/{t} {b}/{t + 1} {c}/{t + 2}\n")


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--mesh", type=str, required=True)
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--texels_per_face", type=int, default=8)
    parser.add_argument("--unwrap", type=str, default="charts",
                        choices=["charts", "grid"])
    parser.add_argument("--res", type=int, default=1024)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    mesh = load_mesh(args.mesh)
    material = load_pytree(args.ckpt, dev)["material"]
    os.makedirs(args.output, exist_ok=True)
    if args.unwrap == "charts":
        albedo, rm, uvs = export_textures_charts(mesh, material, args.res)
    else:
        albedo, rm, uvs = export_textures(mesh, material,
                                          args.texels_per_face)
    save_image(albedo, os.path.join(args.output, "albedo.png"))
    save_image(rm, os.path.join(args.output, "rm.png"))
    write_obj_with_uvs(os.path.join(args.output, "scene_uv.obj"), mesh, uvs)
    print("[export] wrote textures + UV obj to", args.output)


if __name__ == "__main__":
    main()
