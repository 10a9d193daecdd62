"""Generate a miniature FIPT-synthetic-layout dataset from the procedural
box scene, rendered by the port's own integrator with a known ground-truth
BRDF, emitter and CRF (counterpart of iris_tpu/data/make_demo_dataset.py).

Purpose: hermetic end-to-end pipeline runs on the card, where the JAX
package is not installed. Everything computed without random draws equals
the JAX generator's output for the same arguments: scene.obj,
transforms.json, cam/{exposure,crf}.npy and the GT DiffCol, Roughness, Emit,
IndexMA and segmentation maps. The HDR renders (and the LDR PNGs made from
them) and the GT a' map draw from torch.Generators, so they are the same
estimates with other samples: the JAX package draws a' with PRNGKey(7).

Layout written (matches utils/dataset/synthetic_ldr.py expectations):
  root/scene.obj
  root/{split}/transforms.json
  root/{split}/Image/{i:03d}_0001.exr        HDR renders
  root/{split}/{IMG_DIR}/{i:03d}_0001.png    LDR via GT CRF
  root/{split}/{IMG_DIR}/cam/{exposure,crf}.npy
  root/{split}/{IMG_DIR}/albedo/{i:03d}_0001.png   pseudo intrinsic albedo
  root/{split}/{DiffCol,Roughness,Emit}/{i:03d}_0001.exr
  root/{split}/albedo/{i:03d}.exr            GT a'
  root/{split}/IndexMA/{i:03d}_0001.exr      part segmentation
  root/{split}/segmentation/{i:03d}.exr      semantic segmentation
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from iris_tpu_torch.data.rays import (
    concat_rays, get_ray_directions_blender, get_rays_blender,
)
from iris_tpu_torch.device import resolve_device
from iris_tpu_torch.geometry.bvh import build_bvh
from iris_tpu_torch.geometry.intersect import ray_intersect
from iris_tpu_torch.geometry.procedural import make_box_scene
from iris_tpu_torch.models import brdf as B
from iris_tpu_torch.models.crf import crf_forward, get_crf, init_emor_crf
from iris_tpu_torch.models.emitter import eval_emitter, make_emitter
from iris_tpu_torch.models.slf import init_voxel_slf
from iris_tpu_torch.render.integrator import draw_uniform, path_tracing
from iris_tpu_torch.utils.exr import write_exr
from iris_tpu_torch.utils.image import save_image

IMG_DIR = "ldr"
GT_RADIANCE = 10.0
# the fixed cameras used while n_train + n_val <= 8 (and orbit is off)
FIXED_CAMERAS = [
    ((0.5, 0.5, 0.5), (1.0, 1.0, 0.45)),
    ((1.0, 1.0, 0.3), (1.05, 1.0, 0.98)),  # looks up at the light
    ((0.5, 1.5, 0.4), (1.0, 1.0, 0.45)),
    ((1.5, 1.5, 0.6), (1.0, 1.0, 0.45)),
    ((1.0, 0.3, 0.5), (1.0, 1.0, 0.45)),
    ((0.3, 1.0, 0.45), (1.0, 1.0, 0.45)),
    ((1.7, 1.0, 0.55), (1.0, 1.0, 0.45)),
    ((1.0, 1.7, 0.5), (1.0, 1.0, 0.45)),
]


def gt_mat_fn(position: torch.Tensor, metallic_amp: float = 0.0) -> dict:
    """Smooth spatially-varying GT BRDF (closed form, for eval).

    metallic_amp > 0 adds a smooth metallic, low-roughness blob, so that
    roughness and metallic are observable somewhere in the scene."""
    p = torch.clamp(position / 2.0, 0.0, 1.0)
    albedo = torch.stack([
        0.2 + 0.6 * p[..., 0],
        0.3 + 0.4 * p[..., 1],
        0.5 - 0.3 * p[..., 2],
    ], -1)
    roughness = 0.4 + 0.5 * p[..., 2:3]
    metallic = torch.zeros_like(roughness)
    if metallic_amp:
        gate = torch.exp(-18.0 * ((p[..., 0:1] - 0.4) ** 2
                                  + (p[..., 1:2] - 0.55) ** 2))
        metallic = metallic_amp * gate
        # floor 0.2: metric_brdf clamps GT and prediction to [0.2, 1]
        roughness = torch.clamp(roughness - 0.55 * gate, 0.2, 1.0)
    return {"albedo": albedo, "roughness": roughness, "metallic": metallic}


def _camera_pose(origin, lookat):
    fwd = np.asarray(lookat, np.float64) - origin
    fwd /= np.linalg.norm(fwd)
    up_w = np.asarray([0.0, 0.0, 1.0])
    right = np.cross(fwd, up_w)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    # blender convention: local x = left, y = up, z = forward
    r = np.stack([-right, up, fwd], axis=-1)
    return np.hstack([r, np.asarray(origin, np.float64).reshape(3, 1)])


def _orbit_cameras(tracer, need: int, seed: int, dev):
    """Procedural orbit inside the room for captures past the fixed list,
    one emitter-facing view kept; a pose inside or against clutter (any
    of 6 axis probes hitting within 0.08, or the view ray blocked within
    0.2) is nudged along the orbit and drawn again."""
    crng = np.random.default_rng(seed + 1)
    probe_dirs = np.asarray(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
         [0, 0, 1], [0, 0, -1]], np.float32)

    def cam_ok(c, look):
        v = np.asarray(look, np.float32) - np.asarray(c, np.float32)
        v = v / max(float(np.linalg.norm(v)), 1e-9)
        dirs = np.concatenate([probe_dirs, v[None]], 0)
        o = np.ascontiguousarray(
            np.broadcast_to(np.asarray(c, np.float32), dirs.shape))
        pos, _, _, _, valid = ray_intersect(
            tracer, torch.from_numpy(o).to(dev),
            torch.from_numpy(dirs).to(dev))
        dist = np.linalg.norm(pos.cpu().numpy() - o, axis=-1)
        dist = np.where(valid.cpu().numpy(), dist, 1e9)
        return float(dist[:6].min()) > 0.08 and float(dist[6]) > 0.2

    cams = []
    for i in range(need):
        ang = 2.0 * np.pi * i / need
        for _ in range(100):
            r = 0.65 + 0.2 * crng.uniform()
            c = (1.0 + r * np.cos(ang), 1.0 + r * np.sin(ang),
                 0.35 + 0.3 * crng.uniform())
            if i == 1:
                look = (1.05, 1.0, 0.98)
            else:
                look = (1.0 + 0.25 * crng.uniform(-1, 1),
                        1.0 + 0.25 * crng.uniform(-1, 1),
                        0.3 + 0.3 * crng.uniform())
            if cam_ok(c, look):
                break
            ang += 0.05          # nudge along the orbit and retry
        cams.append((c, look))
    return cams


def make_dataset(root: str, img_hw=(48, 64), n_train: int = 6,
                 n_val: int = 2, spp: int = 48, indir_depth: int = 2,
                 seed: int = 0, n_clutter: int = 4, chunk_px: int = 1 << 15,
                 metallic_amp: float = 0.0, orbit: bool = False,
                 device=None):
    """Write the dataset under `root` and return it. chunk_px bounds the
    pixels of one path_tracing call. The cameras are the fixed list while
    n_train + n_val <= 8, as in the JAX package, unless `orbit` asks for
    the orbit search (_orbit_cameras) at any frame count: in a dense
    clutter scene the fixed cameras sit inside boxes and see black. The
    renders draw from one torch.Generator per frame, seeded 100 + frame
    index (the JAX package folds PRNGKey(100 + i) per chunk); a' from one
    seeded 7."""
    dev = resolve_device(device)

    def mat_fn(pp):
        return gt_mat_fn(pp, metallic_amp)

    mesh, is_em = make_box_scene(n_clutter=n_clutter, seed=seed)
    tracer = build_bvh(mesh.triangles(), device=dev)
    n_em = int(is_em.sum())
    slf = init_voxel_slf(np.ones((8, 8, 8), bool), -0.1, 2.1, device=dev)
    # zero cache: full path tracing does the work
    em = make_emitter(is_em, mesh.triangles(),
                      radiance=np.full((n_em, 3), GT_RADIANCE, np.float32),
                      slf=slf, device=dev)
    crf = init_emor_crf(dim=3, device=dev)  # GT CRF = mean EMoR curve
    h, w = img_hw
    fov_x = np.radians(70.0)
    focal = 0.5 * w / np.tan(fov_x / 2)

    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "scene.obj"), "w") as f:
        for v in mesh.vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for tri in mesh.faces + 1:
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")

    need = n_train + n_val
    cams_all = (FIXED_CAMERAS if need <= len(FIXED_CAMERAS) and not orbit
                else _orbit_cameras(tracer, need, seed, dev))

    @torch.no_grad()
    def render(rays, gen):
        return path_tracing(gen, tracer, em, mat_fn, rays[:, :3],
                            rays[:, 3:6], rays[:, 6:9], rays[:, 9:12], spp,
                            indir_depth)

    @torch.no_grad()
    def first_hit_gt(rays, gen):
        o, d = rays[:, :3], rays[:, 3:6]
        pos, nrm, _, tri, valid = ray_intersect(tracer, o, d)
        mat = mat_fn(pos)
        emit = eval_emitter(em, pos, d, tri)[0]
        # GT a' reflectance with the render AOV's composition
        kd = mat["albedo"] * (1 - mat["metallic"])
        ks = 0.04 * (1 - mat["metallic"]) + mat["albedo"] * mat["metallic"]
        s2 = draw_uniform(gen, (pos.shape[0], 2), dev)
        _, _, g0, g1 = B.sample_specular(s2, -d, nrm, mat["roughness"])
        a_prime = g0 * ks + g1 + kd
        return (mat["albedo"], mat["roughness"], emit, tri, valid, a_prime)

    def chunked(fn, rays_np, gen):
        """fn over pixel chunks of at most chunk_px, results as numpy."""
        outs = []
        for b0 in range(0, rays_np.shape[0], chunk_px):
            a = fn(torch.from_numpy(rays_np[b0:b0 + chunk_px]).to(dev), gen)
            a = a if isinstance(a, tuple) else (a,)
            outs.append([x.cpu().numpy() for x in a])
        res = tuple(np.concatenate([o[i] for o in outs], 0)
                    for i in range(len(outs[0])))
        return res if len(res) > 1 else res[0]

    splits = {"train": cams_all[:n_train],
              "val": cams_all[n_train: n_train + n_val]}
    for split, cams in splits.items():
        sd = os.path.join(root, split)
        for sub in ["Image", IMG_DIR, os.path.join(IMG_DIR, "cam"),
                    os.path.join(IMG_DIR, "albedo"), "albedo", "DiffCol",
                    "Roughness", "Emit", "IndexMA", "segmentation"]:
            os.makedirs(os.path.join(sd, sub), exist_ok=True)
        frames = []
        directions = get_ray_directions_blender(h, w, focal)
        for i, (c, look) in enumerate(cams):
            c2w = _camera_pose(c, look)
            frames.append({"transform_matrix":
                           np.vstack([c2w, [0, 0, 0, 1]]).tolist()})
            o, d, dxdu, dydv = get_rays_blender(directions, c2w.astype(
                np.float32), focal)
            rays = concat_rays(o, d, dxdu, dydv)
            gen = torch.Generator(device=dev).manual_seed(100 + i)
            hdr = chunked(render, rays, gen)
            write_exr(os.path.join(sd, "Image", f"{i:03d}_0001.exr"),
                      hdr.reshape(h, w, 3))
            ldr = crf_forward(crf, torch.from_numpy(hdr).to(dev), 1.0)
            save_image(ldr.cpu().numpy().reshape(h, w, 3),
                       os.path.join(sd, IMG_DIR, f"{i:03d}_0001.png"))

            gen = torch.Generator(device=dev).manual_seed(7)
            alb, rough, emit, tri, valid, a_prime = chunked(first_hit_gt,
                                                            rays, gen)
            write_exr(os.path.join(sd, "DiffCol", f"{i:03d}_0001.exr"),
                      alb.reshape(h, w, 3))
            # GT a' for utils/metric_brdf.py (reference FIPT albedo/ layout)
            write_exr(os.path.join(sd, "albedo", f"{i:03d}.exr"),
                      a_prime.reshape(h, w, 3))
            write_exr(os.path.join(sd, "Roughness", f"{i:03d}_0001.exr"),
                      np.repeat(rough, 3, -1).reshape(h, w, 3))
            write_exr(os.path.join(sd, "Emit", f"{i:03d}_0001.exr"),
                      emit.reshape(h, w, 3))
            # part segmentation: coarse face-id buckets
            seg = np.where(valid, (np.maximum(tri, 0) // 12) % 16, 0)
            seg = seg.astype(np.float32).reshape(h, w)
            write_exr(os.path.join(sd, "IndexMA", f"{i:03d}_0001.exr"),
                      np.repeat(seg[..., None], 3, -1))
            write_exr(os.path.join(sd, "segmentation", f"{i:03d}.exr"),
                      np.repeat(seg[..., None], 3, -1))
            # pseudo intrinsic albedo = GT albedo (ideal IRISFormer)
            save_image(alb.reshape(h, w, 3),
                       os.path.join(sd, IMG_DIR, "albedo",
                                    f"{i:03d}_0001.png"))
        with open(os.path.join(sd, "transforms.json"), "w") as f:
            json.dump({"camera_angle_x": fov_x, "frames": frames}, f)
        np.save(os.path.join(sd, IMG_DIR, "cam", "exposure.npy"),
                np.ones(len(cams), np.float32))
        np.save(os.path.join(sd, IMG_DIR, "cam", "crf.npy"),
                get_crf(crf).cpu().numpy().astype(np.float32))
    return root


def main(argv=None):
    from argparse import ArgumentParser

    p = ArgumentParser(description="write the synthetic demo dataset")
    p.add_argument("root")
    p.add_argument("--hw", type=int, nargs=2, default=(48, 64),
                   help="image height width")
    p.add_argument("--n_train", type=int, default=6)
    p.add_argument("--n_val", type=int, default=2)
    p.add_argument("--spp", type=int, default=48)
    p.add_argument("--indir_depth", type=int, default=2)
    p.add_argument("--n_clutter", type=int, default=4,
                   help="12 faces per clutter box (2000 -> ~24K faces)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metallic_amp", type=float, default=0.0,
                   help="amplitude of the metallic low-roughness blob "
                        "(0 = the all-dielectric scene)")
    p.add_argument("--orbit", action="store_true",
                   help="search orbit cameras clear of clutter at any frame "
                        "count (the JAX package does past 8 frames only)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    a = p.parse_args(argv)
    make_dataset(a.root, img_hw=tuple(a.hw), n_train=a.n_train,
                 n_val=a.n_val, spp=a.spp, indir_depth=a.indir_depth,
                 seed=a.seed, n_clutter=a.n_clutter,
                 metallic_amp=a.metallic_amp, orbit=a.orbit,
                 device=a.device)
    print("wrote", a.root)


if __name__ == "__main__":
    main()
