"""Relighting and object-insertion renderer (counterpart of
iris_tpu/pipeline/render_relight.py; reference render_relight.py): reads
the same YAML scene dicts (scripts/relight/**/{relight_*,insert}.yaml) —
a main mesh with the learned FIPT BSDF and the emitter mask, plus sphere
emitters, diffuse and conductor objects, inserted OBJ/PLY meshes and an
optional animated disco ball — and renders them with the merged-scene
path tracer of render/relight.py. Runs on the card unless --device says
otherwise.

Every BVH is built once; frames differ only in tensor data (the disco
phase, written in place). A frame's round `rd` draws from a generator
seeded by (frame, rd) (relight_seed, relight_generator), where the JAX
package draws from fold_in(PRNGKey(frame), rd). On the card a round is
one CUDA graph replay (make_relight_round), where the JAX package calls
one jitted relight_path_tracing (render_relight.py:219-235).

Usage: python -m iris_tpu_torch.pipeline.render_relight --dataset
           synthetic <root> --ldr_img_dir ldr --experiment_name x/brdf1
           --emitter_path <bake dir> --output_path outputs/relight
           --light_cfg scripts/relight/demo_ball.yaml [--disco 1]
Writes {i:05d}.png per frame and relight.mp4 (utils/video.write_video:
a frames directory where there is no ffmpeg backend).
"""

from __future__ import annotations

import os
from argparse import ArgumentParser
from dataclasses import replace as dc_replace

import numpy as np
import torch

from iris_tpu_torch.device import resolve_device
from iris_tpu_torch.geometry.mesh import load_mesh
from iris_tpu_torch.models.crf import crf_forward, init_emor_crf
from iris_tpu_torch.pipeline.common import make_dataset, resolve_mesh_path
from iris_tpu_torch.pipeline.config import add_model_specific_args
from iris_tpu_torch.pipeline.render_video import trajectory_rays
from iris_tpu_torch.render.denoise import denoise_hdr
from iris_tpu_torch.render.relight import (
    apply_to_world, build_relight_scene, make_disco_ball,
    relight_path_tracing, set_disco_phase,
)
from iris_tpu_torch.train.checkpoint import load_pytree
from iris_tpu_torch.utils.graphs import GraphContext, GraphedUnit
from iris_tpu_torch.utils.image import save_image
from iris_tpu_torch.utils.video import write_video

# normal-incidence reflectance of the named mitsuba conductor presets: the
# renderer models conductors as metallic GGX with an F0 tint
_CONDUCTOR_F0 = {
    "Au": [1.0, 0.86, 0.57],
    "Cu": [0.95, 0.64, 0.54],
    "Ag": [0.97, 0.96, 0.91],
    "Al": [0.91, 0.92, 0.92],
    "none": [1.0, 1.0, 1.0],
}


def _bsdf_from_yaml(bsdf_cfg: dict) -> dict:
    """Mitsuba-style bsdf dict -> native bsdf dict. Handles 'twosided'
    wrappers (all geometry is double-sided), 'fipt', 'diffuse'
    (reflectance rgb), 'conductor' (material preset -> F0 tint, roughness
    0.05) and 'roughconductor' (eta/k rgb -> normal-incidence Fresnel F0,
    alpha_u/alpha_v -> GGX roughness)."""
    inner = bsdf_cfg
    if bsdf_cfg.get("type") == "twosided":
        for v in bsdf_cfg.values():
            if isinstance(v, dict) and v.get("type"):
                inner = v
    kind = inner.get("type", "diffuse")
    if kind == "fipt":
        return {"type": "fipt"}
    if kind == "conductor":
        tint = _CONDUCTOR_F0.get(inner.get("material", "none"),
                                 [1.0, 1.0, 1.0])
        return {"type": "conductor", "reflectance": tint,
                "roughness": 0.05}
    if kind == "roughconductor":
        # F0 = ((eta-1)^2 + k^2) / ((eta+1)^2 + k^2); mitsuba's alpha is the
        # GGX alpha = roughness^2, anisotropy collapsed to the geometric
        # mean (the GGX lobe here is isotropic)
        eta = np.asarray(inner.get("eta", {}).get("value", [1.0, 1.0, 1.0]),
                         np.float64)
        k = np.asarray(inner.get("k", {}).get("value", [0.0, 0.0, 0.0]),
                       np.float64)
        f0 = ((eta - 1.0) ** 2 + k ** 2) / ((eta + 1.0) ** 2 + k ** 2)
        a_u = float(inner.get("alpha_u", inner.get("alpha", 0.1)))
        a_v = float(inner.get("alpha_v", a_u))
        return {"type": "conductor", "reflectance": f0.tolist(),
                "roughness": float((a_u * a_v) ** 0.25)}
    refl = inner.get("reflectance", {})
    return {"type": "diffuse",
            "reflectance": refl.get("value", [0.5, 0.5, 0.5])
            if isinstance(refl, dict) else [0.5, 0.5, 0.5]}


def shapes_from_yaml(cfg: dict, mesh_path: str):
    """The YAML scene dict as native shape dicts (the reference consumes
    the same files through mitsuba's scene loader). Returns (shapes,
    max_depth, fov, disco): `disco` is the optional disco_ball block or
    None. A mesh item's empty filename means the dataset's mesh."""
    shapes = []
    disco = None
    for name, item in cfg.items():
        if not isinstance(item, dict):
            continue
        if name == "disco_ball":
            disco = dict(item)
            continue
        if "type" not in item:
            continue
        t = item["type"]
        if t in ("ply", "obj"):
            tris = load_mesh(item.get("filename") or mesh_path).triangles()
            if item.get("to_world"):
                tris = apply_to_world(tris, item["to_world"])
            sh = {"kind": "mesh", "tris": tris,
                  "bsdf": _bsdf_from_yaml(item.get("bsdf", {}))}
            if "emitter" in item:
                sh["emitter"] = {
                    "radiance": item["emitter"]["radiance"]["value"]}
            shapes.append(sh)
        elif t == "sphere":
            sh = {"kind": "sphere", "to_world": item.get("to_world", []),
                  "bsdf": _bsdf_from_yaml(item.get("bsdf",
                                                   {"type": "diffuse"}))}
            if "emitter" in item:
                sh["emitter"] = {
                    "radiance": item["emitter"]["radiance"]["value"]}
            shapes.append(sh)
    depth = cfg.get("Integrator", {}).get("max_depth", 7)
    fov = cfg.get("PerspectiveCamera", {}).get("fov", 45)
    return shapes, depth, fov, disco


def relight_seed(frame: int, rd: int) -> int:
    """The seed of round `rd` of frame `frame`."""
    return (frame << 32) | rd


def relight_generator(frame: int, rd: int, dev) -> torch.Generator:
    """The generator of round `rd` of frame `frame`."""
    return torch.Generator(device=dev).manual_seed(relight_seed(frame, rd))


def make_relight_round(scene, spp: int, max_depth: int, device,
                       graphs: GraphContext | None = None) -> GraphedUnit:
    """One relight round as a unit, round(rays, seed=) -> (B, 3):
    relight_path_tracing of `scene` over rays (B, 12) = [o, d, dxdu,
    dydv]. The scene is read in place: move the disco ball with
    set_disco_phase(..., out=scene). On the card a call is one CUDA graph
    replay after a warm-up round (utils.graphs.GraphedUnit; its output is
    overwritten by the next call); on the CPU it runs eagerly."""

    def round_(gen, rays):
        return relight_path_tracing(gen, scene, rays[..., :3],
                                    rays[..., 3:6], rays[..., 6:9],
                                    rays[..., 9:12], spp, max_depth)

    return GraphedUnit(round_, device, graphs, "relight_round")


def relight_frames(scene0, base_spots, rays_list, n_rounds: int, spp: int,
                   max_depth: int, device, disco_T: float | None = None,
                   graphs: GraphContext | None = None):
    """Yield each frame's radiance (B, 3) as numpy, the mean of n_rounds
    rounds (make_relight_round), round rd of frame i seeded
    relight_seed(i, rd). With disco_T, frame i first turns the disco ball
    of scene0 to 2 pi i / disco_T (set_disco_phase, in place on one
    scene, so that every frame replays the same graph)."""
    scene = scene0
    if disco_T is not None:
        scene = set_disco_phase(scene0, base_spots, 0.0)
    relight_round = make_relight_round(scene, spp, max_depth, device, graphs)
    for i, rays in enumerate(rays_list):
        if disco_T is not None:
            set_disco_phase(scene0, base_spots, 2 * np.pi * i / disco_T,
                            out=scene)
        r = torch.from_numpy(np.ascontiguousarray(rays, np.float32)).to(
            device)
        l = torch.zeros((r.shape[0], 3), device=device)
        for rd in range(n_rounds):
            l += relight_round(r, seed=relight_seed(i, rd))
        yield (l / n_rounds).cpu().numpy()


def main(argv=None):
    parser = add_model_specific_args(ArgumentParser())
    parser.add_argument("--experiment_name", type=str, required=True)
    parser.add_argument("--checkpoint_path", type=str,
                        default="./checkpoints")
    parser.add_argument("--output_path", type=str, required=True)
    parser.add_argument("--ckpt", type=str, default="last.pkl")
    parser.add_argument("--light_cfg", type=str, required=True)
    parser.add_argument("--mode", type=str, default="traj",
                        choices=["traj", "train_val"])
    parser.add_argument("--anti_aliasing", type=int, default=1)
    parser.add_argument("--disco", type=int, default=0)
    parser.add_argument("--disco_position", type=float, nargs=3,
                        default=[1.0, 1.0, 0.7])
    parser.add_argument("--disco_radius", type=float, default=0.15)
    parser.add_argument("--disco_T", type=float, default=120.0)
    parser.add_argument("--n_frames", type=int, default=30)
    parser.add_argument("--fps", type=int, default=30)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    import yaml

    ds_name, ds_root = args.dataset
    scene_id = args.scene if ds_name == "scannetpp" else ""
    mesh_path = resolve_mesh_path(ds_name, ds_root, scene_id)

    with open(args.light_cfg) as f:
        cfg = yaml.safe_load(f)
    shapes, max_depth, _, disco_cfg = shapes_from_yaml(cfg, mesh_path)
    if disco_cfg is not None:
        # a YAML disco_ball block switches the animated ball on and
        # overrides the CLI's values
        args.disco = 1
        args.disco_position = disco_cfg.get("position",
                                            args.disco_position)
        args.disco_radius = float(disco_cfg.get("radius",
                                                args.disco_radius))
        args.disco_T = float(disco_cfg.get("T", args.disco_T))

    ckpt = load_pytree(os.path.join(args.checkpoint_path,
                                    args.experiment_name, args.ckpt), dev)
    ngp = ckpt["material"]
    crf = init_emor_crf(dim=args.crf_basis, device=dev)
    if "crf_weight" in ckpt:
        crf = dc_replace(crf, weight=ckpt["crf_weight"])

    ez = np.load(os.path.join(args.emitter_path, "emitter.npz"))
    is_em, em_rad = ez["is_emitter"], ez["emitter_radiance"]

    # anti-alias by supersampling: render at aa x the resolution, then
    # average aa x aa blocks (reference render_relight.py:218-222,
    # :295-296)
    aa = max(args.anti_aliasing, 1)
    args.res_scale = args.res_scale * aa
    dataset = make_dataset(args, "train")
    h, w = dataset.img_hw

    if args.mode == "traj":
        rays_list = trajectory_rays(dataset, max(
            args.n_frames // max(len(dataset) - 1, 1), 1))[: args.n_frames]
    else:
        rays_list = [dataset.frame(i)["rays"] for i in range(len(dataset))]

    os.makedirs(args.output_path, exist_ok=True)

    # every BVH built once: the disco ball (if any) is a sub-scene of its
    # own, moved per frame by set_disco_phase (reference
    # render_relight.py:265-296 rebuilds the mitsuba scene per frame)
    base_spots = None
    if args.disco:
        dk = disco_cfg or {}
        disco_shapes, base_spots = make_disco_ball(
            args.disco_position, args.disco_radius,
            light_intensity=float(dk.get("light_intensity", 20.0)),
            light_num=int(dk.get("light_num", 20)),
            light_radius_rate=float(dk.get("light_radius_rate", 0.1)),
            spot_intensity=float(dk.get("spot_intensity", 10.0)),
            spot_cutoff_angle=float(dk.get("spot_cutoff_angle", 20.0)),
            phase=0.0, device=dev)
        scene0 = build_relight_scene(
            shapes, ngp=ngp, main_is_emitter=is_em,
            main_emitter_radiance=em_rad, dynamic_shapes=disco_shapes,
            dynamic_center=args.disco_position, device=dev)
    else:
        scene0 = build_relight_scene(shapes, ngp=ngp, main_is_emitter=is_em,
                                     main_emitter_radiance=em_rad,
                                     device=dev)

    n_rounds = max(args.SPP // args.spp, 1)
    frames = []
    for i, l in enumerate(relight_frames(
            scene0, base_spots, rays_list, n_rounds, args.spp, max_depth,
            dev, args.disco_T if args.disco else None)):
        img = denoise_hdr(l.reshape(h, w, 3), device=dev)
        with torch.no_grad():
            ldr = crf_forward(crf, torch.from_numpy(img.reshape(-1, 3))
                              .to(dev), 1.0)
        ldr = ldr.cpu().numpy().reshape(h, w, 3)
        if aa > 1:
            hh, ww = (h // aa) * aa, (w // aa) * aa
            ldr = ldr[:hh, :ww].reshape(hh // aa, aa, ww // aa, aa, 3) \
                .mean((1, 3))
        save_image(ldr, os.path.join(args.output_path, f"{i:05d}.png"))
        frames.append(ldr)
        print(f"[render_relight] frame {i + 1}/{len(rays_list)}")

    out = write_video(os.path.join(args.output_path, "relight.mp4"), frames,
                      args.fps)
    print("[render_relight] wrote", out)


if __name__ == "__main__":
    main()
