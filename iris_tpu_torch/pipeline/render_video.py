"""Render a video along an interpolated camera trajectory (counterpart of
iris_tpu/pipeline/render_video.py; reference render_video.py): a B-spline
path through the dataset's poses (or its render_traj.npy), full path
tracing per frame through pipeline/render.py's make_render_round (on the
card one CUDA graph replay a round, one capture for the trajectory) and
render_frame, denoise, CRF, a boomerang video and the AOV videos. Frame i
draws from a generator seeded i, as render.main does. Runs on the card
unless --device says otherwise.

Usage: python -m iris_tpu_torch.pipeline.render_video --dataset synthetic
           <root> --ldr_img_dir ldr --experiment_name x/brdf1
           --emitter_path <bake dir> --output_path outputs/video
           [--n_interp 6] [--traj render_traj.npy] [--aov_videos 1]
Writes video.mp4 and kd/a_prime/roughness/metallic/emission.mp4
(utils/video.write_video: frames directories where there is no ffmpeg
backend).
"""

from __future__ import annotations

import functools
import os
from argparse import ArgumentParser
from dataclasses import replace as dc_replace

import numpy as np
import torch

from iris_tpu_torch.data.rays import (
    concat_rays, get_direction_k, get_ray_directions_blender,
    get_rays_blender, to_world_k,
)
from iris_tpu_torch.device import resolve_device
from iris_tpu_torch.models.brdf import ngp_brdf_apply
from iris_tpu_torch.models.crf import crf_forward, init_emor_crf
from iris_tpu_torch.pipeline.common import (
    load_emitter, load_scene, load_vslf, make_dataset,
)
from iris_tpu_torch.pipeline.config import add_model_specific_args
from iris_tpu_torch.pipeline.render import (
    make_render_fns, make_render_round, render_frame,
)
from iris_tpu_torch.render.denoise import denoise_hdr
from iris_tpu_torch.train.checkpoint import load_pytree
from iris_tpu_torch.utils.gen_path import generate_interpolated_path
from iris_tpu_torch.utils.video import write_video

AOV_VIDEOS = ("kd", "a_prime", "roughness", "metallic", "emission")


def trajectory_rays(dataset, n_interp: int = 6, traj_file: str | None = None):
    """Rays (H*W, 12) per trajectory frame, numpy, with the dataset's
    intrinsics. A render_traj.npy of c2w poses at the dataset root (or an
    explicit traj_file) takes precedence over the interpolated path
    (reference real_ldr.py:205 / synthetic_ldr.py:187 /
    render_video.py:180)."""
    root = getattr(dataset, "root_dir", None)
    if root is None and hasattr(dataset, "split_dir"):
        root = os.path.dirname(dataset.split_dir.rstrip("/"))
    cand = traj_file or (os.path.join(root, "render_traj.npy")
                         if root else None)
    if cand and os.path.exists(cand):
        traj = np.asarray(np.load(cand), np.float32)[:, :3, :4]
        print(f"[render_video] using trajectory {cand} ({len(traj)} poses)")
    else:
        poses = np.stack([np.asarray(dataset.frame(i)["c2w"])
                          for i in range(len(dataset))])
        traj = generate_interpolated_path(poses, n_interp)
    h, w = dataset.img_hw
    out = []
    if hasattr(dataset, "k"):          # intrinsics-matrix datasets
        local = get_direction_k(dataset.k, dataset.img_hw)
        for c2w in traj:
            out.append(concat_rays(*to_world_k(local, c2w, dataset.k)))
    elif hasattr(dataset, "ks"):
        local = get_direction_k(dataset.ks[0], dataset.img_hw)
        for c2w in traj:
            out.append(concat_rays(*to_world_k(local, c2w, dataset.ks[0])))
    else:                               # blender-convention datasets
        dirs = get_ray_directions_blender(h, w, dataset.focal)
        for c2w in traj:
            out.append(concat_rays(*get_rays_blender(
                dirs, c2w.astype(np.float32), dataset.focal)))
    return out


def main(argv=None):
    parser = add_model_specific_args(ArgumentParser())
    parser.add_argument("--experiment_name", type=str, required=True)
    parser.add_argument("--checkpoint_path", type=str,
                        default="./checkpoints")
    parser.add_argument("--output_path", type=str, required=True)
    parser.add_argument("--ckpt", type=str, default="last.pkl")
    parser.add_argument("--n_interp", type=int, default=6)
    parser.add_argument("--fps", type=int, default=30)
    parser.add_argument("--traj", type=str, default=None,
                        help="explicit render_traj.npy of c2w poses")
    parser.add_argument("--aov_videos", type=int, default=1,
                        help="also write kd/a_prime/roughness/metallic/"
                             "emission videos (reference render_video.py)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    ds_name, ds_root = args.dataset
    scene_id = args.scene if ds_name == "scannetpp" else ""
    mesh, tracer = load_scene(ds_name, ds_root, scene_id, device=dev)
    slf_file = os.path.join(args.emitter_path, "vslf_0.npz")
    if not os.path.exists(slf_file):
        slf_file = os.path.join(args.emitter_path, "vslf.npz")
    slf, _ = load_vslf(slf_file, device=dev)
    em = load_emitter(os.path.join(args.emitter_path, "emitter.npz"), mesh,
                      slf=slf, device=dev)
    ckpt = load_pytree(os.path.join(args.checkpoint_path,
                                    args.experiment_name, args.ckpt), dev)
    crf = init_emor_crf(dim=args.crf_basis, device=dev)
    if "crf_weight" in ckpt:
        crf = dc_replace(crf, weight=ckpt["crf_weight"])
    if "radiance" in ckpt:
        em = dc_replace(em, radiance=ckpt["radiance"])
    mat_fn = functools.partial(ngp_brdf_apply, ckpt["material"])

    dataset = make_dataset(args, "train")
    h, w = dataset.img_hw
    rays_list = trajectory_rays(dataset, args.n_interp, args.traj)

    # one unit, so one capture, for the whole trajectory
    render_round = make_render_round(*make_render_fns(
        tracer, em, mat_fn, args.spp, args.indir_depth), dev)
    n_rounds = max(args.SPP // args.spp, 1)
    frames = []
    aov_frames = {k: [] for k in AOV_VIDEOS}
    for i, rays in enumerate(rays_list):
        r = torch.from_numpy(np.ascontiguousarray(rays, np.float32)).to(dev)
        l_full, aovs = render_frame(render_round, r, n_rounds, i)
        kd, a_prime, rough, metal, emission, _ = aovs
        img = denoise_hdr(l_full.reshape(h, w, 3),
                          albedo=kd.reshape(h, w, 3), device=dev)
        with torch.no_grad():
            ldr = crf_forward(crf, torch.from_numpy(img.reshape(-1, 3))
                              .to(dev), 1.0)
        frames.append(ldr.cpu().numpy().reshape(h, w, 3))
        if args.aov_videos:
            aov_frames["kd"].append(kd.reshape(h, w, 3))
            aov_frames["a_prime"].append(a_prime.reshape(h, w, 3))
            aov_frames["roughness"].append(np.repeat(
                rough.reshape(h, w, 1), 3, -1))
            aov_frames["metallic"].append(np.repeat(
                metal.reshape(h, w, 1), 3, -1))
            aov_frames["emission"].append(
                1.0 - np.exp(-emission.reshape(h, w, 3)))
        print(f"[render_video] frame {i + 1}/{len(rays_list)}")

    os.makedirs(args.output_path, exist_ok=True)
    # boomerang loop like the reference (render_video.py:278)
    out = write_video(os.path.join(args.output_path, "video.mp4"),
                      frames + frames[::-1], args.fps)
    print("[render_video] wrote", out)
    if args.aov_videos:
        for name, imgs in aov_frames.items():
            p = write_video(os.path.join(args.output_path, f"{name}.mp4"),
                            imgs + imgs[::-1], args.fps)
            print("[render_video] wrote", p)


if __name__ == "__main__":
    main()
