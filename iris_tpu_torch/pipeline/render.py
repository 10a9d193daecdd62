"""Render stills + intrinsic AOVs + PSNR/SSIM metrics (counterpart of
iris_tpu/pipeline/render.py; reference render.py): per frame, SPP-chunked
path_tracing and an AOV pass (kd, a' = g0*ks + g1 + kd reflectance,
roughness, metallic, emission, slf), denoise, CRF to LDR, PSNR/SSIM
against the frame's LDR, metrics.txt. Every EXR and PNG keeps the JAX
package's name. Runs on the card unless --device says otherwise.

Usage: python -m iris_tpu_torch.pipeline.render --dataset synthetic <root>
           --ldr_img_dir ldr --emitter_path <bake dir> --experiment_name x
           --output_path outputs/x/render [--split val] [--max_frames N]
"""

from __future__ import annotations

import functools
import os
from argparse import ArgumentParser
from dataclasses import replace as dc_replace
from pathlib import Path

import numpy as np
import torch

from iris_tpu_torch.core.vecmath import normalize
from iris_tpu_torch.device import resolve_device
from iris_tpu_torch.geometry.intersect import ray_intersect
from iris_tpu_torch.models import brdf as B
from iris_tpu_torch.models.brdf import ngp_brdf_apply
from iris_tpu_torch.models.crf import crf_forward, init_emor_crf
from iris_tpu_torch.models.emitter import eval_emitter, slf_forward
from iris_tpu_torch.pipeline.common import (
    load_emitter, load_scene, load_vslf, make_dataset,
)
from iris_tpu_torch.pipeline.config import add_model_specific_args
from iris_tpu_torch.render.denoise import denoise_hdr
from iris_tpu_torch.render.integrator import draw_uniform, path_tracing
from iris_tpu_torch.train.checkpoint import load_pytree
from iris_tpu_torch.utils.exr import write_exr
from iris_tpu_torch.utils.image import save_image
from iris_tpu_torch.utils.metrics import psnr, ssim

AOV_DIRS = ("rgb", "diffuse", "a_prime", "roughness", "metallic", "emission",
            "slf", "merge")


def make_render_fns(tracer, em, mat_fn, spp, indir_depth):
    """(render_chunk, aov_chunk) over rays (B, 12) = [o, d, dxdu, dydv].

    Both take a torch.Generator for their draws, or `samples` in its
    place: render_chunk's are path_tracing's; aov_chunk's are 'dudv'
    (2, B, spp, 1) in [0, 1) — the AOV jitter is not centred, as in the
    JAX package (render.py:49) — and 's2' (B*spp, 2)."""

    @torch.no_grad()
    def render_chunk(rays, gen=None, samples=None):
        o, d = rays[..., :3], normalize(rays[..., 3:6])
        dxdu, dydv = rays[..., 6:9], rays[..., 9:12]
        return path_tracing(gen, tracer, em, mat_fn, o, d, dxdu, dydv, spp,
                            indir_depth, samples=samples)

    @torch.no_grad()
    def aov_chunk(rays, gen=None, samples=None):
        o, d = rays[..., :3], normalize(rays[..., 3:6])
        dxdu, dydv = rays[..., 6:9], rays[..., 9:12]
        b = o.shape[0]
        if samples is None:
            dudv = draw_uniform(gen, (2, b, spp, 1), o.device)
        else:
            dudv = samples["dudv"]
        du, dv = dudv[0], dudv[1]
        ds = normalize(d[:, None] + dxdu[:, None] * du
                       + dydv[:, None] * dv).reshape(-1, 3)
        xs = torch.repeat_interleave(o, spp, dim=0)
        pos, nrm, _, tri, valid = ray_intersect(tracer, xs, ds)
        mat = mat_fn(pos)
        kd = mat["albedo"] * (1 - mat["metallic"])
        ks = 0.04 * (1 - mat["metallic"]) + mat["albedo"] * mat["metallic"]
        if samples is None:
            s2 = draw_uniform(gen, (pos.shape[0], 2), o.device)
        else:
            s2 = samples["s2"]
        _, _, g0, g1 = B.sample_specular(s2, -ds, nrm, mat["roughness"])
        a_prime = g0 * ks + g1 + kd
        emission = eval_emitter(em, pos, ds, tri)[0]
        slf_v = slf_forward(em, pos)
        non_emit = torch.sum(emission, -1) == 0
        ok = (valid & non_emit)[:, None]
        kd = torch.where(ok, kd, 1.0)
        a_prime = torch.where(ok, a_prime, 1.0)
        rough = torch.where(ok, mat["roughness"], 1.0)
        metal = torch.where(ok, mat["metallic"], 0.0)

        def avg(x):
            return x.reshape(b, spp, -1).mean(1)

        return (avg(kd), avg(a_prime), avg(rough), avg(metal),
                avg(emission), avg(slf_v))

    return render_chunk, aov_chunk


def render_frame(render_chunk, aov_chunk, rays, n_rounds, gen):
    """Average n_rounds of render_chunk + aov_chunk over the frame's rays
    (a (B, 12) tensor on the render device). Returns numpy (l (B, 3),
    [kd, a_prime, roughness, metallic, emission, slf])."""
    l_full = None
    aovs = None
    for _ in range(n_rounds):
        l = render_chunk(rays, gen)
        a = aov_chunk(rays, gen)
        l_full = l if l_full is None else l_full + l
        aovs = list(a) if aovs is None else [p + q for p, q in zip(aovs, a)]
    l_full = (l_full / n_rounds).cpu().numpy()
    aovs = [(x / n_rounds).cpu().numpy() for x in aovs]
    return l_full, aovs


def main(argv=None):
    parser = add_model_specific_args(ArgumentParser())
    parser.add_argument("--experiment_name", type=str, required=True)
    parser.add_argument("--checkpoint_path", type=str,
                        default="./checkpoints")
    parser.add_argument("--output_path", type=str, required=True)
    parser.add_argument("--split", type=str, default="val")
    parser.add_argument("--ckpt", type=str, default="last.pkl")
    parser.add_argument("--light_type", type=str, default="slf",
                        choices=["slf", "area"])
    parser.add_argument("--max_frames", type=int, default=0,
                        help="render only the first N frames (0 = all)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    ds_name, ds_root = args.dataset
    scene_id = args.scene if ds_name == "scannetpp" else ""
    mesh, tracer = load_scene(ds_name, ds_root, scene_id, device=dev)

    # the refined SLF (slf_refine) where there is one
    emitter_dir = args.emitter_path
    slf_file = os.path.join(emitter_dir, "vslf_0.npz")
    if not os.path.exists(slf_file):
        slf_file = os.path.join(emitter_dir, "vslf.npz")
    slf, _ = load_vslf(slf_file, device=dev)
    em = load_emitter(os.path.join(emitter_dir, "emitter.npz"), mesh,
                      slf=slf, device=dev)

    ckpt = load_pytree(
        os.path.join(args.checkpoint_path, args.experiment_name, args.ckpt),
        dev)
    material = ckpt["material"]
    crf = init_emor_crf(dim=args.crf_basis, device=dev)
    if "crf_weight" in ckpt:
        crf = dc_replace(crf, weight=ckpt["crf_weight"])
    if "radiance" in ckpt:
        em = dc_replace(em, radiance=ckpt["radiance"])
    mat_fn = functools.partial(ngp_brdf_apply, material)

    dataset = make_dataset(args, args.split)
    h, w = dataset.img_hw

    dirs = {}
    for name in AOV_DIRS:
        d = Path(args.output_path) / args.split / name
        d.mkdir(exist_ok=True, parents=True)
        dirs[name] = d

    render_chunk, aov_chunk = make_render_fns(tracer, em, mat_fn, args.spp,
                                              args.indir_depth)
    n_rounds = max(args.SPP // args.spp, 1)

    n_frames = len(dataset)
    if args.max_frames:
        n_frames = min(n_frames, args.max_frames)
    psnrs, ssims = [], []
    for i in range(n_frames):
        fr = dataset.frame(i)
        rays = torch.from_numpy(np.ascontiguousarray(fr["rays"])).to(dev)
        gen = torch.Generator(device=dev).manual_seed(i)
        l_full, aovs = render_frame(render_chunk, aov_chunk, rays, n_rounds,
                                    gen)
        kd, a_prime, rough, metal, emission, slf_v = aovs

        img = denoise_hdr(l_full.reshape(h, w, 3),
                          albedo=kd.reshape(h, w, 3), device=dev)
        write_exr(str(dirs["rgb"] / f"{i:05d}_rgb_full.exr"), img)
        exposure = fr.get("exposure")
        exposure = 1.0 if exposure is None else float(exposure)
        with torch.no_grad():
            ldr = crf_forward(crf, torch.from_numpy(img.reshape(-1, 3))
                              .to(dev), exposure)
        ldr = ldr.cpu().numpy().reshape(h, w, 3)
        save_image(ldr, str(dirs["rgb"] / f"{i:05d}_rgb_full.png"))

        gt = np.asarray(fr["rgbs"]).reshape(h, w, 3)
        psnrs.append(psnr(gt, ldr))
        ssims.append(ssim(gt, ldr))

        for name, arr in [("diffuse", kd), ("a_prime", a_prime)]:
            arr = arr.reshape(h, w, 3)
            write_exr(str(dirs[name] / f"{i:05d}_{name}.exr"), arr)
            save_image(arr, str(dirs[name] / f"{i:05d}_{name}.png"))
        for name, arr in [("roughness", rough), ("metallic", metal)]:
            arr = arr.reshape(h, w)
            write_exr(str(dirs[name] / f"{i:05d}_{name}.exr"), arr)
            save_image(arr, str(dirs[name] / f"{i:05d}_{name}_color.png"),
                       colormap=True)
        emission_img = emission.reshape(h, w, 3)
        write_exr(str(dirs["emission"] / f"{i:05d}_emission.exr"),
                  emission_img)
        save_image(emission_img, str(dirs["emission"] / f"{i:05d}.png"))
        write_exr(str(dirs["slf"] / f"{i:05d}_slf.exr"),
                  slf_v.reshape(h, w, 3))
        rough3 = np.repeat(rough.reshape(h, w, 1), 3, -1)
        metal3 = np.repeat(metal.reshape(h, w, 1), 3, -1)
        merge = np.concatenate(
            [gt, ldr, kd.reshape(h, w, 3), a_prime.reshape(h, w, 3),
             rough3, metal3, emission_img], axis=1)
        save_image(merge, str(dirs["merge"] / f"{i:05d}_merge.png"))
        print(f"frame {i}: psnr={psnrs[-1]:.3f} ssim={ssims[-1]:.4f}")

    print(f"Mean PSNR: {np.mean(psnrs):.5f}")
    print(f"Mean SSIM: {np.mean(ssims):.5f}")
    with open(dirs["rgb"] / "metrics.txt", "w") as f:
        f.write("Name, PSNR, SSIM\n")
        for i, (p, s) in enumerate(zip(psnrs, ssims)):
            f.write(f"{i:05d}, {p:.5f}, {s:.5f}\n")
        f.write(f"mean , {np.mean(psnrs):.5f}, {np.mean(ssims):.5f}\n")


if __name__ == "__main__":
    main()
