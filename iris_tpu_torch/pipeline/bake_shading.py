"""Stage 5: bake diffuse + specular shading caches per view (counterpart
of iris_tpu/pipeline/bake_shading.py; reference bake_shading.py).

Per view, from deterministic first hits:
  diffuse:  cosine-sample spp=256, one bounce into the SLF cache
            (trace_roughness=0.0 -> always use cache, :113-123)
  specular: 6 roughness levels linspace(0.02, 1.0), GGX sampling, the two
            Fresnel-split maps, spp=[64,128x5] (:143-188)
Each map is denoised (edge-aware à-trous in place of OptixDenoiser) and
written as {im}.exr / {im}_{0,1}_{r}.exr for the train_brdf_crf stage.

The reference's ray-chunk budget (batch = 10240*64//spp pixels, :105,
capped at the frame's pixel count rounded up to 256) cuts the chunks at
the JAX package's boundaries; the port does not pad the last chunk.
"""

from __future__ import annotations

import os
import time
from argparse import ArgumentParser
from typing import Callable

import numpy as np
import torch

from iris_tpu_torch.const import RAY_EPS
from iris_tpu_torch.core.vecmath import normalize
from iris_tpu_torch.device import resolve_device
from iris_tpu_torch.geometry.intersect import ray_intersect
from iris_tpu_torch.models import brdf as B
from iris_tpu_torch.models.emitter import eval_emitter
from iris_tpu_torch.pipeline.common import (
    load_emitter, load_scene, load_vslf, stage_dataset,
)
from iris_tpu_torch.render.denoise import denoise_hdr
from iris_tpu_torch.render.integrator import draw_uniform
from iris_tpu_torch.utils.exr import write_exr

ROUGHNESS_LEVELS = np.linspace(0.02, 1.0, 6)
SPP_SPECULAR = [64, 128, 128, 128, 128, 128]
CHUNK_RAYS = 10240 * 64
DIFFUSE = -1   # the level index of the diffuse map in a draws or samples hook

# draws(level, chunk) -> (batch * spp, 2) uniforms of the chunk's padded
# batch, rows i*spp + j, as the JAX package draws them
# (uniform(fold_in(key, chunk), (batch*spp, 2))); level is DIFFUSE or the
# roughness level's index
Draws = Callable[[int, int], torch.Tensor]


def chunk_batch(n: int, spp: int, chunk_rays: int = CHUNK_RAYS) -> int:
    """Pixels a chunk (bake_shading.py:83 of the JAX package)."""
    return min(max(chunk_rays // spp, 1), -(-n // 256) * 256)


def chunk_plan(n: int, spp_diffuse: int = 256, spp_scale: int = 1,
               chunk_rays: int = CHUNK_RAYS) -> list[tuple[int, int, int]]:
    """(spp, pixels a chunk, chunks) of the diffuse map, then of each
    roughness level, for a frame of n pixels."""
    plan = []
    for spp in [spp_diffuse] + [s * spp_scale for s in SPP_SPECULAR]:
        batch = chunk_batch(n, spp, chunk_rays)
        plan.append((spp, batch, -(-n // batch)))
    return plan


@torch.no_grad()
def _bake_maps_for_frame(tracer, em, rays, img_hw, spp_diffuse=256,
                         chunk_rays=CHUNK_RAYS, trace_roughness=0.0,
                         gen=None, denoise=True, spp_scale=1,
                         draws: Draws | None = None):
    """rays: the frame's (H*W, 12) tensor on the tracer's device. Returns
    dict: diffuse (H,W,3), specular0/specular1 lists of (H,W,3), numpy.

    The draws come from `gen`, or from `draws` when it is given (a test
    hook that replays the JAX package's keys)."""
    dev = rays.device
    xs, ds = rays[:, :3], rays[:, 3:6]
    pos, nrm, _, _, valid = ray_intersect(tracer, xs, ds)
    # the unit view direction: the JAX package passes the dataset's
    # unnormalized d (bake_shading.py:45, :96), whose |d| > 1 off the
    # image centre pushes v.h past 1 and the Schlick term (1 - v.h)^5
    # below 0, so its second Fresnel map goes negative there
    wo_all = -normalize(ds)
    n = pos.shape[0]

    def secondary(p, wi, spp):
        """The SLF value where wi, from p repeated spp times, hits."""
        p_r = torch.repeat_interleave(p, spp, 0)
        p_next, _, _, tri, _ = ray_intersect(tracer, p_r + RAY_EPS * wi, wi)
        rough1 = torch.ones((wi.shape[0], 1), device=dev)
        le, _, _ = eval_emitter(em, p_next, wi, tri, rough1,
                                trace_roughness)
        return le

    def diffuse_chunk(p, nr, wo, s2, spp):
        wi, _, _ = B.sample_diffuse(s2, torch.repeat_interleave(nr, spp, 0))
        le = secondary(p, wi, spp)
        return (le.reshape(p.shape[0], spp, 3).mean(1),)

    def specular_chunk(rough):
        def fn(p, nr, wo, s2, spp):
            wi, _, g0, g1 = B.sample_specular(
                s2, torch.repeat_interleave(wo, spp, 0),
                torch.repeat_interleave(nr, spp, 0), rough)
            le = secondary(p, wi, spp)
            b = p.shape[0]
            return ((le * g0).reshape(b, spp, 3).mean(1),
                    (le * g1).reshape(b, spp, 3).mean(1))
        return fn

    def run_chunked(fn, spp, level):
        batch = chunk_batch(n, spp, chunk_rays)
        outs = []
        for c, b0 in enumerate(range(0, n, batch)):
            b1 = min(b0 + batch, n)
            rows = (b1 - b0) * spp
            if draws is None:
                s2 = draw_uniform(gen, (rows, 2), dev)
            else:
                s2 = draws(level, c)[:rows].to(dev)
            outs.append(fn(pos[b0:b1], nrm[b0:b1], wo_all[b0:b1], s2, spp))
        return [torch.cat([o[i] for o in outs], 0)
                for i in range(len(outs[0]))]

    h, w = img_hw
    vm = valid[:, None]

    def to_map(x):
        return torch.where(vm, x, 0.0).reshape(h, w, 3).cpu().numpy()

    nrm_guide = to_map(nrm)
    mask_hw = valid.reshape(h, w).cpu().numpy()

    def maybe_denoise(x, on):
        return (denoise_hdr(x, normal=nrm_guide, mask=mask_hw, device=dev)
                if on else x)

    (ld,) = run_chunked(diffuse_chunk, spp_diffuse, DIFFUSE)
    result = {"diffuse": maybe_denoise(to_map(ld), denoise)}
    spec0, spec1 = [], []
    for r_idx, rough in enumerate(ROUGHNESS_LEVELS):
        spp = SPP_SPECULAR[r_idx] * spp_scale
        l0, l1 = run_chunked(specular_chunk(float(rough)), spp,
                             r_idx)
        # low roughness: no denoise (ref :198)
        spec0.append(maybe_denoise(to_map(l0), denoise and r_idx > 0))
        spec1.append(maybe_denoise(to_map(l1), denoise and r_idx > 0))
    result["specular0"] = spec0
    result["specular1"] = spec1
    return result


def write_maps(output: str, im_id: int, maps: dict) -> None:
    dif_dir = os.path.join(output, "diffuse")
    spec_dir = os.path.join(output, "specular")
    os.makedirs(dif_dir, exist_ok=True)
    os.makedirs(spec_dir, exist_ok=True)
    write_exr(os.path.join(dif_dir, f"{im_id:03d}.exr"), maps["diffuse"])
    for r_idx in range(len(ROUGHNESS_LEVELS)):
        write_exr(os.path.join(spec_dir, f"{im_id:03d}_0_{r_idx}.exr"),
                  maps["specular0"][r_idx])
        write_exr(os.path.join(spec_dir, f"{im_id:03d}_1_{r_idx}.exr"),
                  maps["specular1"][r_idx])


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--dataset_root", type=str, default=None)
    parser.add_argument("--scene", type=str, required=True)
    parser.add_argument("--slf_path", type=str, required=True)
    parser.add_argument("--emitter_path", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--ldr_img_dir", type=str, default=None)
    parser.add_argument("--res_scale", type=float, default=1.0)
    parser.add_argument("--spp_diffuse", type=int, default=256)
    parser.add_argument("--max_frames", type=int, default=0,
                        help="bake only the first N frames (0 = all)")
    parser.add_argument("--denoise", type=int, default=1,
                        help="0 skips the à-trous pass (the JAX package's "
                        "IRIS_TPU_NO_DENOISE)")
    parser.add_argument("--spp_specular_scale", type=int, default=1,
                        help="multiply the specular spp ladder")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    scene_args, dataset = stage_dataset(args)
    mesh, tracer = load_scene(*scene_args, device=dev)
    slf, _ = load_vslf(args.slf_path, device=dev)
    em = load_emitter(args.emitter_path, mesh, slf=slf, device=dev)

    t0 = time.time()
    for im_id, fr in enumerate(dataset.frames()):
        if args.max_frames and im_id >= args.max_frames:
            break
        rays = torch.from_numpy(np.ascontiguousarray(fr["rays"])).to(dev)
        maps = _bake_maps_for_frame(
            tracer, em, rays, dataset.img_hw,
            spp_diffuse=args.spp_diffuse,
            gen=torch.Generator(device=dev).manual_seed(im_id),
            denoise=bool(args.denoise),
            spp_scale=args.spp_specular_scale)
        write_maps(args.output, im_id, maps)
    print(f"[bake_shading] time (s): {time.time() - t0:.1f}")


if __name__ == "__main__":
    main()
