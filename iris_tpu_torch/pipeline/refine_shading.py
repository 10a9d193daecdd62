"""Stage 9-prep: re-bake the shading caches with the learned BRDF and full
indirect light (counterpart of iris_tpu/pipeline/refine_shading.py;
reference refine_shading.py).

Unlike bake_shading (SLF only, one bounce), this runs the deterministic
integrators path_tracing_det_diff / path_tracing_det_spec with the trained
NGP material at indir_depth 5. Chunks follow the reference budget
(10240*128 // spp pixels, capped at the frame's pixel count rounded up to
256) and are cut at the JAX package's boundaries, without padding.

--encode stoch evaluates the hash grid with its one-corner estimator. The
JAX package gives every material call of a chunk the same key, so every
bounce draws the same uniforms for the same shape; here every call gets a
generator seeded to the chunk's encode seed, which does the same.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from argparse import ArgumentParser
from typing import Callable

import numpy as np
import torch

from iris_tpu_torch.core.vecmath import normalize
from iris_tpu_torch.device import resolve_device
from iris_tpu_torch.geometry.intersect import ray_intersect
from iris_tpu_torch.models.brdf import ngp_brdf_apply
from iris_tpu_torch.pipeline.bake_shading import (
    DIFFUSE, ROUGHNESS_LEVELS, write_maps,
)
from iris_tpu_torch.pipeline.common import (
    load_emitter, load_scene, load_vslf, stage_dataset,
)
from iris_tpu_torch.render.denoise import denoise_hdr
from iris_tpu_torch.render.integrator import (
    path_tracing_det_diff, path_tracing_det_spec,
)
from iris_tpu_torch.train.checkpoint import load_pytree

CHUNK_PATHS = 10240 * 128

# samples(level, chunk) -> the det integrator's samples dict for the
# chunk's padded batch, as the JAX package draws it ('det_s2' (batch*spp,
# 2), 'indirect' {k: (D, 2*...)}); rows past the chunk's pixels are cut
Samples = Callable[[int, int], dict]


def chunk_pixels(n_px: int, spp: int, chunk_paths: int = CHUNK_PATHS
                 ) -> int:
    """Pixels a chunk (refine_shading.py:121-126 of the JAX package)."""
    return min(max(chunk_paths // spp, 1), -(-n_px // 256) * 256)


def make_mat_fn_factory(material, encode: str):
    """encode_seed -> mat_fn. "exact": the 8-corner encode (no draws);
    "stoch": the 1-corner estimator, every call drawing from a generator
    seeded to the chunk's encode seed."""
    if encode == "exact":
        mat_fn = functools.partial(ngp_brdf_apply, material)
        return lambda seed: mat_fn
    if encode != "stoch":
        raise ValueError(f"unknown encode {encode!r}")
    material = dataclasses.replace(material, cfg=dataclasses.replace(
        material.cfg, stochastic_fwd=True, stochastic_bwd=True,
        fwd_level_sample=0, bwd_level_sample=0))
    dev = material.voxel_min.device

    def make(seed):
        return lambda pos: ngp_brdf_apply(
            material, pos, torch.Generator(device=dev).manual_seed(seed))
    return make


def chunk_seeds(im_id: int, seed: int, level: int, chunk: int):
    """(path draws, encode draws) seeds of one chunk."""
    words = np.random.SeedSequence(
        [im_id, seed, level + 1, chunk]).generate_state(2, np.uint64)
    return int(words[0] >> np.uint64(1)), int(words[1] >> np.uint64(1))


def _slice_samples(smp, rows: int):
    """A samples dict cut to its first `rows` paths (axis 0, or axis 1 of
    the indirect tail's per-depth stacks)."""
    out = {"det_s2": smp["det_s2"][:rows]}
    out["indirect"] = {k: v[:, :rows] for k, v in smp["indirect"].items()}
    return out


@torch.no_grad()
def refine_frame(tracer, em, make_mat_fn, rays, img_hw, spp_d: int = 128,
                 spp_s: int = 64, depth: int = 5, im_id: int = 0,
                 seed: int = 0, denoise: bool = True,
                 samples: Samples | None = None,
                 chunk_paths: int = CHUNK_PATHS) -> dict:
    """One frame's maps (numpy, like bake_shading's): diffuse (H,W,3) and
    specular0/specular1 lists of (H,W,3), one per roughness level.

    rays: the frame's (H*W, 12) tensor on the tracer's device. Draws come
    from per-chunk generators (chunk_seeds), or from `samples` when it is
    given (a test hook that replays the JAX package's keys)."""
    dev = rays.device
    pos, nrm, uv, tri, valid = ray_intersect(tracer, rays[:, :3],
                                             rays[:, 3:6])
    # the unit view direction, as bake_shading takes it (the JAX package
    # passes the dataset's unnormalized d, refine_shading.py:149)
    wi = normalize(rays[:, 3:6])
    n = pos.shape[0]
    h, w = img_hw
    nrm_hw = nrm.reshape(h, w, 3).cpu().numpy()
    mask_hw = valid.reshape(h, w).cpu().numpy()

    def chunked(run, spp, level):
        chunk = chunk_pixels(n, spp, chunk_paths)
        outs = []
        for c, b0 in enumerate(range(0, n, chunk)):
            b1 = min(b0 + chunk, n)
            s_path, s_enc = chunk_seeds(im_id, seed, level, c)
            smp = (None if samples is None
                   else _slice_samples(samples(level, c), (b1 - b0) * spp))
            res = run(torch.Generator(device=dev).manual_seed(s_path),
                      make_mat_fn(s_enc), pos[b0:b1], wi[b0:b1],
                      nrm[b0:b1], uv[b0:b1], tri[b0:b1], smp)
            outs.append(res if isinstance(res, tuple) else (res,))
        maps = []
        for i in range(len(outs[0])):
            m = torch.cat([o[i] for o in outs], 0).cpu().numpy()
            if np.isnan(m).any():
                raise FloatingPointError(f"refine_shading: NaN in frame "
                                         f"{im_id}, level {level}")
            m = m.reshape(h, w, 3)
            maps.append(denoise_hdr(m, normal=nrm_hw, mask=mask_hw,
                                    device=dev) if denoise else m)
        return maps

    def diff(gen, mat_fn, p, wi_, nr, uv_, tri_, smp):
        return path_tracing_det_diff(gen, tracer, em, mat_fn, p, wi_, nr,
                                     uv_, tri_, spp_d, depth, samples=smp)

    (ld,) = chunked(diff, spp_d, DIFFUSE)
    out = {"diffuse": ld, "specular0": [], "specular1": []}
    for r_idx, rough in enumerate(ROUGHNESS_LEVELS):
        def spec(gen, mat_fn, p, wi_, nr, uv_, tri_, smp,
                 rv=float(np.float32(rough))):
            return path_tracing_det_spec(gen, tracer, em, mat_fn, rv, p, wi_,
                                         nr, uv_, tri_, spp_s, depth,
                                         samples=smp)

        l0, l1 = chunked(spec, spp_s, r_idx)
        out["specular0"].append(l0)
        out["specular1"].append(l1)
    return out


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--dataset_root", type=str, default=None)
    parser.add_argument("--scene", type=str, required=True)
    parser.add_argument("--slf_path", type=str, required=True)
    parser.add_argument("--emitter_path", type=str, required=True)
    parser.add_argument("--ckpt", type=str, required=True,
                        help="a checkpoint of the port (train/checkpoint.py) "
                        "holding {'material': NGPBRDF}")
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--ldr_img_dir", type=str, default=None)
    parser.add_argument("--res_scale", type=float, default=1.0)
    parser.add_argument("--spp_diffuse", type=int, default=128)
    parser.add_argument("--spp_specular", type=int, default=64)
    parser.add_argument("--indir_depth", type=int, default=5)
    parser.add_argument(
        "--encode", type=str, default="exact", choices=("exact", "stoch"),
        help="hash-grid encode at the bake's vertices: exact 8-corner "
             "(reference semantics) or the 1-corner stochastic estimator "
             "(unbiased per query)")
    parser.add_argument("--max_frames", type=int, default=0,
                        help="bake only the first N frames (0 = all)")
    parser.add_argument("--seed", type=int, default=0,
                        help="extra seed of the per-chunk generators")
    parser.add_argument("--denoise", type=int, default=1,
                        help="0 skips the à-trous pass (the JAX package's "
                        "IRIS_TPU_NO_DENOISE)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    scene_args, dataset = stage_dataset(args)
    mesh, tracer = load_scene(*scene_args, device=dev)
    slf, _ = load_vslf(args.slf_path, device=dev)
    em = load_emitter(args.emitter_path, mesh, slf=slf, device=dev)
    material = load_pytree(args.ckpt, device=dev)["material"]
    make_mat_fn = make_mat_fn_factory(material, args.encode)

    t0 = time.time()
    for im_id, fr in enumerate(dataset.frames()):
        if args.max_frames and im_id >= args.max_frames:
            break
        rays = torch.from_numpy(np.ascontiguousarray(fr["rays"])).to(dev)
        maps = refine_frame(tracer, em, make_mat_fn, rays, dataset.img_hw,
                            args.spp_diffuse, args.spp_specular,
                            args.indir_depth, im_id=im_id, seed=args.seed,
                            denoise=bool(args.denoise))
        write_maps(args.output, im_id, maps)
    print(f"[refine_shading] time (s): {time.time() - t0:.1f}")


if __name__ == "__main__":
    main()
