"""Stage 1: bake the voxel surface-light-field radiance cache
(counterpart of iris_tpu/pipeline/slf_bake.py; reference slf_bake.py).

Three dataset passes, each frame's rays traced on the device:
  1. scene AABB from first-hit positions (scalar min/max, 1.1x inflation);
     two scalars come to the host per frame;
  2. voxel visibility: the occupied voxels of a voxel_num^3 grid;
  3. CRF-inverted LDR radiance, summed per voxel and mean-pooled. The sums
     are deterministic segment sums (models/slf.py): two runs give the same
     bits, where CUDA atomics would not.
Writes vslf.npz in the JAX package's layout.

Usage: python -m iris_tpu_torch.pipeline.slf_bake --dataset synthetic \
           --scene <root> --output outputs/x [--voxel_num 256] [--device cpu]
"""

from __future__ import annotations

import os
import time
from argparse import ArgumentParser

import numpy as np
import torch

from iris_tpu_torch.device import resolve_device
from iris_tpu_torch.geometry.intersect import ray_intersect
from iris_tpu_torch.models.crf import crf_inverse, init_emor_crf
from iris_tpu_torch.models.slf import (
    init_voxel_slf, slf_finalize_mean, slf_scatter_add,
)
from iris_tpu_torch.pipeline.common import (
    load_scene, save_vslf, stage_dataset,
)


def _first_hits(tracer, rays: torch.Tensor):
    pos, _, _, _, valid = ray_intersect(tracer, rays[:, :3], rays[:, 3:6])
    return pos, valid


def _device_rays(fr, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(fr["rays"])).to(dev)


@torch.no_grad()
def bake_slf(tracer, dataset, crf, voxel_num: int = 256,
             dataset_kind: str = "synthetic", log=print):
    """Run the three passes on the tracer's device; returns (vslf, mask)."""
    dev = tracer.nodes.device
    big = 3e38

    # pass 1: scene bounds (scalar, isotropic; slf_bake.py:84-85)
    log("[slf_bake] pass 1: scene bounds")
    vmin, vmax = np.float32(1e30), np.float32(-1e30)
    for fr in dataset.frames():
        pos, valid = _first_hits(tracer, _device_rays(fr, dev))
        lo = torch.min(torch.where(valid[:, None], pos, big))
        hi = torch.max(torch.where(valid[:, None], pos, -big))
        lo, hi = torch.stack([lo, hi]).tolist()
        vmin = min(vmin, lo)
        vmax = max(vmax, hi)
    if dataset_kind in ("synthetic", "real"):
        vmin, vmax = 1.1 * vmin, 1.1 * vmax
    else:
        c = vmin + vmax
        vmin, vmax = c + (vmin - c) * 1.1, c + (vmax - c) * 1.1

    # pass 2: visibility. The voxel of a hit is taken as the JAX package
    # takes it here: (pos - f32(vmin)) / f32(vmax - vmin), the span
    # rounded once from the host's double (pass 3's spatial_idx subtracts
    # the two f32 bounds instead)
    log("[slf_bake] pass 2: voxel visibility")
    res = voxel_num
    lo_t = torch.tensor(vmin, dtype=torch.float32, device=dev)
    span_t = torch.tensor(vmax - vmin, dtype=torch.float32, device=dev)
    # one slot past the grid takes the misses: no host sync
    occupied = torch.zeros(res ** 3 + 1, dtype=torch.bool, device=dev)
    for fr in dataset.frames():
        pos, valid = _first_hits(tracer, _device_rays(fr, dev))
        x = (pos - lo_t) / span_t
        # clamp before the cast: a float->int cast out of range is
        # undefined in C, and saturates in XLA
        xi = torch.clamp(torch.clamp(x * res, -1.0, float(res))
                         .to(torch.int64), 0, res - 1)
        flat = xi[:, 0] + xi[:, 1] * res + xi[:, 2] * res * res
        occupied[torch.where(valid, flat, res ** 3)] = True
    mask = occupied[:-1].reshape(res, res, res).cpu().numpy()

    # pass 3: radiance bake
    log("[slf_bake] pass 3: radiance scatter")
    vslf = init_voxel_slf(mask, vmin, vmax, device=dev)
    for fr in dataset.frames():
        pos, valid = _first_hits(tracer, _device_rays(fr, dev))
        exposure = fr.get("exposure")
        if exposure is None:
            exposure = np.float32(1.0)
        rgbs = torch.from_numpy(np.ascontiguousarray(fr["rgbs"])).to(dev)
        radiance = crf_inverse(crf, rgbs, torch.tensor(
            np.float32(exposure), device=dev))
        vslf = slf_scatter_add(vslf, pos, radiance, mask=valid)
    return slf_finalize_mean(vslf), mask


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--dataset_root", type=str, default=None)
    parser.add_argument("--scene", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--voxel_num", type=int, default=256)
    parser.add_argument("--ldr_img_dir", type=str, default=None)
    parser.add_argument("--res_scale", type=float, default=1.0)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    os.makedirs(args.output, exist_ok=True)
    scene_args, dataset = stage_dataset(args)
    mesh, tracer = load_scene(*scene_args, device=dev)

    crf = init_emor_crf(dim=11, device=dev)
    t0 = time.time()
    vslf, mask = bake_slf(tracer, dataset, crf, args.voxel_num, args.dataset)
    save_vslf(os.path.join(args.output, "vslf.npz"), vslf, mask)
    print(f"[slf_bake] time (s): {time.time() - t0:.1f}")


if __name__ == "__main__":
    main()
