"""Stage 7: re-bake the SLF radiance with the learned CRF (counterpart of
iris_tpu/pipeline/slf_refine.py; reference slf_refine.py).

Reuses the existing vslf mask and bounds and redoes only the radiance
pass, with crf_inverse under the trained CRF weights of a checkpoint
(--ckpt, a port train/checkpoint.py file). The per-voxel sums are the
deterministic segment sums of models/slf.py: two runs give the same bits.
Writes vslf_0.npz (or --save) in the JAX package's layout.

Usage: python -m iris_tpu_torch.pipeline.slf_refine --dataset synthetic \
           --scene <root> --output <bake dir> --ckpt brdf0/last.pkl \
           [--device cpu]
"""

from __future__ import annotations

import os
import time
from argparse import ArgumentParser
from dataclasses import replace as dc_replace

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
from iris_tpu_torch.train.checkpoint import load_pytree


@torch.no_grad()
def refine_slf(tracer, dataset, crf, mask, vmin, vmax):
    """The SLF of `mask` and bounds, its radiance the mean CRF-inverted LDR
    of the first hits of every train frame, on the tracer's device."""
    dev = tracer.nodes.device
    vslf = init_voxel_slf(mask, vmin, vmax, device=dev)
    for fr in dataset.frames():
        rays = torch.from_numpy(np.ascontiguousarray(fr["rays"])).to(dev)
        pos, _, _, _, valid = ray_intersect(tracer, rays[:, :3],
                                            rays[:, 3:6])
        exposure = fr.get("exposure")
        if exposure is None:
            exposure = np.float32(1.0)
        rgbs = torch.from_numpy(np.ascontiguousarray(fr["rgbs"])).to(dev)
        radiance = crf_inverse(crf, rgbs, torch.tensor(
            np.float32(exposure), device=dev))
        vslf = slf_scatter_add(vslf, pos, radiance, mask=valid)
    return slf_finalize_mean(vslf)


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--dataset_root", type=str, default=None)
    parser.add_argument("--scene", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--load", type=str, default="vslf.npz")
    parser.add_argument("--save", type=str, default="vslf_0.npz")
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--ldr_img_dir", type=str, default=None)
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--crf_basis", type=int, default=3)
    parser.add_argument("--res_scale", type=float, default=1.0)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    scene_args, dataset = stage_dataset(args)
    mesh, tracer = load_scene(*scene_args, device=dev)

    crf = init_emor_crf(dim=args.crf_basis, device=dev)
    if args.ckpt:
        ckpt = load_pytree(args.ckpt, dev)
        if "crf_weight" in ckpt:
            crf = dc_replace(crf, weight=ckpt["crf_weight"])

    z = np.load(os.path.join(args.output, args.load))
    t0 = time.time()
    vslf = refine_slf(tracer, dataset, crf, z["mask"],
                      float(z["voxel_min"]), float(z["voxel_max"]))
    save_vslf(os.path.join(args.output, args.save), vslf, z["mask"])
    print(f"[slf_refine] time (s): {time.time() - t0:.1f}")


if __name__ == "__main__":
    main()
