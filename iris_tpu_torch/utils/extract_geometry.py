"""Export per-view position / normal / depth maps (counterpart of
iris_tpu/utils/extract_geometry.py; reference
utils/dataset/neilf/extract_geometry.py): geometry buffers for NeILF-style
baselines, produced by ray casting each dataset view.

One traversal a frame on the tracer's device. A miss has position 0,
normal 0 and depth 0, as ray_intersect gives it. The maps are written as
half-float EXRs, as the JAX package writes them.

Usage: python -m iris_tpu_torch.utils.extract_geometry --dataset synthetic \
           --scene <root> --output <dir> [--ldr_img_dir ldr] [--split train]
           [--device cpu]
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np
import torch

from iris_tpu_torch.device import resolve_device
from iris_tpu_torch.geometry.intersect import ray_intersect
from iris_tpu_torch.pipeline.common import load_scene, stage_dataset
from iris_tpu_torch.utils.exr import write_exr


@torch.no_grad()
def trace_geometry(tracer, rays: torch.Tensor):
    """(positions (B, 3), normals (B, 3), depth (B,)) of one frame's rays
    (B, 12) on the tracer's device: depth = |pos - origin|, 0 on a miss."""
    xs, ds = rays[:, :3], rays[:, 3:6]
    pos, nrm, _, _, valid = ray_intersect(tracer, xs, ds)
    depth = torch.linalg.vector_norm(pos - xs, dim=-1) * valid
    return pos, nrm, depth


def extract_geometry(tracer, dataset, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    h, w = dataset.img_hw
    dev = tracer.nodes.device
    for i, fr in enumerate(dataset.frames()):
        rays = torch.from_numpy(np.ascontiguousarray(fr["rays"])).to(dev)
        pos, nrm, depth = [x.cpu().numpy()
                           for x in trace_geometry(tracer, rays)]
        write_exr(os.path.join(out_dir, f"{i:03d}_position.exr"),
                  pos.reshape(h, w, 3))
        write_exr(os.path.join(out_dir, f"{i:03d}_normal.exr"),
                  nrm.reshape(h, w, 3))
        write_exr(os.path.join(out_dir, f"{i:03d}_depth.exr"),
                  depth.reshape(h, w))


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--dataset_root", type=str, default=None)
    parser.add_argument("--scene", type=str, required=True)
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--ldr_img_dir", type=str, default=None)
    parser.add_argument("--split", type=str, default="train")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    scene_args, ds = stage_dataset(args, split=args.split)
    _, tracer = load_scene(*scene_args, device=dev)
    extract_geometry(tracer, ds, args.output)
    print("[extract_geometry] wrote", args.output)


if __name__ == "__main__":
    main()
