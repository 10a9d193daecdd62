"""Stages 2/4: emitter mask extraction & radiance update (counterpart of
iris_tpu/pipeline/extract_emitter.py; reference extract_emitter_ldr.py).

  export: per-triangle mean observed LDR radiance (a deterministic segment
          sum per frame, core/segment.py, where the JAX package uses
          jax.ops.segment_sum), threshold 0.99 on the brightest channel,
          triangle geometry and area by cross products; writes emitter.npz
  update: copy the learned emitter radiance from a checkpoint (the port's
          train/checkpoint.py format) into emitter.npz (:117-122)
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np
import torch

from iris_tpu_torch.core.segment import segment_sum
from iris_tpu_torch.device import resolve_device
from iris_tpu_torch.geometry.intersect import ray_intersect
from iris_tpu_torch.pipeline.common import (
    load_scene, save_emitter, stage_dataset,
)
from iris_tpu_torch.train.checkpoint import load_pytree


@torch.no_grad()
def face_means(tracer, n_face: int, dataset) -> np.ndarray:
    """(n_face, 3) mean LDR colour of the train pixels whose first hit is
    each face (0 where none is); misses go to an overflow bucket."""
    dev = tracer.nodes.device
    acc = torch.zeros((n_face + 1, 4), dtype=torch.float32, device=dev)
    for fr in dataset.frames():
        rays = torch.from_numpy(np.ascontiguousarray(fr["rays"])).to(dev)
        rgbs = torch.from_numpy(np.ascontiguousarray(fr["rgbs"])).to(dev)
        _, _, _, tri, valid = ray_intersect(tracer, rays[:, :3],
                                            rays[:, 3:6])
        seg = torch.where(valid, tri, n_face)
        rows = torch.cat([torch.where(valid[:, None], rgbs, 0.0),
                          valid.to(torch.float32)[:, None]], -1)
        acc = acc + segment_sum(rows, seg, n_face + 1)
    acc = acc[:n_face].cpu().numpy()
    return acc[:, :3] / np.maximum(acc[:, 3], 1.0)[:, None]


def extract_emitter(tracer, mesh, dataset, threshold: float = 0.99,
                    log=print):
    """(is_emitter, emitter triangles, areas, normals, zero radiance)."""
    n_face = mesh.n_faces
    mean = face_means(tracer, n_face, dataset)
    peak = mean.max(-1)  # max channel (extract_emitter_ldr.py:98)
    is_emitter = peak > threshold

    tri = mesh.triangles()[is_emitter]
    c = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    norm = np.linalg.norm(c, axis=-1)
    emitter_normal = c / np.maximum(norm, 1e-20)[:, None]
    emitter_area = norm / 2.0
    emitter_radiance = np.zeros((max(int(is_emitter.sum()), 1), 3),
                                np.float32)
    log(f"[extract_emitter] {int(is_emitter.sum())}/{n_face} emitter faces")
    return is_emitter, tri, emitter_area, emitter_normal, emitter_radiance


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--dataset_root", type=str, default=None)
    parser.add_argument("--scene", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--mode", type=str, default="export",
                        choices=["export", "update"])
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--threshold", type=float, default=0.99)
    parser.add_argument("--ldr_img_dir", type=str, default=None)
    parser.add_argument("--res_scale", type=float, default=1.0)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    os.makedirs(args.output, exist_ok=True)
    emitter_file = os.path.join(args.output, "emitter.npz")

    if args.mode == "update":
        ckpt = load_pytree(args.ckpt, device=dev)
        with np.load(emitter_file) as f:
            z = dict(f)
        save_emitter(emitter_file, z["is_emitter"], z["emitter_vertices"],
                     z["emitter_area"], z["emitter_normal"],
                     ckpt["radiance"].detach().cpu().numpy())
        print("[extract_emitter] updated radiance from", args.ckpt)
        return

    scene_args, dataset = stage_dataset(args)
    mesh, tracer = load_scene(*scene_args, device=dev)
    out = extract_emitter(tracer, mesh, dataset, args.threshold)
    save_emitter(emitter_file, *out)


if __name__ == "__main__":
    main()
