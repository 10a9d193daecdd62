"""Semantic-mesh -> per-view segmentation maps via ray casting
(counterpart of iris_tpu/utils/render_semantic.py; reference
utils/dataset/scannetpp/render_semantic.py): a labeled mesh (a semantic id
per face) is ray-cast from every camera of the train split, and each view
gets the label of the face its pixel sees, -1 where the ray misses.

One traversal a frame on the tracer's device. The labels are written as
half-float EXRs, as the JAX package writes them: a half float holds every
integer up to 2048 and rounds larger ones to its grid (2049 reads back as
2048, and past 65504 as inf).

Usage: python -m iris_tpu_torch.utils.render_semantic --dataset synthetic \
           --scene <root> --labels <faces>.npy --output <dir>
           [--ldr_img_dir ldr] [--device cpu]
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


def face_label_tensor(face_labels: np.ndarray, n_faces: int, dev
                      ) -> torch.Tensor:
    """The per-face labels as int32 on `dev` (a float array truncated, as
    the JAX package's jnp.asarray(labels, int32) does). One label a face:
    the JAX gather would clamp a short array's indices, this one raises."""
    labels = np.asarray(face_labels)
    if labels.ndim != 1 or labels.shape[0] < n_faces:
        raise ValueError(f"{labels.shape} labels for a mesh of {n_faces} "
                         "faces: one label a face expected")
    return torch.from_numpy(labels.astype(np.int32)).to(dev)


@torch.no_grad()
def semantic_labels(tracer, labels: torch.Tensor, rays: torch.Tensor
                    ) -> torch.Tensor:
    """(B,) int32 label of the face each ray (B, 12) hits, -1 on a miss."""
    _, _, _, tri, valid = ray_intersect(tracer, rays[:, :3], rays[:, 3:6])
    return torch.where(valid, labels[torch.clamp(tri, min=0)], -1)


def label_image(seg: np.ndarray, img_hw) -> np.ndarray:
    """(H, W, 3) float32 image of (H * W,) integer labels, as the label
    tools write them."""
    h, w = img_hw
    return np.repeat(seg.astype(np.float32).reshape(h, w, 1), 3, -1)


def render_semantic(tracer, face_labels: np.ndarray, dataset, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    dev = tracer.nodes.device
    lab = face_label_tensor(face_labels, tracer.n_faces, dev)
    for i, fr in enumerate(dataset.frames()):
        rays = torch.from_numpy(np.ascontiguousarray(fr["rays"])).to(dev)
        seg = semantic_labels(tracer, lab, rays).cpu().numpy()
        write_exr(os.path.join(out_dir, f"{i:03d}.exr"),
                  label_image(seg, dataset.img_hw))


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--dataset_root", type=str, default=None)
    parser.add_argument("--scene", type=str, required=True)
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--labels", type=str, required=True,
                        help=".npy per-face semantic labels")
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--ldr_img_dir", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    scene_args, ds = stage_dataset(args)
    _, tracer = load_scene(*scene_args, device=dev)
    labels = np.load(args.labels)
    render_semantic(tracer, labels, ds, args.output)
    print("[render_semantic] wrote", args.output)


if __name__ == "__main__":
    main()
