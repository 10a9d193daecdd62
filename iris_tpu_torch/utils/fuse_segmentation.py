"""Multi-view segmentation fusion by per-face voting (counterpart of
iris_tpu/utils/fuse_segmentation.py; reference utils/fuse_segmentation.py):
ray-cast every view of the train split, build a face x label vote
histogram, take each face's most-voted label, then rewrite each view's
segmentation from the fused per-face labels so that the maps agree across
views.

Two traversals a frame on the tracer's device: one to vote, one to
rewrite. The votes are integer counts (`torch.bincount`, one
n_faces * n_labels + 1 bin histogram; the last bin takes the misses), so
they are exact, and the fused labels the same bits whatever order the
card adds in; the JAX package adds 1.0 in float32, which is exact as far
as 2^24 votes a bin. The JAX semantics are kept: a label read from the map
is truncated to an integer as XLA converts (NaN to 0, saturating) and
clipped to [0, n_labels - 1] (so -1,
"unlabelled", votes for 0 and labels past the cap merge into the last);
a miss casts no vote; ties go to the lowest label; a face nobody saw
fuses to -1; and a rewritten pixel keeps its own label where its ray
misses or its face fused to -1.

Usage: python -m iris_tpu_torch.utils.fuse_segmentation --dataset synthetic \
           --scene <root> --output <dir> [--n_labels 128] [--ldr_img_dir ldr]
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
from iris_tpu_torch.utils.render_semantic import label_image


def float_to_int32(x: torch.Tensor) -> torch.Tensor:
    """x truncated to int32 as XLA converts (the JAX package's
    .astype(int32)): NaN to 0, values past the range saturated, where a
    plain .to(torch.int32) leaves them undefined."""
    lo, hi = -2.0 ** 31, 2.0 ** 31
    x = torch.nan_to_num(x.float(), nan=0.0)
    inside = (x > lo) & (x < hi)
    out = torch.where(inside, x, 0.0).to(torch.int32)
    out = torch.where(x >= hi, torch.iinfo(torch.int32).max, out)
    return torch.where(x <= lo, torch.iinfo(torch.int32).min, out)


def _frame_tensors(fr, dev):
    rays = torch.from_numpy(np.ascontiguousarray(fr["rays"])).to(dev)
    seg = torch.from_numpy(np.ascontiguousarray(
        fr["segmentation"])).to(dev)
    return rays, seg


@torch.no_grad()
def vote(tracer, hist: torch.Tensor, rays: torch.Tensor, seg: torch.Tensor,
         n_labels: int) -> torch.Tensor:
    """hist (n_faces * n_labels + 1,) int64 plus the votes of one frame:
    rays (B, 12), seg (B,) the frame's labels."""
    _, _, _, tri, valid = ray_intersect(tracer, rays[:, :3], rays[:, 3:6])
    lab = torch.clamp(float_to_int32(seg), 0, n_labels - 1).long()
    flat = torch.where(valid, torch.clamp(tri, min=0) * n_labels + lab,
                       hist.shape[0] - 1)
    return hist + torch.bincount(flat, minlength=hist.shape[0])


def fuse_segmentation(tracer, n_faces: int, frames, n_labels: int = 128):
    """frames: iterable of dicts with 'rays' (HW, 12) and 'segmentation'
    (HW,). Returns per-face fused labels (F,) int32 (-1 = unobserved)."""
    dev = tracer.nodes.device
    hist = torch.zeros(n_faces * n_labels + 1, dtype=torch.int64,
                       device=dev)
    for fr in frames:
        hist = vote(tracer, hist, *_frame_tensors(fr, dev), n_labels)
    h = hist[:-1].reshape(n_faces, n_labels)
    # argmax takes the first of equal counts: the lowest label
    labels = torch.where(h.sum(-1) > 0, torch.argmax(h, -1), -1)
    return labels.to(torch.int32).cpu().numpy()


@torch.no_grad()
def relabel(tracer, labels: torch.Tensor, rays: torch.Tensor,
            seg: torch.Tensor) -> torch.Tensor:
    """(B,) int32: the fused label of the face each ray sees, the frame's
    own (truncated) label where the ray misses or the face fused to -1."""
    _, _, _, tri, valid = ray_intersect(tracer, rays[:, :3], rays[:, 3:6])
    fused = labels[torch.clamp(tri, min=0)]
    keep = ~valid | (fused < 0)
    return torch.where(keep, float_to_int32(seg), fused)


def rewrite_views(tracer, labels, frames, out_dir: str, img_hw):
    os.makedirs(out_dir, exist_ok=True)
    dev = tracer.nodes.device
    lab = torch.as_tensor(np.asarray(labels, np.int32), device=dev)
    for i, fr in enumerate(frames):
        new = relabel(tracer, lab, *_frame_tensors(fr, dev)).cpu().numpy()
        write_exr(os.path.join(out_dir, f"{i:03d}.exr"),
                  label_image(new, img_hw))


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--dataset_root", type=str, default=None)
    parser.add_argument("--scene", type=str, required=True)
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--n_labels", type=int, default=128)
    parser.add_argument("--ldr_img_dir", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    scene_args, ds = stage_dataset(args, load_inverse=True)
    mesh, tracer = load_scene(*scene_args, device=dev)
    labels = fuse_segmentation(tracer, mesh.n_faces, ds.frames(),
                               args.n_labels)
    rewrite_views(tracer, labels, ds.frames(), args.output, ds.img_hw)
    print(f"[fuse_segmentation] fused {int((labels >= 0).sum())} labeled "
          f"faces -> {args.output}")


if __name__ == "__main__":
    main()
