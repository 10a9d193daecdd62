"""Export the emitter submesh and its area-weighted average radiance
(counterpart of iris_tpu/utils/extract_emitter_mesh.py, numpy; reference
utils/extract_emitter_mesh.py): emitter.npz -> emitter.ply, the mesh that
the relight configs' emitter swap loads (scripts/relight/**/insert.yaml).

Usage: python -m iris_tpu_torch.utils.extract_emitter_mesh
           --emitter <bake dir>/emitter.npz --output <bake dir>/emitter.ply
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np

from iris_tpu_torch.geometry.mesh import save_ply


def extract_emitter_mesh(emitter_npz: str, out_ply: str) -> np.ndarray:
    """Write the emitter faces of `emitter_npz` as a triangle PLY; returns
    the area-weighted average radiance (3,)."""
    z = np.load(emitter_npz)
    verts = z["emitter_vertices"].reshape(-1, 3)
    faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    save_ply(out_ply, verts, faces)
    area = z["emitter_area"]
    rad = z["emitter_radiance"]
    if rad.shape[0] != area.shape[0]:
        rad = rad[: area.shape[0]]
    return (rad * area[:, None]).sum(0) / max(area.sum(), 1e-12)


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--emitter", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    args = parser.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    avg = extract_emitter_mesh(args.emitter, args.output)
    print(f"[extract_emitter_mesh] avg radiance: {avg.tolist()}")


if __name__ == "__main__":
    main()
