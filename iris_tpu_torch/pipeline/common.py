"""Shared stage plumbing: scene/mesh resolution, artifact IO, model
assembly (counterpart of iris_tpu/pipeline/common.py).

Cross-stage artifacts keep the JAX package's files and layouts, so that
each package reads what the other writes: vslf.npz (SLF bake, keys mask,
voxel_min, voxel_max, radiance, count) and emitter.npz (emitter
extraction, keys is_emitter, emitter_vertices, emitter_area,
emitter_normal, emitter_radiance). Checkpoint .pkl files are the port's
own (train/checkpoint.py). mesh_batch_size runs on one device: a run
over several waits for the port of iris_tpu/parallel/.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from iris_tpu_torch.data.datasets import load_dataset
from iris_tpu_torch.device import resolve_device
from iris_tpu_torch.geometry.bvh import Tracer, build_bvh
from iris_tpu_torch.geometry.mesh import Mesh, load_mesh
from iris_tpu_torch.models.brdf import NGPBRDF, init_ngp_brdf
from iris_tpu_torch.models.emitter import Emitter, make_emitter
from iris_tpu_torch.models.hashgrid import (
    HashGridConfig, auto_bwd_level_sample,
)
from iris_tpu_torch.models.slf import VoxelSLF, init_voxel_slf


def mesh_batch_size(batch_size: int, n_devices: int | None = None,
                    name: str = "train") -> int:
    """The ray batch of a run over `n_devices` (iris_tpu/pipeline/common.py:24
    rounds it down to a multiple of the data mesh's width). The port trains
    on one device: None or 1 leaves the batch as it is; more raises, so
    that a run asked to spread never runs on one device in silence."""
    if n_devices is None or int(n_devices) == 1:
        return batch_size
    raise NotImplementedError(
        f"[{name}] --n_devices {n_devices}: training over several devices "
        "waits for the port of iris_tpu/parallel/ (torch.distributed); "
        "this port trains on one device")


def resolve_mesh_path(dataset: str, dataset_root: str, scene: str = ""
                      ) -> str:
    """Reference mesh layout (train_brdf_crf.py:52-58)."""
    if dataset in ("synthetic", "real"):
        return os.path.join(dataset_root, "scene.obj")
    if dataset == "scannetpp":
        return os.path.join(dataset_root, "data", scene, "scans",
                            "scene.ply")
    raise ValueError(dataset)


def load_scene(dataset: str, dataset_root: str, scene: str = "",
               device=None) -> tuple[Mesh, Tracer]:
    """The stage's mesh (host) and its BVH tracer on `device`."""
    mesh_path = resolve_mesh_path(dataset, dataset_root, scene)
    if not os.path.exists(mesh_path):
        raise FileNotFoundError(f"mesh not found: {mesh_path}")
    mesh = load_mesh(mesh_path)
    return mesh, build_bvh(mesh.triangles(), device=device)


def make_dataset(args, split: str, **kw):
    ds_name, ds_path = args.dataset
    common = dict(res_scale=args.res_scale)
    if ds_name in ("synthetic", "real"):
        common["img_dir"] = args.ldr_img_dir
    common.update(kw)
    return load_dataset(ds_name, ds_path, scene=args.scene, split=split,
                        **common)


def val_frame(args, stage: str):
    """(val dataset, its frame args.val_frame, or the last) for a trainer's
    validation hooks, or (None, None) where the dataset has no val split:
    only that is skipped, with the JAX package's message. Any other
    failure raises (the JAX trainers catch every exception here)."""
    try:
        val_ds = make_dataset(args, "val")
    except FileNotFoundError as e:   # the val split is optional
        print(f"[{stage}] no validation split:", e)
        return None, None
    return val_ds, val_ds.frame(min(args.val_frame, len(val_ds) - 1))


def stage_dataset(args, split: str = "train", **extra):
    """A split (the train split by default) as the shading-cache stages and
    the dataset tools read it (their --dataset KIND --scene ROOT
    convention; no GT maps): (mesh path arguments for load_scene,
    dataset). `extra`: more load_dataset keywords (load_inverse). The
    tools have no --res_scale, as in the JAX package: they read full
    frames."""
    scene_id = args.scene if args.dataset == "scannetpp" else ""
    data_root = ((args.dataset_root or args.scene)
                 if args.dataset == "scannetpp" else args.scene)
    kw = dict(split=split, res_scale=getattr(args, "res_scale", 1.0),
              **extra)
    if args.dataset in ("synthetic", "real"):
        kw["img_dir"] = args.ldr_img_dir
    if args.dataset == "synthetic":
        kw["load_gt"] = False
    return (args.dataset, data_root, scene_id), load_dataset(
        args.dataset, data_root, scene=scene_id, **kw)


# ----------------------------------------------------------- artifacts

def save_vslf(path: str, slf: VoxelSLF, mask: np.ndarray) -> None:
    np.savez_compressed(
        path, mask=np.asarray(mask),
        voxel_min=float(slf.voxel_min), voxel_max=float(slf.voxel_max),
        radiance=slf.radiance.detach().cpu().numpy(),
        count=slf.count.detach().cpu().numpy(),
    )


def load_vslf(path: str, device=None) -> tuple[VoxelSLF, np.ndarray]:
    dev = resolve_device(device)
    z = np.load(path if path.endswith(".npz") else path + ".npz",
                allow_pickle=False)
    slf = init_voxel_slf(z["mask"], float(z["voxel_min"]),
                         float(z["voxel_max"]), device=dev)
    slf = dataclasses.replace(
        slf, radiance=torch.as_tensor(z["radiance"], device=dev),
        count=torch.as_tensor(z["count"], device=dev))
    return slf, z["mask"]


def save_emitter(path: str, is_emitter, vertices, area, normal, radiance):
    np.savez_compressed(path, is_emitter=np.asarray(is_emitter),
                        emitter_vertices=np.asarray(vertices),
                        emitter_area=np.asarray(area),
                        emitter_normal=np.asarray(normal),
                        emitter_radiance=np.asarray(radiance))


def load_emitter(path: str, mesh: Mesh, slf: VoxelSLF | None = None,
                 device=None) -> Emitter:
    z = np.load(path if path.endswith(".npz") else path + ".npz")
    return make_emitter(z["is_emitter"], mesh.triangles(),
                        radiance=z["emitter_radiance"], slf=slf,
                        device=device)


def _estimator_fields(args, n_levels: int) -> dict:
    bls = int(getattr(args, "bwd_level_sample", -1))
    if bls < 0:   # -1 = auto: ~4x scatter reduction
        bls = auto_bwd_level_sample(n_levels)
    return dict(stochastic_bwd=bool(getattr(args, "stochastic_bwd", 1)),
                stochastic_fwd=bool(getattr(args, "stochastic_fwd", 1)),
                bwd_level_sample=bls,
                fwd_level_sample=int(getattr(args, "fwd_level_sample", 0)))


def build_material(args, voxel_min, voxel_max, seed: int = 0,
                   device=None) -> NGPBRDF:
    """The NGP material the stage flags describe, random from `seed` (a
    torch.Generator stream, not the JAX package's PRNGKey(0) values)."""
    feats = int(getattr(args, "hash_features", 2))
    row = int(getattr(args, "hash_row_gather", -1))
    row = (feats > 2) if row < 0 else bool(row)
    pls = float(getattr(args, "per_level_scale", -1.0))
    if pls <= 0:
        # span the reference 32-level range (16 .. 16*1.3^31) at any L
        pls = 1.3 ** (31.0 / max(args.hash_levels - 1, 1))
    cfg = HashGridConfig(n_levels=args.hash_levels,
                         n_features=feats,
                         log2_table_size=args.log2_hashmap_size,
                         per_level_scale=pls,
                         row_gather=row,
                         **_estimator_fields(args, args.hash_levels))
    return init_ngp_brdf(seed, voxel_min, voxel_max, cfg, device=device)


def adopt_estimator_cfg(tree, args):
    """Re-attach the CURRENT stage's estimator policy (stochastic_*,
    *_level_sample) to every NGPBRDF in a warm-started tree (nested dicts
    and lists); the model-defining fields stay with the weights."""

    def adopt(x):
        if isinstance(x, NGPBRDF):
            return dataclasses.replace(x, cfg=dataclasses.replace(
                x.cfg, **_estimator_fields(args, x.cfg.n_levels)))
        if isinstance(x, dict):
            return {k: adopt(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(adopt(v) for v in x)
        return x

    return adopt(tree)


def ckpt_path(checkpoint_root: str, experiment: str, name: str = "last.pkl"
              ) -> str:
    d = os.path.join(checkpoint_root, experiment)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, name)
