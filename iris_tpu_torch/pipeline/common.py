"""Shared stage plumbing: scene/mesh resolution, artifact IO, model
assembly (counterpart of iris_tpu/pipeline/common.py).

Cross-stage artifacts keep the JAX package's files and layouts, so that
each package reads what the other writes: vslf.npz (SLF bake, keys mask,
voxel_min, voxel_max, radiance, count) and emitter.npz (emitter
extraction, keys is_emitter, emitter_vertices, emitter_area,
emitter_normal, emitter_radiance). Checkpoint .pkl files are the port's
own (train/checkpoint.py). The trainers run on one device or
data-parallel over several (run_ranks, mesh_batch_size).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import sys
import tempfile

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
from iris_tpu_torch.parallel.distributed import (
    ensure_multihost, host_summary,
)


def mesh_batch_size(batch_size: int, n_ranks: int | None = None,
                    name: str = "train") -> int:
    """Round a requested ray batch DOWN to a positive multiple of the rank
    count (iris_tpu/pipeline/common.py:24 rounds it to the data mesh's
    width): every rank takes B/N rows (parallel.sharding.shard_rows), and
    an odd batch from an odd-resolution scene would not split. None is one
    rank."""
    n = max(int(n_ranks or 1), 1)
    b = max((batch_size // n) * n, n)
    if b != batch_size:
        print(f"[{name}] batch_size {batch_size} -> {b} "
              f"(multiple of the {n}-device mesh)")
    return b


def run_ranks(main_fn, argv, args, train, samples_for_step=None):
    """Run a trainer's train(group) as the flags ask (args parsed from
    argv; main_fn the trainer's main):

    - --n_devices N > 1 with no --coordinator: N devices of this host, one
      process a device. N-1 processes are started here (spawn), each
      running main_fn with the multihost flags of its rank; this process
      is rank 0. On the card: cuda:0..N-1 in an NCCL group (raises if
      fewer than N cards are visible); with --device cpu, N gloo ranks on
      the CPU. A rendezvous file in a temporary directory joins them. A
      rank that fails fails the run.
    - --coordinator: one process of a run started elsewhere
      (parallel.distributed.ensure_multihost with --num_processes,
      --process_id and --dist_backend, on --device).
    - neither: one process, no group.

    samples_for_step (replayed draws) needs the processes in hand: it is
    refused with --n_devices > 1. Returns what train(group,
    samples_for_step) returns on this process."""
    n = args.n_devices or 1
    if args.coordinator is None and n > 1:
        if samples_for_step is not None:
            raise ValueError("samples_for_step replays the draws of "
                             "processes in hand; --n_devices starts them")
        return _spawn_ranks(main_fn, sys.argv[1:] if argv is None
                            else list(argv), args, n)
    if args.coordinator is not None and args.n_devices not in (
            None, args.num_processes):
        raise ValueError(f"--n_devices {args.n_devices} with "
                         f"--num_processes {args.num_processes}: a process "
                         "of a multihost run drives one device")
    group = ensure_multihost(args.coordinator, args.num_processes,
                             args.process_id, backend=args.dist_backend,
                             device=args.device)
    if group is not None:
        print(f"[parallel] {host_summary(group)}")
    try:
        return train(group, samples_for_step)
    finally:
        if group is not None:
            group.close()


def _rank_main(i, main_fn, argvs, n_threads):
    torch.set_num_threads(n_threads)
    main_fn(argvs[i + 1])


def _spawn_ranks(main_fn, argv, args, n):
    if resolve_device(args.device).type == "cuda":
        have = torch.cuda.device_count()
        if have < n:
            raise RuntimeError(f"--n_devices {n}: only {have} cards are "
                               "visible")
        devices = [f"cuda:{r}" for r in range(n)]
    else:
        devices = ["cpu"] * n
    tmp = tempfile.mkdtemp(prefix="iris_ranks_")
    coordinator = "file://" + os.path.join(tmp, "rendezvous")
    argvs = [argv + ["--coordinator", coordinator, "--num_processes",
                     str(n), "--process_id", str(r), "--device", devices[r]]
             for r in range(n)]
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(main_fn, argvs, torch.get_num_threads()),
        nprocs=n - 1, join=False, start_method="spawn")
    try:
        out = main_fn(argvs[0])
        while not ctx.join():
            pass
        return out
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        shutil.rmtree(tmp, ignore_errors=True)


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
