"""Dataset loaders (host-side numpy) for the three scene families
(counterpart of iris_tpu/data/datasets.py: the same frames, banks and
batches, bit for bit). Frames stay numpy on the host; a stage moves a
frame's rays to its device once.

Parity with reference utils/dataset/:
  SyntheticDataset   <-> synthetic_ldr.py  (FIPT Blender scenes:
      transforms.json poses, per-split Image/DiffCol/Roughness/Emit/
      IndexMA/segmentation dirs, optional multi-exposure LDR dirs)
  RealDataset        <-> real_ldr.py       (FIPT captures: cam.txt OpenGL
      extrinsics -> OpenCV, K_list.txt, every-10th-frame val split)
  ScannetppDataset   <-> scannetpp/dataset.py (psdf/ layout,
      train_test_lists.json, transforms_all.json with OpenGL flip,
      exposure==1 + mean-EMoR GT CRF)

Each loader exposes:
  frame(idx)     -> dict for frame-mode consumers (render/eval/bakes)
  pixel_bank()   -> dict of flat (N, ...) arrays for pixel-batch training
The "Inv" capability of the reference (segmentation/albedo/shading caches)
is folded in via flags instead of parallel classes.

RayBatcher replaces DataLoader+resample (synthetic_ldr.py:379-390): a
permuted index stream, re-permuted per epoch, strided per host for
multi-host training.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from iris_tpu_torch.const import GAMMA
from iris_tpu_torch.data.rays import (
    concat_rays, get_direction_k, get_ray_directions_blender,
    get_rays_blender, opengl_cam_to_opencv, read_cam_params, to_world_k,
)
from iris_tpu_torch.geometry.bvh import morton3d
from iris_tpu_torch.models.emor import parse_emor_file
from iris_tpu_torch.utils.exr import read_exr
from iris_tpu_torch.utils.image import open_png

ROUGHNESS_LEVELS = 6


def _load_exposure_crf(img_root: str):
    exposures = np.load(os.path.join(img_root, "cam", "exposure.npy"))
    crfs = np.load(os.path.join(img_root, "cam", "crf.npy"))
    return exposures.astype(np.float32), crfs.astype(np.float32)


def _load_cache(cache_dir: str, idx: int, img_hw):
    """Shading-cache EXRs for one frame: diffuse (HW,3), spec0/1 (HW,R,3)."""
    hw = img_hw[0] * img_hw[1]
    diffuse = read_exr(
        os.path.join(cache_dir, "diffuse", f"{idx:03d}.exr")
    )[..., :3].reshape(hw, 3)
    s0, s1 = [], []
    for r in range(ROUGHNESS_LEVELS):
        s0.append(read_exr(os.path.join(
            cache_dir, "specular", f"{idx:03d}_0_{r}.exr"))[..., :3]
            .reshape(hw, 1, 3))
        s1.append(read_exr(os.path.join(
            cache_dir, "specular", f"{idx:03d}_1_{r}.exr"))[..., :3]
            .reshape(hw, 1, 3))
    return diffuse, np.concatenate(s0, 1), np.concatenate(s1, 1)


class _BaseDataset:
    """Shared pixel-bank assembly from per-frame dict loaders."""

    img_hw: tuple[int, int]
    n_frames: int
    exposures: np.ndarray | None = None
    crfs: np.ndarray | None = None

    def frame(self, idx: int) -> dict:
        raise NotImplementedError

    def __len__(self):
        return self.n_frames

    def frames(self):
        for i in range(self.n_frames):
            yield self.frame(i)

    def pixel_bank(self, keys=("rays", "rgbs"), memmap_dir: str | None = None,
                   max_ram_bytes: int = 8 << 30) -> dict:
        """All per-frame arrays concatenated into flat per-key banks.

        Small datasets stay in RAM. When the bank exceeds `max_ram_bytes`
        (the JAX package reads it from IRIS_TPU_BANK_RAM_LIMIT; here it is
        an argument), or `memmap_dir` is given, each key becomes a
        disk-backed np.memmap —
        a real 1000-frame ScanNet++ scene at full res is hundreds of GB,
        which must never be materialized in host RAM (the reference
        streams via DataLoader workers; here RayBatcher's random batch
        indexing reads only the touched pages). A completed bank is
        fingerprinted and reused across runs, skipping image decode.
        Without `memmap_dir` the bank goes under the temporary directory
        (tempfile.gettempdir())."""
        hw = self.img_hw[0] * self.img_hw[1]
        n = self.n_frames * hw
        has_exposure = self.exposures is not None

        fr0 = self.frame(0)
        all_keys = list(keys) + (["exposure"] if has_exposure else [])
        shapes = {k: (n,) + tuple(np.asarray(fr0[k]).shape[1:])
                  for k in keys}
        if has_exposure:
            shapes["exposure"] = (n, 1)
        total = sum(int(np.prod(s)) * 4 for s in shapes.values())

        def fill(banks):
            for i in range(self.n_frames):
                fr = fr0 if i == 0 else self.frame(i)
                lo, hi = i * hw, (i + 1) * hw
                for k in keys:
                    banks[k][lo:hi] = np.asarray(fr[k], np.float32)
                if has_exposure:
                    banks["exposure"][lo:hi] = np.float32(self.exposures[i])

        if memmap_dir is None and total <= max_ram_bytes:
            banks = {k: np.empty(shapes[k], np.float32) for k in all_keys}
            fill(banks)
            return banks

        # ---- disk-backed bank
        import hashlib
        import json as _json
        import tempfile

        src = getattr(self, "split_dir", None) or getattr(
            self, "root_dir", "") or ""
        tag = hashlib.sha1(repr(
            (type(self).__name__, os.path.abspath(str(src)), self.img_hw,
             self.n_frames, sorted(all_keys),
             sorted(shapes.items()))).encode()).hexdigest()[:16]
        d = memmap_dir or os.path.join(tempfile.gettempdir(),
                                       "iris_tpu_banks", tag)
        os.makedirs(d, exist_ok=True)
        meta_p = os.path.join(d, "meta.json")
        complete = False
        if os.path.exists(meta_p):
            try:
                with open(meta_p) as f:
                    meta = _json.load(f)
                complete = (meta.get("complete")
                            and meta.get("tag") == tag
                            and all(os.path.exists(
                                os.path.join(d, f"{k}.f32")) for k in
                                all_keys))
            except Exception:
                complete = False
        mode = "r+" if complete else "w+"
        banks = {k: np.memmap(os.path.join(d, f"{k}.f32"), np.float32,
                              mode=mode, shape=shapes[k])
                 for k in all_keys}
        if not complete:
            print(f"[pixel_bank] building disk bank at {d} "
                  f"({total / 2**30:.1f} GB)")
            fill(banks)
            for v in banks.values():
                v.flush()
            with open(meta_p, "w") as f:
                _json.dump({"complete": True, "tag": tag,
                            "shapes": {k: list(v) for k, v in
                                       shapes.items()}}, f)
        else:
            print(f"[pixel_bank] reusing disk bank {d}")
        return banks


class SyntheticDataset(_BaseDataset):
    def __init__(self, root_dir, img_dir=None, split="train",
                 load_gt=True, load_inverse=False, has_part=True,
                 cache_dir=None, res_scale=1.0, val_frame=0):
        self.split_dir = os.path.join(
            root_dir, split if split != "relight" else "val")
        self.cache_dir = cache_dir
        self.load_gt = load_gt
        self.load_inverse = load_inverse
        # has_part claims the IndexMA part-id layout; real scenes without
        # part annotations ship a semantic-only segmentation/ dir instead
        # (reference synthetic_ldr.py has_part branch) — auto-fall back
        # when IndexMA is absent so loaders survive either layout
        self.has_part = has_part and os.path.isdir(
            os.path.join(self.split_dir, "IndexMA"))
        self.val_frame = val_frame
        if img_dir is None:
            self.img_dir, self.albedo_dir = "Image", "irisformer/albedo"
            self.gamma = GAMMA
            self.exposures = self.crfs = None
        else:
            self.img_dir = img_dir
            self.albedo_dir = os.path.join(img_dir, "albedo")
            self.gamma = None
            self.exposures, self.crfs = _load_exposure_crf(
                os.path.join(self.split_dir, img_dir))

        probe = read_exr(os.path.join(root_dir, "train", "Image",
                                      "000_0001.exr"))
        h, w = probe.shape[:2]
        self.img_hw = (int(h * res_scale), int(w * res_scale))

        with open(os.path.join(self.split_dir, "transforms.json")) as f:
            self.meta = json.load(f)
        self.n_frames = len(self.meta["frames"])
        h, w = self.img_hw
        self.focal = float(0.5 * w / np.tan(0.5 * self.meta["camera_angle_x"]))
        self.directions = get_ray_directions_blender(h, w, self.focal)

    def _img(self, idx):
        if self.img_dir == "Image" and self.gamma is None:
            pass
        p = os.path.join(self.split_dir, self.img_dir, f"{idx:03d}_0001.png")
        if os.path.exists(p):
            return open_png(p, self.img_hw, self.gamma).reshape(-1, 3)
        # fall back to linear EXR renders (HDR source)
        img = read_exr(os.path.join(self.split_dir, "Image",
                                    f"{idx:03d}_0001.exr"))[..., :3]
        return img.reshape(-1, 3).astype(np.float32)

    def frame(self, idx: int) -> dict:
        c2w = np.asarray(self.meta["frames"][idx]["transform_matrix"],
                         np.float32)[:3, :4]
        o, d, dxdu, dydv = get_rays_blender(self.directions, c2w, self.focal)
        out = {
            "rays": concat_rays(o, d, dxdu, dydv),
            "rgbs": self._img(idx),
            "c2w": c2w,
            "exposure": None if self.exposures is None
            else np.float32(self.exposures[idx]),
        }
        hw = self.img_hw[0] * self.img_hw[1]
        if self.load_gt:
            sd = self.split_dir
            out["albedo"] = read_exr(os.path.join(
                sd, "DiffCol", f"{idx:03d}_0001.exr"))[..., :3].reshape(-1, 3)
            out["roughness"] = read_exr(os.path.join(
                sd, "Roughness", f"{idx:03d}_0001.exr"))[..., 0].reshape(-1)
            out["emission"] = read_exr(os.path.join(
                sd, "Emit", f"{idx:03d}_0001.exr"))[..., :3].reshape(-1, 3)
        if self.load_inverse:
            sd = self.split_dir
            seg_file = os.path.join(sd, "IndexMA", f"{idx:03d}_0001.exr") \
                if self.has_part else os.path.join(
                    sd, "segmentation", f"{idx:03d}.exr")
            out["segmentation"] = read_exr(seg_file)[..., 0].reshape(-1)
            alb = open_png(os.path.join(sd, self.albedo_dir,
                                        f"{idx:03d}_0001.png"), self.img_hw)
            out["int_albedo"] = alb.reshape(-1, 3)
        if self.cache_dir is not None:
            d_, s0, s1 = _load_cache(self.cache_dir, idx, self.img_hw)
            out["diffuse"], out["specular0"], out["specular1"] = d_, s0, s1
        assert out["rays"].shape[0] == hw
        return out


def _real_split_ids(n_total: int, split: str):
    val = [i * 10 for i in range(16)]
    if split in ("val", "test"):
        return [i for i in val if i < n_total]
    return [i for i in range(n_total) if i not in val]


class RealDataset(_BaseDataset):
    def __init__(self, root_dir, img_dir=None, split="train",
                 load_inverse=False, cache_dir=None, res_scale=1.0,
                 val_frame=0):
        self.root_dir = root_dir
        self.cache_dir = cache_dir
        self.load_inverse = load_inverse
        self.val_frame = val_frame
        if img_dir is None:
            self.img_dir, self.albedo_dir = "Image", "irisformer/albedo"
            self.gamma = GAMMA
            self.exposures = self.crfs = None
        else:
            self.img_dir = img_dir
            self.albedo_dir = os.path.join(img_dir, "albedo")
            self.gamma = None
            self.exposures, self.crfs = _load_exposure_crf(
                os.path.join(root_dir, img_dir))

        probe = read_exr(os.path.join(root_dir, "Image", "000_0001.exr"))
        h, w = probe.shape[:2]
        self.img_hw = (int(h * res_scale), int(w * res_scale))

        # cam.txt blocks are [origin; lookat; up] rows
        c2ws = []
        for blk in read_cam_params(os.path.join(root_dir, "cam.txt")):
            origin, lookat, up = blk[0], blk[1], blk[2]
            c2ws.append(opengl_cam_to_opencv(origin, lookat, up))
        ks = read_cam_params(os.path.join(root_dir, "K_list.txt"))
        ks = [k * np.asarray([[res_scale], [res_scale], [1.0]], np.float32)
              for k in ks]

        ids = _real_split_ids(len(c2ws), split)
        self.split_ids = ids
        self.c2ws = [c2ws[i] for i in ids]
        self.ks = [ks[i] for i in ids]
        if self.exposures is not None:
            self.exposures = self.exposures[ids]
        self.n_frames = len(ids)

    def frame(self, idx: int) -> dict:
        k, c2w = self.ks[idx], self.c2ws[idx]
        img_idx = self.split_ids[idx]
        local = get_direction_k(k, self.img_hw)
        o, d, dxdu, dydv = to_world_k(local, c2w, k)
        img = open_png(os.path.join(
            self.root_dir, self.img_dir, f"{img_idx:03d}_0001.png"),
            self.img_hw, self.gamma).reshape(-1, 3)
        out = {
            "rays": concat_rays(o, d, dxdu, dydv),
            "rgbs": np.maximum(img, 0.0),
            "c2w": c2w,
            "exposure": None if self.exposures is None
            else np.float32(self.exposures[idx]),
        }
        if self.load_inverse:
            seg = read_exr(os.path.join(self.root_dir, "segmentation",
                                        f"{img_idx:03d}.exr"))
            out["segmentation"] = seg[..., 0].reshape(-1)
            alb = open_png(os.path.join(self.root_dir, self.albedo_dir,
                                        f"{img_idx:03d}_0001.png"),
                           self.img_hw)
            out["int_albedo"] = alb.reshape(-1, 3)
        if self.cache_dir is not None:
            d_, s0, s1 = _load_cache(self.cache_dir, idx, self.img_hw)
            out["diffuse"], out["specular0"], out["specular1"] = d_, s0, s1
        return out


class ScannetppDataset(_BaseDataset):
    def __init__(self, root_dir, scene_id, split="train",
                 load_inverse=False, cache_dir=None, res_scale=1.0,
                 val_frame=0):
        self.cache_dir = cache_dir
        self.load_inverse = load_inverse
        self.val_frame = val_frame
        self.dir_scene = os.path.join(root_dir, "data", scene_id, "psdf")
        self.dir_rgb = os.path.join(self.dir_scene, "images")
        self.gamma = None

        with open(os.path.join(self.dir_scene, "train_test_lists.json")) as f:
            lists = json.load(f)
        if split == "train":
            names = lists["train"]
        elif split in ("test", "val"):
            names = lists["test"]
        else:
            names = lists["train"] + lists["test"]
        self.names = names
        self.n_frames = len(names)
        self.exposures = np.ones(len(names), np.float32)
        _, vectors = parse_emor_file(inv=False)
        self.crfs = np.stack([vectors[1]] * 3).astype(np.float32)

        with open(os.path.join(self.dir_scene, "transforms_all.json")) as f:
            tr = json.load(f)
        h, w = int(tr["h"] * res_scale), int(tr["w"] * res_scale)
        self.img_hw = (h, w)
        k = np.asarray([[tr["fl_x"], 0, tr["cx"]],
                        [0, tr["fl_y"], tr["cy"]],
                        [0, 0, 1]], np.float32)
        k[:2] *= res_scale
        self.k = k

        c2w_by_name = {}
        for fr in tr["frames"]:
            name = fr["file_path"].split("/")[-1]
            c2w = np.asarray(fr["transform_matrix"], np.float32)
            c2w[:3, 1:3] *= -1  # OpenGL -> OpenCV
            c2w_by_name[name] = c2w[:3]
        self.c2ws = [c2w_by_name[n] for n in names]

    def frame(self, idx: int) -> dict:
        c2w = self.c2ws[idx]
        local = get_direction_k(self.k, self.img_hw)
        o, d, dxdu, dydv = to_world_k(local, c2w, self.k)
        img = open_png(os.path.join(self.dir_rgb, self.names[idx]),
                       self.img_hw, self.gamma).reshape(-1, 3)
        out = {
            "rays": concat_rays(o, d, dxdu, dydv),
            "rgbs": np.maximum(img, 0.0),
            "c2w": c2w,
            "exposure": np.float32(1.0),
        }
        if self.load_inverse:
            stem = os.path.splitext(self.names[idx])[0]
            seg = read_exr(os.path.join(self.dir_scene, "seg",
                                        stem + ".exr"))
            out["segmentation"] = seg[..., 0].reshape(-1)
            alb = open_png(os.path.join(self.dir_scene, "albedo",
                                        stem + ".png"), self.img_hw)
            out["int_albedo"] = alb.reshape(-1, 3)
        if self.cache_dir is not None:
            d_, s0, s1 = _load_cache(self.cache_dir, idx, self.img_hw)
            out["diffuse"], out["specular0"], out["specular1"] = d_, s0, s1
        return out


def load_dataset(dataset: str, path: str, scene: str = "", **kw):
    """CLI dispatcher matching the reference's --dataset flag values."""
    if dataset == "synthetic":
        return SyntheticDataset(path, **kw)
    if dataset == "real":
        return RealDataset(path, **kw)
    if dataset == "scannetpp":
        return ScannetppDataset(path, scene, **kw)
    raise ValueError(f"unknown dataset type {dataset}")


def sort_rays_spatially(rays: np.ndarray, n_buckets: int = 1 << 10):
    """Order indices so nearby/parallel rays are adjacent: sort by direction
    octant then origin Morton code. Restores tile coherence for the union
    traversal after random permutation batching.

    Host twin of geometry/intersect.spatial_sort_perm (used for
    secondary rays); keep their key structure in sync."""
    o, d = rays[:, 0:3], rays[:, 3:6]
    octant = ((d[:, 0] > 0).astype(np.int64) * 4
              + (d[:, 1] > 0).astype(np.int64) * 2
              + (d[:, 2] > 0).astype(np.int64))
    lo, hi = o.min(0), o.max(0)
    m = morton3d((o - lo) / np.maximum(hi - lo, 1e-9)).astype(np.int64)
    key = octant * (1 << 48) + (m >> np.int64(15))
    return np.argsort(key, kind="stable")


class RayBatcher:
    """Permutation pixel batching with per-epoch resample and per-host
    striding (replaces InvDataset.resample + DataLoader).

    sort_batches=True spatially re-orders each batch (direction octant +
    origin Morton) — loss-invariant, but keeps the tiled union traversal
    coherent despite random pixel sampling."""

    def __init__(self, bank: dict, batch_size: int, seed: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 sort_batches: bool = True):
        self.bank = bank
        self.n = len(next(iter(bank.values())))
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.pi, self.pc = process_index, process_count
        self.sort_batches = sort_batches
        self.resample()

    def resample(self):
        self.idxs = self.rng.permutation(self.n)

    @property
    def batches_per_epoch(self):
        return math.ceil(self.n / self.batch_size)

    def batch(self, step: int) -> dict:
        per_host = self.batch_size // self.pc
        b0 = (step % self.batches_per_epoch) * self.batch_size
        sel = self.idxs[b0 + self.pi * per_host: b0 + (self.pi + 1) * per_host]
        if len(sel) < per_host:  # wrap the epoch tail
            sel = np.concatenate([sel, self.idxs[: per_host - len(sel)]])
        if self.sort_batches and "rays" in self.bank:
            order = sort_rays_spatially(self.bank["rays"][sel])
            sel = sel[order]
        return {k: v[sel] for k, v in self.bank.items()}

    def __iter__(self):
        return self.iter_from(0)

    def iter_from(self, start_step: int = 0):
        """Batch stream positioned at start_step: replays the per-epoch
        resamples a fresh run would have consumed, so a resumed run sees
        the exact same batches as an uninterrupted one."""
        for _ in range(start_step // self.batches_per_epoch):
            self.resample()
        step = start_step
        while True:
            if step % self.batches_per_epoch == 0 and step > start_step:
                self.resample()
            yield self.batch(step)
            step += 1
