"""The cameras of the port's dataset generator (data/make_demo_dataset.py):
past 8 frames both packages search an orbit clear of clutter, and the
port's `orbit` option runs that search at any frame count, for the dense
clutter scenes whose fixed cameras sit inside boxes.

Tolerances: the cameras (transforms.json) and the mesh exact."""

import json
import os

import numpy as np
import torch

from iris_tpu.data.make_demo_dataset import make_dataset as jax_make_dataset
from iris_tpu_torch.data.make_demo_dataset import (
    FIXED_CAMERAS, _camera_pose, _orbit_cameras, make_dataset,
)
from iris_tpu_torch.data.rays import (
    get_ray_directions_blender, get_rays_blender,
)
from iris_tpu_torch.geometry.bvh import build_bvh
from iris_tpu_torch.geometry.intersect import ray_intersect
from iris_tpu_torch.geometry.procedural import make_box_scene

# the smallest render that writes every file: 4 x 4 pixels, spp 1
TINY = dict(img_hw=(4, 4), spp=1, indir_depth=1)


def _cameras(root, split):
    with open(os.path.join(root, split, "transforms.json")) as f:
        return json.load(f)


def test_orbit_cameras_against_jax_past_eight_frames(tmp_path):
    """9 frames: both generators leave the fixed list for the orbit
    search (its draws are numpy's, its probes the tracer's), and write
    the same cameras and mesh."""
    roots = [str(tmp_path / "jax"), str(tmp_path / "port")]
    jax_make_dataset(roots[0], n_train=8, n_val=1, **TINY)
    make_dataset(roots[1], n_train=8, n_val=1, device="cpu", **TINY)
    with open(os.path.join(roots[0], "scene.obj")) as f, \
            open(os.path.join(roots[1], "scene.obj")) as g:
        assert f.read() == g.read()
    for split in ("train", "val"):
        assert _cameras(roots[0], split) == _cameras(roots[1], split)


def _first_hit_distance(tracer, c2w, hw=(12, 16)):
    """Median distance from the camera to its first hits on a coarse
    grid of the frame's pixels."""
    h, w = hw
    focal = 0.5 * w / np.tan(np.radians(70.0) / 2)
    o, d, _, _ = get_rays_blender(get_ray_directions_blender(h, w, focal),
                                  np.asarray(c2w, np.float32)[:3], focal)
    pos, _, _, _, valid = ray_intersect(tracer, torch.from_numpy(o),
                                        torch.from_numpy(d))
    dist = np.linalg.norm(pos.numpy() - o, axis=-1)[valid.numpy()]
    return float(np.median(dist)) if dist.size else 0.0


def test_orbit_search_clears_dense_clutter():
    """8,500 boxes (102,014 faces) fill the room: the first three fixed
    cameras sit inside boxes (first hits within 0.02), while the orbit
    search places three cameras where the view reaches past 0.2."""
    mesh, _ = make_box_scene(n_clutter=8500, seed=0)
    tracer = build_bvh(mesh.triangles(), device="cpu")
    orbit = _orbit_cameras(tracer, 3, 0, torch.device("cpu"))
    for cams, inside in ((FIXED_CAMERAS[:3], True), (orbit, False)):
        for c, look in cams:
            dist = _first_hit_distance(tracer, _camera_pose(c, look))
            assert (dist < 0.02) if inside else (dist > 0.2), (c, dist)


def test_orbit_option_writes_the_orbit_cameras(tmp_path):
    """make_dataset(orbit=True) at 3 frames writes the orbit search's
    cameras, in order, where the default writes the fixed list."""
    mesh, _ = make_box_scene(n_clutter=4, seed=0)
    tracer = build_bvh(mesh.triangles(), device="cpu")
    for orbit in (False, True):
        root = str(tmp_path / str(orbit))
        make_dataset(root, n_train=2, n_val=1, orbit=orbit, device="cpu",
                     **TINY)
        cams = (_orbit_cameras(tracer, 3, 0, torch.device("cpu")) if orbit
                else FIXED_CAMERAS[:3])
        frames = (_cameras(root, "train")["frames"]
                  + _cameras(root, "val")["frames"])
        assert len(frames) == 3
        for frame, (c, look) in zip(frames, cams):
            want = np.vstack([_camera_pose(c, look), [0, 0, 0, 1]])
            assert frame["transform_matrix"] == want.tolist()
