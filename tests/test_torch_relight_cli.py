"""The relight and video CLIs of the PyTorch port against the JAX
package's (iris_tpu/pipeline/render_relight.py, render_video.py): the YAML
translation on every config under scripts/relight/ (the same dicts, the
same triangle bits), trajectory_rays bit for bit with and without a
render_traj.npy, and each CLI's file names and frame counts on a 24 x 32
dataset of the port's generator (their images draw from different
generators, torch's and threefry, so only the files are compared; the
integrator itself is held in test_torch_relight.py)."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch
import yaml

from iris_tpu.data.datasets import load_dataset as jax_load_dataset
from iris_tpu.models.brdf import init_ngp_brdf
from iris_tpu.models.crf import init_emor_crf as jax_init_crf
from iris_tpu.models.hashgrid import HashGridConfig
from iris_tpu.pipeline import render_relight as jrr
from iris_tpu.pipeline import render_video as jrv
from iris_tpu.train.checkpoint import save_pytree as jax_save_pytree
from iris_tpu_torch.data.datasets import load_dataset
from iris_tpu_torch.pipeline import render_relight as trr
from iris_tpu_torch.pipeline import render_video as trv
from iris_tpu_torch.train.checkpoint import save_pytree
from torch_parity import (  # noqa: F401
    DEV, port_ngp, one_torch_thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TETRA = ("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
         "f 1 2 3\nf 1 2 4\nf 1 3 4\nf 2 3 4\n")


def _configs():
    out = []
    for dirpath, _, files in os.walk(os.path.join(REPO, "scripts",
                                                  "relight")):
        out += [os.path.join(dirpath, f) for f in files
                if f.endswith(".yaml")]
    return sorted(out)


def _same_shapes(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if k == "tris":
                assert x[k].dtype == y[k].dtype
                assert x[k].tobytes() == y[k].tobytes()
            else:
                assert x[k] == y[k], k


def test_every_config_translates_alike(monkeypatch, tmp_path):
    """shapes_from_yaml on all 22 configs: the same shape dicts, bsdfs and
    triangle bits, depth, fov and disco block. The assets that are not in
    the repository (inserted OBJs, the emitter.ply of a bake) and the
    dataset mesh are a generated OBJ."""
    asset = str(tmp_path / "asset.obj")
    with open(asset, "w") as f:
        f.write(TETRA)
    for module in (jrr, trr):
        real = module.load_mesh
        monkeypatch.setattr(
            module, "load_mesh",
            lambda p, real=real: real(p if os.path.exists(p) else asset))
    cfgs = _configs()
    assert len(cfgs) == 22
    n_disco = 0
    for p in cfgs:
        with open(p) as f:
            cfg = yaml.safe_load(f)
        want = jrr.shapes_from_yaml(cfg, asset)
        got = trr.shapes_from_yaml(cfg, asset)
        _same_shapes(got[0], want[0])
        assert got[1:] == want[1:], p
        n_disco += got[3] is not None
    assert n_disco == 3


@pytest.mark.parametrize("bsdf", [
    {"type": "twosided", "fipt_bsdf": {"type": "fipt"}},
    {"type": "conductor", "material": "Cu"},
    {"type": "conductor"},
    {"type": "roughconductor", "alpha_u": 0.05, "alpha_v": 0.3,
     "eta": {"type": "rgb", "value": [0.47, 0.35, 0.29]},
     "k": {"type": "rgb", "value": [0.332, 0.239, 0.235]}},
    {"type": "roughconductor", "alpha": 0.2},
    {"type": "diffuse", "reflectance": {"type": "rgb",
                                        "value": [0.2, 0.25, 0.7]}},
    {"type": "diffuse"},
])
def test_bsdf_from_yaml(bsdf):
    assert trr._bsdf_from_yaml(bsdf) == jrr._bsdf_from_yaml(bsdf)


# ------------------------------------------------------------- the CLIs

@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A 24 x 32 dataset (3 train frames), its SLF and emitter mask, and
    one material saved by each package."""
    from iris_tpu_torch.data.make_demo_dataset import make_dataset
    from iris_tpu_torch.models.crf import init_emor_crf
    from iris_tpu_torch.pipeline import extract_emitter, slf_bake

    root = tmp_path_factory.mktemp("relight_cli")
    ds, bake = str(root / "ds"), str(root / "bake")
    make_dataset(ds, img_hw=(24, 32), n_train=3, n_val=1, spp=4,
                 indir_depth=1, device=DEV)
    s = ["--dataset", "synthetic", "--scene", ds, "--ldr_img_dir", "ldr",
         "--device", DEV, "--output", bake]
    slf_bake.main(s + ["--voxel_num", "16"])
    extract_emitter.main(s + ["--threshold", "0.99"])
    ngp = init_ngp_brdf(jax.random.PRNGKey(0), -0.1, 2.1,
                        HashGridConfig(n_levels=4, log2_table_size=8))
    for pkg in ("jax", "port"):
        os.makedirs(root / pkg / "exp")
    jax_save_pytree(str(root / "jax" / "exp" / "last.pkl"),
                    {"material": ngp, "crf_weight": jax_init_crf(3).weight})
    save_pytree(str(root / "port" / "exp" / "last.pkl"),
                {"material": port_ngp(ngp),
                 "crf_weight": init_emor_crf(3, device=DEV).weight})
    asset = str(root / "tetra.obj")
    with open(asset, "w") as f:
        f.write(TETRA)
    return root, ds, bake, asset


def _listing(out):
    """{name: sorted names inside} of a CLI's output directory."""
    got = {}
    for n in sorted(os.listdir(out)):
        p = os.path.join(out, n)
        got[n] = sorted(os.listdir(p)) if os.path.isdir(p) else None
    return got


def _cli(module, root, pkg, argv):
    out = str(root / f"{module.__name__.split('.')[-1]}_{pkg}")
    shutil.rmtree(out, ignore_errors=True)
    module.main(argv + ["--checkpoint_path", str(root / pkg),
                        "--output_path", out]
                + (["--device", DEV] if pkg == "port" else []))
    return _listing(out)


INSERT = """
type: 'scene'
Integrator: {{type: 'path', max_depth: {depth}}}
main_scene:
  type: 'obj'
  filename: ''
  bsdf: {{type: 'twosided', fipt_bsdf: {{type: 'fipt'}}}}
light_ball:
  type: 'sphere'
  to_world:
    - {{type: 'translate', value: [0.6, 0.6, 1.2]}}
    - {{type: 'scale', value: [0.1, 0.1, 0.1]}}
  bsdf: {{type: 'diffuse', reflectance: {{type: 'rgb', value: [0, 0, 0]}}}}
  emitter: {{type: 'area', radiance: {{type: 'rgb', value: [25, 25, 25]}}}}
spot:
  type: 'obj'
  filename: '{asset}'
  to_world:
    - {{type: 'translate', value: [1.2, 1.2, 0.2]}}
    - {{type: 'scale', value: [0.3, 0.3, 0.3]}}
    - {{type: 'rotate', axis: [0, 0, 1], angle: -90}}
  bsdf: {{type: 'conductor', material: 'Au'}}
andersen:
  type: 'obj'
  filename: '{asset}'
  to_world:
    - {{type: 'translate', value: [0.4, 1.3, 0.2]}}
    - {{type: 'scale', value: [0.25, 0.25, 0.25]}}
  bsdf:
    type: 'roughconductor'
    alpha_u: 0.05
    alpha_v: 0.3
    eta: {{type: 'rgb', value: [0.47, 0.35, 0.29]}}
    k: {{type: 'rgb', value: [0.332, 0.239, 0.235]}}
"""

DISCO_BLOCK = """
disco_ball:
  T: 60
  position: [1.0, 1.0, 0.8]
  radius: 0.15
  light_intensity: 40
  light_num: 8
  spot_intensity: 0.5
  spot_cutoff_angle: 20.0
"""


def _relight_argv(ds, bake, cfg, n_frames=2, mode="traj"):
    return ["--dataset", "synthetic", ds, "--ldr_img_dir", "ldr",
            "--experiment_name", "exp", "--emitter_path", bake,
            "--light_cfg", cfg, "--mode", mode, "--n_frames", str(n_frames),
            "--SPP", "2", "--spp", "2"]


def test_render_relight_writes_the_jax_files(setup):
    """The insert-shaped config (an OBJ with a conductor and a
    roughconductor): both packages write 00000.png, 00001.png and the
    relight video (a frames directory of 2 frames here, where imageio
    has no ffmpeg plugin)."""
    root, ds, bake, asset = setup
    cfg = str(root / "insert.yaml")
    with open(cfg, "w") as f:
        f.write(INSERT.format(depth=2, asset=asset))
    argv = _relight_argv(ds, bake, cfg)
    want = _cli(jrr, root, "jax", argv)
    got = _cli(trr, root, "port", argv)
    assert got == want
    assert {"00000.png", "00001.png"} <= set(got)
    frames = got.get("relight_frames")
    assert frames is None or frames == ["00000.png", "00001.png",
                                        "INDEX.txt"]


@pytest.mark.parametrize("mode,n_frames,want_frames", [
    ("traj", 3, 2), ("train_val", 2, 3)])
def test_render_relight_disco_frames(setup, mode, n_frames, want_frames):
    """The relight_1-shaped config (the disco_ball block) on the port: the
    frame count the JAX CLI gives (traj: n_interp = n_frames // (train
    frames - 1) poses between neighbours, at most n_frames; train_val:
    every train frame), each PNG not black, the disco frames apart."""
    from PIL import Image

    root, ds, bake, asset = setup
    cfg = str(root / "disco.yaml")
    with open(cfg, "w") as f:
        f.write(INSERT.format(depth=1, asset=asset) + DISCO_BLOCK)
    got = _cli(trr, root, "port", _relight_argv(ds, bake, cfg, n_frames,
                                                mode))
    names = [f"{i:05d}.png" for i in range(want_frames)]
    assert sorted(n for n in got if n.endswith(".png")) == names
    out = str(root / "render_relight_port")
    imgs = [np.asarray(Image.open(os.path.join(out, n))) for n in names]
    assert all(im.shape == (24, 32, 3) and im.max() > 0 for im in imgs)
    assert not np.array_equal(imgs[0], imgs[1])


def _ds_pair(root):
    kw = dict(split="train", img_dir="ldr")
    return (jax_load_dataset("synthetic", root, **kw),
            load_dataset("synthetic", root, **kw))


def _same_rays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("n_interp", [1, 2, 5])
def test_trajectory_rays_interpolated(setup, n_interp):
    _, ds, _, _ = setup
    jds, tds = _ds_pair(ds)
    want = jrv.trajectory_rays(jds, n_interp)
    _same_rays(trv.trajectory_rays(tds, n_interp), want)
    assert len(want) == n_interp * (len(jds) - 1)


def test_trajectory_rays_from_render_traj(setup, tmp_path):
    """A render_traj.npy at the dataset root, and one given explicitly."""
    _, ds, _, _ = setup
    root = str(tmp_path / "ds")
    shutil.copytree(ds, root)
    jds, tds = _ds_pair(root)
    poses = np.stack([jds.frame(i)["c2w"] for i in range(len(jds))])
    rng = np.random.default_rng(1)
    poses[:, :3, 3] += rng.normal(0, 0.05, poses[:, :3, 3].shape)
    np.save(os.path.join(root, "render_traj.npy"), poses[::-1])
    want = jrv.trajectory_rays(jds, 6)
    assert len(want) == len(poses)
    _same_rays(trv.trajectory_rays(tds, 6), want)
    traj = str(tmp_path / "traj.npy")
    np.save(traj, poses[:2])
    _same_rays(trv.trajectory_rays(tds, 6, traj),
               jrv.trajectory_rays(jds, 6, traj))


def test_render_video_writes_the_jax_files(setup):
    """video and the five AOV videos, boomerang: 2 (n_interp) x 2 = 4
    frames each way, 8 in each video."""
    root, ds, bake, _ = setup
    argv = ["--dataset", "synthetic", ds, "--ldr_img_dir", "ldr",
            "--experiment_name", "exp", "--emitter_path", bake,
            "--SPP", "2", "--spp", "2", "--indir_depth", "1",
            "--n_interp", "2"]
    want = _cli(jrv, root, "jax", argv)
    got = _cli(trv, root, "port", argv)
    assert got == want
    for base in ("video", *trv.AOV_VIDEOS):
        frames = got.get(f"{base}_frames")
        assert f"{base}.mp4" in got or frames == [
            f"{i:05d}.png" for i in range(8)] + ["INDEX.txt"], (base, got)


def test_clis_default_to_the_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    root, ds, bake, asset = setup
    for module, argv in (
            (trr, _relight_argv(ds, bake, asset)),
            (trv, ["--dataset", "synthetic", ds, "--experiment_name",
                   "exp", "--emitter_path", bake])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main(argv + ["--output_path", str(root / "none")])
    assert not os.path.exists(root / "none")
