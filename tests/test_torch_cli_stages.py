"""The slf_refine and render stage CLIs of the PyTorch port on the tiny
dataset (the port's generator, 16 x 20): slf_refine against the JAX
package's on the same dataset, SLF and CRF weights; render.main's files
under the JAX package's names, its metrics.txt, and the metrics against
the JAX package's utils/metrics.py.

Tolerances: the SLF mask and counts equal, the radiance rtol 1e-5 (the two
packages' first-hit positions can round an ulp apart); PSNR and SSIM 1e-12
on the same images (the port's copy of the same numpy code)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_tpu.pipeline import slf_refine as jslf_refine
from iris_tpu.train.checkpoint import save_pytree as jax_save_pytree
from iris_tpu.utils import metrics as jmetrics
from iris_tpu_torch.pipeline import render, slf_refine
from iris_tpu_torch.pipeline.common import build_material
from iris_tpu_torch.pipeline.config import add_model_specific_args
from iris_tpu_torch.train.checkpoint import save_pytree
from iris_tpu_torch.utils import metrics
from torch_parity import CLI_TRAIN, write_cli_dataset


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stages"))
    return root, *write_cli_dataset(root)


def test_slf_refine_matches_jax(data, tmp_path):
    root, ds, bake = data
    w = np.random.default_rng(4).normal(0, 0.1, (3, 3)).astype(np.float32)
    jax_ckpt, port_ckpt = str(tmp_path / "j.pkl"), str(tmp_path / "p.pkl")
    jax_save_pytree(jax_ckpt, {"crf_weight": jnp.asarray(w)})
    save_pytree(port_ckpt, {"crf_weight": torch.from_numpy(w)})
    args = ["--dataset", "synthetic", "--scene", ds, "--ldr_img_dir", "ldr",
            "--output", bake, "--crf_basis", "3"]
    jslf_refine.main(args + ["--ckpt", jax_ckpt, "--save", "jax_0.npz"])
    slf_refine.main(args + ["--ckpt", port_ckpt, "--save", "port_0.npz",
                            "--device", "cpu"])
    slf_refine.main(args + ["--ckpt", port_ckpt, "--save", "port_1.npz",
                            "--device", "cpu"])
    j, p, q = (np.load(os.path.join(bake, n)) for n in (
        "jax_0.npz", "port_0.npz", "port_1.npz"))
    assert sorted(p.files) == sorted(j.files)
    assert p["mask"].any()
    for k in ("mask", "voxel_min", "voxel_max", "count"):
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    np.testing.assert_allclose(p["radiance"], j["radiance"], rtol=1e-5,
                               atol=1e-7)
    assert float(p["radiance"].max()) > 0
    # the same bits twice
    for k in p.files:
        np.testing.assert_array_equal(p[k], q[k], err_msg=k)
    # the learned CRF moved the radiance away from the first bake's
    assert not np.allclose(p["radiance"],
                           np.load(os.path.join(bake, "vslf.npz"))[
                               "radiance"])


def test_render_cli_writes_every_file(data, tmp_path, monkeypatch):
    """render.main on the val frame: every EXR and PNG under the JAX
    package's names, and metrics.txt with the frame's and the mean PSNR
    and SSIM (one frame: the mean is the frame's), finite."""
    root, ds, bake = data
    monkeypatch.chdir(tmp_path)
    z = np.load(os.path.join(bake, "vslf.npz"))
    args = add_model_specific_args().parse_args(
        ["--hash_levels", "4", "--log2_hashmap_size", "10"])
    ngp = build_material(args, float(z["voxel_min"]), float(z["voxel_max"]),
                         device="cpu")
    os.makedirs(os.path.join("checkpoints", "x"))
    save_pytree(os.path.join("checkpoints", "x", "last.pkl"),
                {"material": ngp, "radiance": torch.full((2, 3), 10.0)})
    render.main(["--dataset", "synthetic", ds, "--ldr_img_dir", "ldr",
                 "--experiment_name", "x", "--emitter_path", bake,
                 "--output_path", "out", "--SPP", "4", "--spp", "2",
                 "--indir_depth", "2", "--device", "cpu"])
    want = {"rgb": ["00000_rgb_full.exr", "00000_rgb_full.png",
                    "metrics.txt"],
            "diffuse": ["00000_diffuse.exr", "00000_diffuse.png"],
            "a_prime": ["00000_a_prime.exr", "00000_a_prime.png"],
            "roughness": ["00000_roughness.exr",
                          "00000_roughness_color.png"],
            "metallic": ["00000_metallic.exr", "00000_metallic_color.png"],
            "emission": ["00000.png", "00000_emission.exr"],
            "slf": ["00000_slf.exr"], "merge": ["00000_merge.png"]}
    assert sorted(os.listdir(os.path.join("out", "val"))) == sorted(want)
    for sub, names in want.items():
        assert sorted(os.listdir(os.path.join("out", "val", sub))) == \
            sorted(names), sub
    with open(os.path.join("out", "val", "rgb", "metrics.txt")) as f:
        lines = f.read().splitlines()
    assert lines[0] == "Name, PSNR, SSIM" and len(lines) == 3
    assert lines[1].startswith("00000, ") and lines[2].startswith("mean , ")
    vals = [float(x) for ln in lines[1:] for x in ln.split(",")[1:]]
    assert all(np.isfinite(vals)) and vals[:2] == vals[2:]


@pytest.mark.parametrize("shape", [(16, 20, 3), (31, 9, 3), (12, 12)])
def test_metrics_equal_the_jax_package(shape):
    """psnr and ssim of the port's copy against the JAX package's
    utils/metrics.py on the same images: 1e-12."""
    rng = np.random.default_rng(len(shape) * 7 + shape[0])
    gt = rng.uniform(0, 1, shape)
    pred = np.clip(gt + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    assert abs(metrics.psnr(gt, pred) - jmetrics.psnr(gt, pred)) <= 1e-12
    assert abs(metrics.ssim(gt, pred) - jmetrics.ssim(gt, pred)) <= 1e-12
    assert metrics.psnr(gt, gt) == float("inf")
