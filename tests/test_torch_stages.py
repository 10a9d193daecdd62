"""The shading-cache stages of the port against the JAX package, on one
tiny dataset written by the JAX generator (16 x 20 pixels, 2 train frames
and 1 val frame, spp 4; one module fixture, so the generator compiles
once): the loaders, pixel bank and batcher, the SLF scatter, the
denoiser, bake_slf, extract_emitter, bake_shading and refine_shading with
the JAX package's draws replayed, the artifacts each package writes read
by the other, the four port CLIs end to end on the CPU, and the port's
dataset generator against the JAX one on every output it makes without
draws.

Tolerances, each stated again at its comparison: loaders, banks, batches
and artifacts exact; the SLF scatter 1e-6 (sums in another order);
denoiser 1e-5; bake_slf's radiance rtol 1e-5 and its mask exact;
bake_shading's maps rtol 1e-4; refine_shading's maps (the NGP material)
95% of values within rtol 2e-3 / atol 1e-4 (ROADMAP Queue 3: bf16 MLP
sums)."""

import argparse
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_tpu.data import datasets as jdata
from iris_tpu.data.make_demo_dataset import make_dataset as jax_make_dataset
from iris_tpu.geometry.intersect import ray_intersect as jax_intersect
from iris_tpu.models import slf as jslf
from iris_tpu.models.brdf import init_ngp_brdf, ngp_brdf_apply
from iris_tpu.models.hashgrid import HashGridConfig
from iris_tpu.pipeline import bake_shading as jbake
from iris_tpu.pipeline import common as jcommon
from iris_tpu.pipeline import extract_emitter as jextract
from iris_tpu.pipeline import refine_shading as jrefine
from iris_tpu.pipeline import slf_bake as jslf_bake
from iris_tpu.render import denoise as jden
from iris_tpu.render.integrator import (
    path_tracing_det_diff, path_tracing_det_spec,
)
from iris_tpu.utils.exr import read_exr as jax_read_exr
from iris_tpu_torch.data import datasets as tdata
from iris_tpu_torch.data.make_demo_dataset import (
    make_dataset as port_make_dataset,
)
from iris_tpu_torch.models import slf as tslf
from iris_tpu_torch.models.crf import init_emor_crf
from iris_tpu_torch.pipeline import bake_shading as tbake
from iris_tpu_torch.pipeline import common as tcommon
from iris_tpu_torch.pipeline import extract_emitter as textract
from iris_tpu_torch.pipeline import refine_shading as trefine
from iris_tpu_torch.pipeline import slf_bake as tslf_bake
from iris_tpu_torch.render import denoise as tden
from iris_tpu_torch.train.checkpoint import save_pytree
from iris_tpu_torch.utils.exr import read_exr as port_read_exr
from torch_parity import port_ngp, tt

HW = (16, 20)
GEN = dict(img_hw=HW, n_train=2, n_val=1, spp=4, indir_depth=2)
VOXELS = 16
SPP_DIFFUSE = 8
REFINE = dict(spp_d=4, spp_s=4, depth=2)
NGP_RTOL, NGP_ATOL, NGP_SHARE = 2e-3, 1e-4, 0.95
GT_RADIANCE = 10.0


def _stage_args(root):
    return ["--dataset", "synthetic", "--scene", root, "--ldr_img_dir",
            "ldr"]


def _material():
    """A 4-level x 16-feature row-mode NGP material (the production grid,
    2^10 table), its coarse level varied over the scene."""
    cfg = HashGridConfig(n_levels=4, n_features=16, log2_table_size=10,
                         per_level_scale=1.3 ** (31.0 / 3), row_gather=True)
    m = init_ngp_brdf(jax.random.PRNGKey(3), -0.1, 2.1, cfg)
    table = np.asarray(m.table).reshape(4, -1, 16).copy()
    table[0] = np.random.default_rng(5).uniform(-1, 1, table[0].shape)
    return dataclasses.replace(m, table=jnp.asarray(table.reshape(
        np.asarray(m.table).shape)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX-written dataset, the JAX stages' artifacts on it, and the
    port's four CLIs run on it on the CPU."""
    tmp = tmp_path_factory.mktemp("stages")
    root, jout, tout = (str(tmp / d) for d in ("ds", "jax", "port"))
    jax_make_dataset(root, **GEN)
    args = _stage_args(root)
    jslf_bake.main(args + ["--output", jout, "--voxel_num", str(VOXELS)])
    jextract.main(args + ["--output", jout, "--threshold", "0.99"])

    cpu = ["--device", "cpu"]
    tslf_bake.main(args + cpu + ["--output", tout, "--voxel_num",
                                 str(VOXELS)])
    textract.main(args + cpu + ["--output", tout, "--threshold", "0.99"])
    # stage 4's update, with the GT light's radiance in place of a trained
    # one: the bakes then see the light as well as the SLF
    save_pytree(f"{tout}/emitter_ckpt.pkl",
                {"radiance": torch.full((2, 3), GT_RADIANCE)})
    textract.main(args + cpu + ["--output", tout, "--mode", "update",
                                "--ckpt", f"{tout}/emitter_ckpt.pkl"])
    art = ["--slf_path", f"{tout}/vslf.npz", "--emitter_path",
           f"{tout}/emitter.npz"]
    tbake.main(args + cpu + art + ["--output", f"{tout}/bake",
                                   "--max_frames", "1", "--spp_diffuse",
                                   str(SPP_DIFFUSE)])
    material = _material()
    save_pytree(f"{tout}/material.pkl", {"material": port_ngp(material)})
    trefine.main(args + cpu + art + [
        "--output", f"{tout}/refine", "--max_frames", "1", "--ckpt",
        f"{tout}/material.pkl", "--spp_diffuse", "4", "--spp_specular", "4",
        "--indir_depth", "2"])
    return {"root": root, "jax": jout, "port": tout, "material": material}


def _load_pair(run, **kw):
    j = jdata.load_dataset("synthetic", run["root"], **kw)
    t = tdata.load_dataset("synthetic", run["root"], **kw)
    return j, t


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------- data layer

@pytest.mark.parametrize("kw", [
    dict(split="train", img_dir="ldr"),
    dict(split="val", img_dir="ldr", load_inverse=True),
    dict(split="train", load_gt=False),
], ids=["train_ldr", "val_inverse", "train_hdr"])
def test_load_dataset_frames(run, kw):
    """Every array of every frame, exact."""
    j, t = _load_pair(run, **kw)
    assert (j.n_frames, j.img_hw) == (t.n_frames, t.img_hw)
    _same(j.exposures, t.exposures)
    _same(j.crfs, t.crfs)
    for i in range(j.n_frames):
        fj, ft = j.frame(i), t.frame(i)
        assert fj.keys() == ft.keys()
        for k in fj:
            _same(fj[k], ft[k])


def test_pixel_bank_in_ram_and_on_disk(run, tmp_path, monkeypatch):
    """The bank in RAM, and past the RAM cap on disk (the JAX package
    reads the cap from IRIS_TPU_BANK_RAM_LIMIT, the port takes it as
    max_ram_bytes), exact."""
    j, t = _load_pair(run, split="train", img_dir="ldr")
    keys = ("rays", "rgbs")
    bj, bt = j.pixel_bank(keys), t.pixel_bank(keys)
    assert bj.keys() == bt.keys() == {"rays", "rgbs", "exposure"}
    for k in bj:
        _same(bj[k], bt[k])
    monkeypatch.setenv("IRIS_TPU_BANK_RAM_LIMIT", "0")
    dj = j.pixel_bank(keys, memmap_dir=str(tmp_path / "j"))
    dt = t.pixel_bank(keys, memmap_dir=str(tmp_path / "t"),
                      max_ram_bytes=0)
    for k in bj:
        assert isinstance(dt[k], np.memmap)
        _same(np.asarray(dj[k]), np.asarray(dt[k]))
        _same(bt[k], np.asarray(dt[k]))


def test_sort_rays_and_ray_batcher(run):
    j, t = _load_pair(run, split="train", img_dir="ldr")
    bank = t.pixel_bank(("rays", "rgbs"))
    _same(jdata.sort_rays_spatially(bank["rays"]),
          tdata.sort_rays_spatially(bank["rays"]))
    for sort in (True, False):
        rj = jdata.RayBatcher(bank, 96, seed=4, sort_batches=sort)
        rt = tdata.RayBatcher(bank, 96, seed=4, sort_batches=sort)
        assert rj.batches_per_epoch == rt.batches_per_epoch
        it_j, it_t = iter(rj), iter(rt)
        for _ in range(9):       # past an epoch's end: a resample
            bj, bt = next(it_j), next(it_t)
            for k in bj:
                _same(bj[k], bt[k])
        # a resumed stream replays the epochs it skipped
        it_j, it_t = rj.iter_from(11), rt.iter_from(11)
        for _ in range(3):
            bj, bt = next(it_j), next(it_t)
            for k in bj:
                _same(bj[k], bt[k])


# ---------------------------------------------------------- SLF, denoiser

def test_slf_scatter_add_and_finalize_mean():
    """Sums per voxel in another order than the JAX package's: 1e-6."""
    rng = np.random.default_rng(0)
    mask = rng.uniform(size=(6, 6, 6)) < 0.4
    x = rng.uniform(-0.2, 1.2, (500, 3)).astype(np.float32)
    rad = rng.uniform(0, 2, (500, 3)).astype(np.float32)
    keep = rng.uniform(size=500) < 0.8
    js = jslf.init_voxel_slf(mask, -0.1, 1.1)
    ts = tslf.init_voxel_slf(mask, -0.1, 1.1, device="cpu")
    for _ in range(2):
        js = jslf.slf_scatter_add(js, jnp.asarray(x), jnp.asarray(rad),
                                  jnp.asarray(keep))
        ts = tslf.slf_scatter_add(ts, tt(x), tt(rad), tt(keep, torch.bool))
    np.testing.assert_allclose(ts.count.numpy(), np.asarray(js.count),
                               rtol=0, atol=0)
    np.testing.assert_allclose(ts.radiance.numpy(), np.asarray(js.radiance),
                               rtol=1e-6, atol=1e-6)
    jf, tf = jslf.slf_finalize_mean(js), tslf.slf_finalize_mean(ts)
    np.testing.assert_allclose(tf.radiance.numpy(), np.asarray(jf.radiance),
                               rtol=1e-6, atol=1e-6)
    assert float(tf.radiance.max()) > 0


def _noisy_frame(seed):
    rng = np.random.default_rng(seed)
    h, w = 23, 31
    img = rng.gamma(0.5, 1.0, (h, w, 3)).astype(np.float32)
    nrm = rng.normal(size=(h, w, 3)).astype(np.float32)
    nrm[: h // 2] = [0.0, 0.0, 1.0]
    alb = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    mask = rng.uniform(size=(h, w)) < 0.85
    img[~mask] = 0.0
    return img, nrm, alb, mask


@pytest.mark.parametrize("guides", ["none", "normal", "normal_albedo"])
@pytest.mark.parametrize("masked", [False, True])
def test_atrous_denoise(guides, masked):
    """The filter with wrap-around borders (jnp.roll / torch.roll): 1e-5."""
    img, nrm, alb, mask = _noisy_frame(1)
    n = None if guides == "none" else nrm
    a = alb if guides == "normal_albedo" else None
    m = mask if masked else None
    want = jden.atrous_denoise(
        jnp.asarray(img), 3, 0.4, None if n is None else jnp.asarray(n),
        None if a is None else jnp.asarray(a),
        mask=None if m is None else jnp.asarray(m))
    got = tden.atrous_denoise(
        tt(img), 3, 0.4, None if n is None else tt(n),
        None if a is None else tt(a),
        mask=None if m is None else tt(m, torch.bool))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("guides", [False, True])
def test_denoise_hdr(guides):
    """The wrapper with its noise estimate (scipy, host): 1e-5."""
    img, nrm, alb, mask = _noisy_frame(2)
    kw = dict(normal=nrm, albedo=alb) if guides else {}
    want = jden.denoise_hdr(img, mask=mask, **kw)
    got = tden.denoise_hdr(img, mask=mask, device="cpu", **kw)
    assert np.abs(got - img).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- stages

def test_bake_slf(run):
    """The CLIs' vslf.npz: mask and counts exact, radiance rtol 1e-5 (sums
    in another order), bounds within 1e-6 (the first-hit positions o + t*d
    round apart by an ulp: XLA may fuse the product and the sum)."""
    zj = np.load(os.path.join(run["jax"], "vslf.npz"))
    zt = np.load(os.path.join(run["port"], "vslf.npz"))
    assert sorted(zj.files) == sorted(zt.files)
    for k in ("mask", "count"):
        _same(zj[k], zt[k])
    for k in ("voxel_min", "voxel_max"):
        np.testing.assert_allclose(zt[k], zj[k], rtol=0, atol=1e-6)
    assert zt["mask"].sum() > 0 and zt["radiance"].max() > 0
    np.testing.assert_allclose(zt["radiance"], zj["radiance"], rtol=1e-5,
                               atol=1e-7)


@dataclasses.dataclass
class _Args:
    scene: str
    dataset: str = "synthetic"
    dataset_root: str | None = None
    ldr_img_dir: str = "ldr"
    res_scale: float = 1.0


def test_bake_slf_twice_is_the_same_bits(run):
    """The segment sums fix the order of every addition."""
    _, dataset = tcommon.stage_dataset(_Args(run["root"]))
    _, tracer = tcommon.load_scene("synthetic", run["root"], device="cpu")
    crf = init_emor_crf(dim=11, device="cpu")
    (a, ma), (b, mb) = (tslf_bake.bake_slf(tracer, dataset, crf, VOXELS,
                                           log=lambda *_: None)
                        for _ in range(2))
    _same(ma, mb)
    assert torch.equal(a.radiance, b.radiance)
    assert torch.equal(a.count, b.count)


def test_extract_emitter(run):
    """extract_emitter: the mask exact (the GT quad, the last two faces),
    the geometry of the masked faces to 1e-6. (The port's emitter.npz has
    since had its radiance updated.)"""
    zj = np.load(os.path.join(run["jax"], "emitter.npz"))
    zt = np.load(os.path.join(run["port"], "emitter.npz"))
    _same(zj["is_emitter"], zt["is_emitter"])
    assert np.flatnonzero(zt["is_emitter"]).tolist() == [
        len(zt["is_emitter"]) - 2, len(zt["is_emitter"]) - 1]
    for k in ("emitter_vertices", "emitter_area", "emitter_normal"):
        np.testing.assert_allclose(zt[k], zj[k], rtol=1e-6, atol=1e-7)


def _scene_pair(run, art_dir):
    """Each package's tracer and emitter from the same artifact files, and
    the first train frame's rays twice: with unit directions (what the
    port's bakes make of them) and as the dataset gives them."""
    jmesh, jtracer = jcommon.load_scene("synthetic", run["root"])
    jv, _ = jcommon.load_vslf(os.path.join(art_dir, "vslf.npz"))
    jem = jcommon.load_emitter(os.path.join(art_dir, "emitter.npz"), jmesh,
                               slf=jv)
    tmesh, ttracer = tcommon.load_scene("synthetic", run["root"],
                                        device="cpu")
    tv, _ = tcommon.load_vslf(os.path.join(art_dir, "vslf.npz"),
                              device="cpu")
    tem = tcommon.load_emitter(os.path.join(art_dir, "emitter.npz"), tmesh,
                               slf=tv, device="cpu")
    raw = jdata.load_dataset("synthetic", run["root"], split="train",
                             img_dir="ldr", load_gt=False).frame(0)["rays"]
    # unit directions: the port's bakes take the view direction as a unit
    # vector (ROADMAP Queue 3), so the JAX package gets the rays the port
    # normalizes; the port gets the dataset's rays, as its CLIs do
    rays = raw.copy()
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=-1, keepdims=True)
    # the GT light's radiance, as train_emitter would leave it: with the
    # zero radiance extract_emitter writes only the SLF would shade
    jem = dataclasses.replace(jem, radiance=jnp.full(jem.radiance.shape,
                                                     10.0))
    tem = dataclasses.replace(tem, radiance=torch.full(tem.radiance.shape,
                                                       10.0))
    return (jtracer, jem), (ttracer, tem), rays, raw


# The sharpest roughness level (0.02: alpha^2 = 1.6e-7) samples its half
# vector through 1 - u(1 - alpha^2) (brdf.py:53), which cancels for u near
# 1. XLA fuses the product and the sum into one rounding, PyTorch rounds
# twice: a third of the sampled directions differ by up to 7e-4, enough to
# move a secondary hit into the next voxel in a few percent of pixels. That
# level's maps are held to 90% of their values within the map's tolerance
# and their mean within 1%; every other map is held in full.
_SHARP_SHARE = 0.90


def _hold(got, want, rtol, atol, share):
    close = np.abs(got - want) <= atol + rtol * np.abs(want)
    assert close.mean() >= share, (close.mean(), np.abs(got - want).max())
    if share < NGP_SHARE:
        np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-2)


_BAKE_BUDGET = 64 * 128     # rays a bake chunk: several chunks a map


def _jax_bake(jt, je, rays):
    return jbake._bake_maps_for_frame(jt, je, rays, HW,
                                      spp_diffuse=SPP_DIFFUSE,
                                      chunk_rays=_BAKE_BUDGET,
                                      key=jax.random.PRNGKey(0))


def _port_bake(tt_, te, raw):
    """The port's _bake_maps_for_frame on the dataset's rays, fed the JAX
    keys' uniforms (PRNGKey(0), as _jax_bake) chunk by chunk."""
    n = raw.shape[0]
    key = jax.random.PRNGKey(0)

    def draws(level, c):
        spp = (SPP_DIFFUSE if level == tbake.DIFFUSE
               else tbake.SPP_SPECULAR[level])
        batch = tbake.chunk_batch(n, spp, _BAKE_BUDGET)
        return tt(np.asarray(jax.random.uniform(
            jax.random.fold_in(key, c), (batch * spp, 2))))

    return tbake._bake_maps_for_frame(tt_, te, tt(raw), HW,
                                      spp_diffuse=SPP_DIFFUSE,
                                      chunk_rays=_BAKE_BUDGET, draws=draws)


@pytest.fixture(scope="module")
def bakes(run):
    """The port's bake on the dataset's rays; the JAX package's on the
    unit rays and on the dataset's rays."""
    (jt, je), (tt_, te), rays, raw = _scene_pair(run, run["jax"])
    return {"port": _port_bake(tt_, te, raw),
            "jax_unit": _jax_bake(jt, je, rays),
            "jax_raw": _jax_bake(jt, je, raw), "raw": raw}


def test_bake_shading_with_replayed_draws(bakes):
    """_bake_maps_for_frame of both packages on the JAX package's
    artifacts, the port fed the JAX keys' uniforms chunk by chunk: every
    map within rtol 1e-4 (denoised maps included), the sharpest level's
    two maps as _SHARP_SHARE says. The port takes the dataset's rays, as
    its CLI does; the JAX package the unit rays the port makes of them. A
    small ray budget cuts several chunks, the last of each map short."""
    n = bakes["raw"].shape[0]
    plan = tbake.chunk_plan(n, SPP_DIFFUSE, chunk_rays=_BAKE_BUDGET)
    assert [p[2] for p in plan] == [1, 3, 5, 5, 5, 5, 5]
    got, want = bakes["port"], bakes["jax_unit"]
    for name in ("diffuse", "specular0", "specular1"):
        g_maps, w_maps = got[name], want[name]
        if name == "diffuse":
            g_maps, w_maps = [g_maps], [w_maps]
        for level, (g, w) in enumerate(zip(g_maps, w_maps)):
            assert g.shape == (*HW, 3)
            if name != "diffuse" and level == 0:
                _hold(g, np.asarray(w), 1e-4, 1e-6, _SHARP_SHARE)
            else:
                np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                           atol=1e-6)
    assert want["diffuse"].max() > 0


def test_bake_shading_on_the_dataset_rays_against_jax(bakes):
    """The JAX package's bake on the dataset's rays, whose directions are
    not unit (|d| up to 1.34 at a corner of the 70 degree frame), against
    the port's on the same rays. The diffuse map takes no view direction:
    rtol 1e-4. Every specular map takes it through the half vector, so
    the two packages part there: the JAX package's second Fresnel map goes
    below 0 at roughness 0.02 (its v.h passes 1), where the port's every
    map is >= 0. The port's maps are the JAX package's on unit rays
    (test_bake_shading_with_replayed_draws)."""
    got, want = bakes["port"], bakes["jax_raw"]
    np.testing.assert_allclose(got["diffuse"], np.asarray(want["diffuse"]),
                               rtol=1e-4, atol=1e-6)
    norm = np.linalg.norm(bakes["raw"][:, 3:6], axis=-1)
    assert norm.max() > 1.2
    assert float(np.asarray(want["specular1"][0]).min()) < 0
    for name in ("specular0", "specular1"):
        for level, (g, w) in enumerate(zip(got[name], want[name])):
            assert (g >= 0).all(), (name, level)
            if level > 0:
                # the gap is the view direction's length: more than the
                # rtol 1e-4 that unit rays are held to
                assert not np.allclose(g, np.asarray(w), rtol=1e-4,
                                       atol=1e-6), (name, level)


def _jax_det_draws(k, n, depth):
    """What path_tracing_det_* draws from key k for n paths under the
    exact encode (integrator.py:338, :210, :93-97): its samples dict."""
    k_s, k_ind = jax.random.split(k)
    per = []
    for kk in jax.random.split(k_ind, depth):
        k1, k2, k3, k4 = jax.random.split(kk, 4)
        per.append({"s1": jax.random.uniform(k1, (n,)),
                    "s2": jax.random.uniform(k2, (n, 2)),
                    "s1b": jax.random.uniform(k3, (n,)),
                    "s2b": jax.random.uniform(k4, (n, 2))})
    return {"det_s2": tt(np.asarray(jax.random.uniform(k_s, (n, 2)))),
            "indirect": {k: tt(np.stack([np.asarray(p[k]) for p in per]))
                         for k in per[0]}}


def test_refine_shading_with_replayed_draws(run):
    """refine_shading's chunked det path, JAX's composition
    (refine_shading.py:33-50, :122-175) against the port's refine_frame
    fed the JAX keys' uniforms: 95% of every map's values within rtol
    2e-3 / atol 1e-4 (the NGP material), the sharpest level's two maps as
    _SHARP_SHARE says. A small path budget cuts three chunks a map, the
    last one short."""
    (jt, je), (pt, pe), rays, raw = _scene_pair(run, run["jax"])
    material = run["material"]
    spp_d, spp_s, depth = REFINE["spp_d"], REFINE["spp_s"], REFINE["depth"]
    budget = 128 * spp_d
    n = rays.shape[0]
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    mat_fn = lambda p: ngp_brdf_apply(material, p)  # noqa: E731
    pos, nrm, uv, tri, valid = jax.jit(
        lambda x, d: jax_intersect(jt, x, d))(
        jnp.asarray(rays[:, :3]), jnp.asarray(rays[:, 3:6]))
    hits = [np.asarray(x) for x in (pos, rays[:, 3:6], nrm, uv, tri)]
    nrm_hw = hits[2].reshape(*HW, 3)
    mask_hw = np.asarray(valid).reshape(HW)
    chunk_d = trefine.chunk_pixels(n, spp_d, budget)
    chunk_s = trefine.chunk_pixels(n, spp_s, budget)
    assert -(-n // chunk_d) == 3 and n % chunk_d

    diff_jit = jax.jit(lambda p, wi, nr, uv_, tri_, k: path_tracing_det_diff(
        k, jt, je, mat_fn, p, wi, nr, uv_, tri_, spp_d, depth))
    spec_jit = jax.jit(lambda p, wi, nr, uv_, tri_, k, rv:
                       path_tracing_det_spec(k, jt, je, mat_fn, rv, p, wi,
                                             nr, uv_, tri_, spp_s, depth))

    def den(x):
        return jden.denoise_hdr(x.reshape(*HW, 3), normal=nrm_hw,
                                mask=mask_hw)

    (ld,) = jrefine._chunked_det(diff_jit, *hits, chunk_d, 1, key)
    want = [den(ld)]
    for r_idx, rough in enumerate(trefine.ROUGHNESS_LEVELS):
        l0, l1 = jrefine._chunked_det(
            lambda *a, rv=float(rough): spec_jit(*a, jnp.float32(rv)),
            *hits, chunk_s, 2, jax.random.fold_in(key, 7 + r_idx))
        want += [den(l0), den(l1)]

    def samples(level, c):
        if level == trefine.DIFFUSE:
            return _jax_det_draws(jax.random.fold_in(key, c),
                                  chunk_d * spp_d, depth)
        return _jax_det_draws(jax.random.fold_in(
            jax.random.fold_in(key, 7 + level), c), chunk_s * spp_s, depth)

    make = trefine.make_mat_fn_factory(port_ngp(material), "exact")
    got = trefine.refine_frame(pt, pe, make, tt(raw), HW, spp_d, spp_s,
                               depth, samples=samples, chunk_paths=budget)
    got = [got["diffuse"]] + [m for pair in zip(got["specular0"],
                                                got["specular1"])
                              for m in pair]
    assert np.abs(want[0]).max() > 0
    for i, (g, w) in enumerate(zip(got, want)):
        share = _SHARP_SHARE if i in (1, 2) else NGP_SHARE
        _hold(g, w, NGP_RTOL, NGP_ATOL, share)


def test_refine_stochastic_encode(run):
    """--encode stoch: finite maps, and every material call of a chunk
    draws the same corners (one seed a chunk, as JAX reuses its key), so
    two calls on the same points agree; over many seeds the estimate's
    mean approaches the exact encode's (unbiased)."""
    (_, _), (pt, pe), _, raw = _scene_pair(run, run["jax"])
    material = port_ngp(run["material"])
    make = trefine.make_mat_fn_factory(material, "stoch")
    exact = trefine.make_mat_fn_factory(material, "exact")(0)
    pts = tt(np.random.default_rng(1).uniform(0, 2, (4096, 3)))
    f = make(123)
    a, b = f(pts), f(pts)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(make(124)(pts)["albedo"], a["albedo"])
    mean = sum(make(s)(pts)["albedo"] for s in range(64)) / 64
    want = exact(pts)["albedo"]
    # 64 one-corner draws against the exact trilinear blend, through the
    # MLP: the mean's error shrinks as 1/sqrt(64)
    assert float((mean - want).abs().mean()) < float(
        (a["albedo"] - want).abs().mean())
    maps = trefine.refine_frame(pt, pe, make, tt(raw), HW, 4, 4, 2,
                                denoise=False)
    for m in [maps["diffuse"]] + maps["specular0"] + maps["specular1"]:
        assert np.isfinite(m).all() and (m >= 0).all()


# ---------------------------------------------- artifacts across packages

def test_artifacts_read_across(run):
    """Each package's vslf.npz and emitter.npz load in the other equal;
    the port's baked EXRs read equal in both and, as a shading cache
    (cache_dir), give both loaders the same frames."""
    for src in (run["jax"], run["port"]):
        jv, jm = jcommon.load_vslf(os.path.join(src, "vslf.npz"))
        tv, tm = tcommon.load_vslf(os.path.join(src, "vslf.npz"),
                                   device="cpu")
        _same(jm, tm)
        _same(np.asarray(jv.inds), tv.inds.numpy().astype(np.int32))
        _same(np.asarray(jv.radiance), tv.radiance.numpy())
        _same(np.asarray(jv.count), tv.count.numpy())
        assert float(jv.voxel_min) == float(tv.voxel_min)
        jmesh, _ = jcommon.load_scene("synthetic", run["root"])
        je = jcommon.load_emitter(os.path.join(src, "emitter.npz"), jmesh)
        te = tcommon.load_emitter(os.path.join(src, "emitter.npz"), jmesh,
                                  device="cpu")
        _same(np.asarray(je.is_emitter), te.is_emitter.numpy())
        _same(np.asarray(je.radiance), te.radiance.numpy())
    for stage in ("bake", "refine"):
        d = os.path.join(run["port"], stage)
        names = sorted(os.listdir(os.path.join(d, "specular")))
        assert os.listdir(os.path.join(d, "diffuse")) == ["000.exr"]
        assert names == sorted(f"000_{f}_{r}.exr" for f in (0, 1)
                               for r in range(6))
        for p in [os.path.join(d, "diffuse", "000.exr")] + [
                os.path.join(d, "specular", x) for x in names]:
            a, b = port_read_exr(p), jax_read_exr(p)
            _same(a, b)
            assert a.shape == (*HW, 3) and np.isfinite(a).all()
            assert (a >= 0).all()
        j = jdata.SyntheticDataset(run["root"], img_dir="ldr",
                                   load_gt=False, cache_dir=d)
        t = tdata.SyntheticDataset(run["root"], img_dir="ldr",
                                   load_gt=False, cache_dir=d)
        fj, ft = j.frame(0), t.frame(0)
        for k in ("diffuse", "specular0", "specular1"):
            _same(fj[k], ft[k])


def test_port_clis_write_what_the_next_stages_read(run):
    """The four port CLIs ran end to end on the CPU (the fixture), the
    update mode copied the checkpoint's radiance into emitter.npz, and the
    bakes saw the light."""
    out = run["port"]
    z = np.load(os.path.join(out, "vslf.npz"))
    assert z["mask"].shape == (VOXELS,) * 3
    assert np.isfinite(z["radiance"]).all()
    z = np.load(os.path.join(out, "emitter.npz"))
    _same(z["emitter_radiance"], np.full((2, 3), GT_RADIANCE, np.float32))
    assert z["is_emitter"].sum() == 2
    for stage in ("bake", "refine"):
        assert port_read_exr(os.path.join(out, stage, "diffuse",
                                          "000.exr")).max() > 0


@pytest.mark.parametrize("argv", [
    [],
    ["--hash_levels", "32", "--hash_features", "2"],
    ["--hash_levels", "8", "--hash_features", "8", "--bwd_level_sample",
     "0", "--stochastic_fwd", "0", "--per_level_scale", "1.4"],
], ids=["production", "reference", "custom"])
def test_config_and_common_helpers(run, argv, tmp_path):
    """pipeline/config.py parses to the same options; build_material makes
    the same HashGridConfig and table shape; adopt_estimator_cfg carries a
    stage's estimator flags into every material of a tree and keeps the
    model's own fields; make_dataset and ckpt_path agree."""
    from iris_tpu.pipeline import config as jconfig
    from iris_tpu_torch.pipeline import config as tconfig

    base = ["--dataset", "synthetic", run["root"], "--ldr_img_dir", "ldr",
            "--log2_hashmap_size", "8"]
    ja = jconfig.add_model_specific_args().parse_args(base + argv)
    ta = tconfig.add_model_specific_args().parse_args(base + argv)
    assert vars(ja) == vars(ta)
    jm = jcommon.build_material(ja, -0.1, 2.1)
    tm = tcommon.build_material(ta, -0.1, 2.1, device="cpu")
    assert dataclasses.asdict(jm.cfg) == dataclasses.asdict(tm.cfg)
    assert tm.table.numel() == np.asarray(jm.table).size
    other = argparse.Namespace(**{**vars(ta), "stochastic_bwd": 0,
                                  "bwd_level_sample": 0})
    tree = tcommon.adopt_estimator_cfg({"material": tm, "w": [tm]}, other)
    want = jcommon.adopt_estimator_cfg({"material": jm}, other)
    for m in (tree["material"], tree["w"][0]):
        assert dataclasses.asdict(m.cfg) == dataclasses.asdict(
            want["material"].cfg)
        assert m.table is tm.table
    dj = jcommon.make_dataset(ja, "val")
    dt = tcommon.make_dataset(ta, "val")
    for k, v in dj.frame(0).items():
        _same(v, dt.frame(0)[k])
    assert (tcommon.ckpt_path(str(tmp_path), "e")
            == jcommon.ckpt_path(str(tmp_path), "e"))


# ------------------------------------------------------- the generator

def test_make_dataset_draw_free_outputs(run, tmp_path):
    """The port's generator against the JAX one's files: the mesh,
    cameras, CRF and exposure files exact, and the GT maps (which take no
    draws) exact."""
    root = str(tmp_path / "port_ds")
    port_make_dataset(root, device="cpu", **GEN)
    with open(os.path.join(root, "scene.obj")) as f, \
            open(os.path.join(run["root"], "scene.obj")) as g:
        assert f.read() == g.read()
    for split in ("train", "val"):
        a, b = (os.path.join(r, split) for r in (root, run["root"]))
        with open(os.path.join(a, "transforms.json")) as f, \
                open(os.path.join(b, "transforms.json")) as g:
            assert json.load(f) == json.load(g)
        for name in ("exposure", "crf"):
            _same(np.load(os.path.join(a, "ldr", "cam", f"{name}.npy")),
                  np.load(os.path.join(b, "ldr", "cam", f"{name}.npy")))
        n = 2 if split == "train" else 1
        for i in range(n):
            for sub, name in (("DiffCol", f"{i:03d}_0001"),
                              ("Roughness", f"{i:03d}_0001"),
                              ("Emit", f"{i:03d}_0001"),
                              ("IndexMA", f"{i:03d}_0001"),
                              ("segmentation", f"{i:03d}")):
                _same(port_read_exr(os.path.join(a, sub, name + ".exr")),
                      port_read_exr(os.path.join(b, sub, name + ".exr")))
            hdr = port_read_exr(os.path.join(a, "Image",
                                             f"{i:03d}_0001.exr"))
            assert np.isfinite(hdr).all() and hdr.max() > 0
