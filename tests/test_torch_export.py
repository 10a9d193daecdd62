"""The consumers of a trained scene beside rendering, PyTorch port against
the JAX package: extract_emitter_mesh (the same PLY bytes and average
radiance), the chart unwrap (the same UVs, charts and atlas), the texture
export CLI in both unwrap modes (textures within one 8-bit level on >= 95%
of texels: the two packages' bf16 MLP sums can round apart, ROADMAP
Queue 3; the UV OBJ and MTL the same text) and metric_brdf (within
1e-12)."""

import os

import jax
import numpy as np
import pytest
import torch

from iris_tpu.geometry.procedural import make_box_scene
from iris_tpu.models.brdf import init_ngp_brdf
from iris_tpu.models.hashgrid import HashGridConfig
from iris_tpu.train.checkpoint import save_pytree as jax_save_pytree
from iris_tpu.utils import export as JE
from iris_tpu.utils import extract_emitter_mesh as JX
from iris_tpu.utils import metric_brdf as JM
from iris_tpu.utils import uv_unwrap as JU
from iris_tpu_torch.geometry.mesh import save_ply
from iris_tpu_torch.train.checkpoint import save_pytree
from iris_tpu_torch.utils import export as TE
from iris_tpu_torch.utils import extract_emitter_mesh as TX
from iris_tpu_torch.utils import metric_brdf as TM
from iris_tpu_torch.utils import uv_unwrap as TU
from iris_tpu_torch.utils.exr import write_exr
from iris_tpu_torch.utils.image import open_png, save_image
from torch_parity import (  # noqa: F401
    DEV, port_ngp, one_torch_thread)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("radiance_rows", [None, 2])
def test_extract_emitter_mesh_same_bytes(tmp_path, radiance_rows):
    """The PLY bytes and the area-weighted radiance; an emitter.npz whose
    radiance has more rows than faces is cut to the faces, as in the JAX
    package."""
    rng = np.random.default_rng(0)
    k = 7
    verts = rng.uniform(0, 2, (k, 3, 3)).astype(np.float32)
    c = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    area = (np.linalg.norm(c, axis=-1) / 2).astype(np.float32)
    rad = rng.uniform(0, 10, (k + (radiance_rows or 0), 3)).astype(
        np.float32)
    npz = str(tmp_path / "emitter.npz")
    np.savez(npz, is_emitter=np.ones(k, bool), emitter_vertices=verts,
             emitter_area=area, emitter_normal=c, emitter_radiance=rad)
    want = JX.extract_emitter_mesh(npz, str(tmp_path / "j.ply"))
    got = TX.extract_emitter_mesh(npz, str(tmp_path / "t.ply"))
    assert _read(str(tmp_path / "t.ply")) == _read(str(tmp_path / "j.ply"))
    assert got.tobytes() == np.asarray(want).tobytes()
    TX.main(["--emitter", npz, "--output", str(tmp_path / "cli" / "e.ply")])
    assert _read(str(tmp_path / "cli" / "e.ply")) == _read(
        str(tmp_path / "j.ply"))


def _mesh():
    mesh, _ = make_box_scene(n_clutter=3, seed=2)
    return mesh


@pytest.mark.parametrize("res,normal_cos", [(256, 0.8), (64, 0.5)])
def test_unwrap_same_uvs(res, normal_cos):
    """unwrap's UVs, charts and atlas size (doubling past a full atlas at
    64), then the rasterized texels and the dilation, bit for bit."""
    mesh = _mesh()
    j = JU.unwrap(mesh, res=res, normal_cos=normal_cos)
    t = TU.unwrap(mesh, res=res, normal_cos=normal_cos)
    assert t[2] == j[2]
    for a, b in zip(t[:2], j[:2]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    tri = np.asarray(mesh.triangles(), np.float64)
    jr = JU.rasterize_atlas(tri, j[0], j[2])
    tr = TU.rasterize_atlas(tri, t[0], t[2])
    for a, b in zip(tr, jr):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    tex = np.random.default_rng(1).uniform(0, 1, (t[2], t[2], 3)).astype(
        np.float32)
    assert TU.dilate_texture(tex, tr[3]).tobytes() == JU.dilate_texture(
        tex, jr[3]).tobytes()


@pytest.fixture(scope="module")
def material(tmp_path_factory):
    """One 4-level x 2^8 material, its coarse level varied, saved by each
    package, and the mesh as a PLY."""
    import dataclasses

    import jax.numpy as jnp

    d = tmp_path_factory.mktemp("export")
    ngp = init_ngp_brdf(jax.random.PRNGKey(0), -0.1, 2.1,
                        HashGridConfig(n_levels=4, log2_table_size=8))
    table = np.asarray(ngp.table).copy()
    table[: table.size // 4] = np.random.default_rng(0).uniform(
        -1, 1, table.size // 4)
    ngp = dataclasses.replace(ngp, table=jnp.asarray(table))
    jax_save_pytree(str(d / "j.pkl"), {"material": ngp})
    save_pytree(str(d / "t.pkl"), {"material": port_ngp(ngp)})
    mesh = _mesh()
    save_ply(str(d / "scene.ply"), mesh.vertices, mesh.faces)
    return d


@pytest.mark.parametrize("mode", [["--unwrap", "charts", "--res", "256"],
                                  ["--unwrap", "grid",
                                   "--texels_per_face", "4"]])
def test_export_cli_textures(material, mode):
    d = material
    outs = {}
    for tag, module in (("j", JE), ("t", TE)):
        out = str(d / f"{tag}_{mode[1]}")
        module.main(["--mesh", str(d / "scene.ply"), "--ckpt",
                     str(d / f"{tag}.pkl"), "--output", out] + mode
                    + (["--device", DEV] if tag == "t" else []))
        outs[tag] = out
    assert sorted(os.listdir(outs["t"])) == sorted(os.listdir(outs["j"]))
    for name in ("scene_uv.obj", "scene_uv.mtl"):
        assert _read(os.path.join(outs["t"], name)) == _read(
            os.path.join(outs["j"], name))
    for name in ("albedo.png", "rm.png"):
        got, want = (open_png(os.path.join(outs[k], name)) for k in "tj")
        assert got.shape == want.shape
        level = np.abs(got - want) * 255
        assert (level <= 1.0 + 1e-6).all(axis=-1).mean() >= 0.95, name
        assert want.mean() > 0.05


def test_export_defaults_to_the_card(material):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    d = material
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.main(["--mesh", str(d / "scene.ply"), "--ckpt", str(d / "t.pkl"),
                 "--output", str(d / "none")])


def _write_frame(gt, method, i, rng, h=6, w=8):
    emit = np.zeros((h, w, 3), np.float32)
    emit[0, :2] = rng.uniform(0.5, 3.0, (2, 3))
    albedo = rng.uniform(0.05, 0.95, (h, w, 3)).astype(np.float32)
    rough = np.where(rng.uniform(0, 1, (h, w, 1)) < 0.5, 1.0,
                     rng.uniform(0, 1, (h, w, 1))).repeat(3, -1)
    for name, arr in [("Image", albedo), ("Emit", emit),
                      ("DiffCol", albedo * 0.9), ("Roughness", rough)]:
        os.makedirs(os.path.join(gt, name), exist_ok=True)
        write_exr(os.path.join(gt, name, f"{i:03d}_0001.exr"), arr)
    os.makedirs(os.path.join(gt, "albedo"), exist_ok=True)
    write_exr(os.path.join(gt, "albedo", f"{i:03d}.exr"), albedo)
    for name in ["emission", "a_prime", "diffuse", "roughness"]:
        os.makedirs(os.path.join(method, name), exist_ok=True)
    est = emit * rng.uniform(0.5, 1.5)
    est[1, 1] = 1.0
    write_exr(os.path.join(method, "emission", f"{i:05d}_emission.exr"),
              est)
    save_image(np.clip(albedo + rng.normal(0, 0.05, albedo.shape), 0, 1),
               os.path.join(method, "a_prime", f"{i:05d}_a_prime.png"))
    save_image(np.clip(albedo * 0.8, 0, 1),
               os.path.join(method, "diffuse", f"{i:05d}_diffuse.png"))
    write_exr(os.path.join(method, "roughness", f"{i:05d}_roughness.exr"),
              np.clip(rough + rng.normal(0, 0.1, rough.shape), 0, 1))


@pytest.mark.parametrize("max_frames", [0, 2])
def test_metric_brdf_matches(tmp_path, max_frames):
    gt, method = str(tmp_path / "gt"), str(tmp_path / "method")
    rng = np.random.default_rng(3)
    for i in range(3):
        _write_frame(gt, method, i, rng)
    want = JM.brdf_metrics(gt, method, max_frames)
    got = TM.brdf_metrics(gt, method, max_frames)
    assert got.keys() == want.keys()
    for k in want:
        assert np.isfinite(want[k])
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)
