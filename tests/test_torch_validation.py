"""The trainers' validation hooks and their helpers, PyTorch port against
the JAX package where both have them: the material diag hook's three
statistics (bf16 bar: the MLP sums its products in another order, ROADMAP
Queue 3, so each within 2e-3 plus the records' 1e-4 rounding), the
validation hook's PNGs at its cadence and its renders against the port's
own integrators under the same generators (equal), ScalarLogger's records
field for field, the magma table against matplotlib's (1/255; the PNG
bytes equal), the plots and the colormap with matplotlib blocked,
mesh_batch_size, the val split's narrowed catch and run_training's move of
host batches to the parameters' device."""

import dataclasses
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from iris_tpu.demo import make_demo_scene as jax_demo_scene
from iris_tpu.geometry.procedural import camera_rays
from iris_tpu.train import validation as jval
from iris_tpu.utils import image as jimage
from iris_tpu_torch.models.crf import init_emor_crf
from iris_tpu_torch.pipeline.common import mesh_batch_size, val_frame
from iris_tpu_torch.render.integrator import path_tracing, path_tracing_single
from iris_tpu_torch.train import validation
from iris_tpu_torch.train.loop import batch_to_device, run_training
from iris_tpu_torch.train.optim import make_optimizer
from iris_tpu_torch.utils import image, metric_crf
from torch_parity import port_emitter, port_ngp, port_tracer


@pytest.fixture(scope="module")
def scene():
    """A 12-clutter JAX demo scene, its 4 x 16 material's coarse level
    drawn from uniform(-1, 1) so that roughness varies, and a 16 x 20
    validation frame of camera rays."""
    jt, je, jn, _, _ = jax_demo_scene(
        n_clutter=12, slf_res=16, hash_levels=4, hash_features=16,
        log2_table=10, per_level_scale=-1.0)
    table = np.asarray(jn.table).copy().reshape(4 * 1024, 16)
    table[:1024] = np.random.default_rng(0).uniform(-1, 1, (1024, 16))
    jn = dataclasses.replace(jn, table=jnp.asarray(table.reshape(
        jn.table.shape)))
    o, d, dxdu, dydv = camera_rays(18)
    rays = np.concatenate([o, d, dxdu, dydv], -1).astype(np.float32)[:320]
    rgbs = np.random.default_rng(1).uniform(0, 1, (320, 3)).astype(
        np.float32)
    batch = {"rays": rays, "rgbs": rgbs, "exposure": np.float32(1.0)}
    return jt, je, jn, batch


def test_material_diag_hook_matches_jax(scene, tmp_path):
    jt, _, jn, batch = scene
    jpath, ppath = str(tmp_path / "j.jsonl"), str(tmp_path / "p.jsonl")
    jhook = jval.make_material_diag_hook(jt, batch, jpath, val_step=5,
                                         max_points=200)
    phook = validation.make_material_diag_hook(port_tracer(jt), batch, ppath,
                                               val_step=5, max_points=200)
    for step in range(7):
        jhook(step, {"material": jn}, 0.0, {})
        phook(step, {"material": port_ngp(jn)}, 0.0, {})
    recs = []
    for path in (jpath, ppath):
        with open(path) as f:
            recs.append([json.loads(line) for line in f])
    assert [r["step"] for r in recs[1]] == [r["step"] for r in recs[0]] \
        == [0, 5]
    for j, p in zip(*recs):
        assert set(p) == set(j)
        for k in ("rough_mean", "rough_ceiling_frac", "rough_floor_frac"):
            assert abs(p[k] - j[k]) <= 2e-3 * abs(j[k]) + 1e-4, (k, p, j)
    assert 0 < recs[1][0]["rough_mean"] < 1


def test_validation_hook_cadence_and_renders(scene, tmp_path):
    """PNGs at steps 0, 2, 4 of 0-4 (val_step 2); hook.render's L_train and
    L_full equal path_tracing_single and path_tracing called with the
    chunk's generator, in the hook's order."""
    jt, je, jn, batch = scene
    pt, pe, pn = port_tracer(jt), port_emitter(je), port_ngp(jn)
    crf = init_emor_crf(device="cpu")
    out = str(tmp_path / "val")
    hook = validation.make_validation_hook(
        pt, pe, crf, batch, (16, 20), out, val_step=2, spp=2, indir_depth=2)
    params = {"material": pn, "radiance": pe.radiance,
              "crf_weight": crf.weight}
    for step in range(5):
        hook(step, params, 0.0, {})
    assert sorted(os.listdir(out)) == sorted(
        f"{s:05d}_{n}.png" for s in (0, 2, 4)
        for n in ("L_train", "L_full", "L_gt", "crfs"))
    for name in os.listdir(out):
        assert Image.open(os.path.join(out, name)).size in (
            (20, 16), (1200, 400))
    l_train, l_full, curves = hook.render(params, 4)
    gen = validation.val_generator(4, 0, "cpu")
    rays = torch.from_numpy(batch["rays"])
    xs, ds = rays[:, :3], torch.nn.functional.normalize(rays[:, 3:6], dim=-1)
    mat_fn = functools.partial(validation.ngp_brdf_apply, pn)
    with torch.no_grad():
        want_t = path_tracing_single(gen, pt, pe, mat_fn, xs, ds,
                                     rays[:, 6:9], rays[:, 9:12], 2)
        want_f = path_tracing(gen, pt, pe, mat_fn, xs, ds, rays[:, 6:9],
                              rays[:, 9:12], 2, 2)
    np.testing.assert_array_equal(l_train, want_t.numpy())
    np.testing.assert_array_equal(l_full, want_f.numpy())
    assert curves.shape == (3, 1024) and np.abs(l_full).max() > 0


def test_validation_chunks_draw_their_own_streams(scene, tmp_path):
    """A frame past one chunk renders in 8,192-pixel chunks, each from its
    own generator; the last chunk is the remainder (no filler pixels)."""
    jt, je, jn, _ = scene
    o, d, dxdu, dydv = camera_rays(91)
    rays = np.concatenate([o, d, dxdu, dydv], -1).astype(np.float32)
    batch = {"rays": rays, "rgbs": np.zeros_like(rays[:, :3])}
    pt, pe, pn = port_tracer(jt), port_emitter(je), port_ngp(jn)
    hook = validation.make_validation_hook(
        pt, pe, init_emor_crf(device="cpu"), batch, (91, 91),
        str(tmp_path), spp=1, indir_depth=1)
    seen = []
    real = validation.val_seed
    try:
        validation.val_seed = lambda s, c: seen.append((s, c)) or real(s, c)
        l_train, l_full, _ = hook.render({"material": pn}, 3)
    finally:
        validation.val_seed = real
    assert seen == [(3, 0), (3, 1)]
    assert l_train.shape == l_full.shape == (91 * 91, 3)


def test_scalar_logger_matches_jax(tmp_path):
    jpath, ppath = str(tmp_path / "j.jsonl"), str(tmp_path / "p.jsonl")
    jlog, plog = jval.ScalarLogger(jpath), validation.ScalarLogger(ppath)
    for step in range(3):
        loss = 0.5 / (step + 1)
        jlog(step, None, jnp.float32(loss), {"loss_c": jnp.float32(loss / 2),
                                             "loss_a": jnp.float32(0.1)})
        plog(step, None, torch.tensor(loss),
             {"loss_c": torch.tensor(loss / 2), "loss_a": torch.tensor(0.1)})
    recs = []
    for path in (jpath, ppath):
        with open(path) as f:
            recs.append([json.loads(line) for line in f])
    for j, p in zip(*recs):
        assert list(p) == list(j)
        assert {k: v for k, v in p.items() if k != "wall_s"} == \
            {k: v for k, v in j.items() if k != "wall_s"}


def test_magma_table_matches_matplotlib(tmp_path):
    """The constant table within 1/255 of matplotlib's magma, and
    save_image(colormap=True) writes the JAX package's PNG bytes."""
    import matplotlib.cm as cm

    np.testing.assert_allclose(image.MAGMA / 255.0,
                               np.asarray(cm.magma.colors), atol=1 / 255)
    x = np.random.default_rng(3).uniform(-0.1, 1.1, (37, 23)).astype(
        np.float32)
    x[0, :5] = [0.0, 1.0, 0.5, 255 / 256, np.nan]
    a = jimage.save_image(x, str(tmp_path / "j.png"), colormap=True)
    b = image.save_image(x, str(tmp_path / "p.png"), colormap=True)
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "p.png")),
        np.asarray(Image.open(tmp_path / "j.png")))


def test_plots_and_colormap_without_matplotlib(tmp_path, monkeypatch):
    for name in ("matplotlib", "matplotlib.cm", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        import matplotlib  # noqa: F401
    curves = np.stack([np.linspace(0, 1, 1024) ** g for g in (0.4, 0.5,
                                                              0.6)])
    metric_crf.plot_crfs(curves, curves ** 1.1, str(tmp_path / "c.png"))
    metric_crf.plot_crfs(curves, None, str(tmp_path / "c0.png"))
    metric_crf.plot_weights(np.array([[0.1, -0.2, 0.05]]), None,
                            str(tmp_path / "w.png"))
    metric_crf.plot_weights(np.array([0.1, -0.2]), np.array([0.2, 0.1]),
                            str(tmp_path / "w2.png"))
    for name, size in (("c.png", (1200, 400)), ("c0.png", (1200, 400)),
                       ("w.png", (600, 400)), ("w2.png", (600, 400))):
        img = Image.open(tmp_path / name)
        assert img.size == size and np.asarray(img).std() > 0
    rgb = image.save_image(np.linspace(0, 1, 64).reshape(8, 8),
                           str(tmp_path / "m.png"), colormap=True)
    assert rgb.shape == (8, 8, 3) and rgb.dtype == np.uint8
    assert metric_crf.crf_l2(curves, curves) == 0.0


@pytest.mark.parametrize("n,want", [(None, 8191), (1, 8191), (2, 8190),
                                    (8, 8184)])
def test_mesh_batch_size_on_one_device(n, want):
    """One device leaves the batch; N ranks round it down to a multiple of
    N, as the JAX package's data mesh does (the port raised past one
    device before its parallel/ slice)."""
    assert mesh_batch_size(8191, n, "initialize") == want


def test_val_frame_skips_only_a_missing_split(tmp_path, capsys):
    """No val directory: skipped with the JAX package's message. A val
    split whose frames cannot be read: the error is raised."""
    from types import SimpleNamespace

    from torch_parity import write_cli_dataset

    ds, _ = write_cli_dataset(str(tmp_path))
    args = SimpleNamespace(dataset=["synthetic", ds], res_scale=1.0,
                           ldr_img_dir="ldr", scene="", val_frame=3)
    val_ds, vb = val_frame(args, "initialize")
    assert len(val_ds) == 1 and vb["rays"].shape == (320, 12)
    os.remove(os.path.join(ds, "val", "ldr", "000_0001.png"))
    os.remove(os.path.join(ds, "val", "Image", "000_0001.exr"))
    with pytest.raises(FileNotFoundError):
        val_frame(args, "initialize")
    os.rename(os.path.join(ds, "val"), os.path.join(ds, "gone"))
    assert val_frame(args, "initialize") == (None, None)
    assert "[initialize] no validation split:" in capsys.readouterr().out


def test_run_training_moves_host_batches_to_the_params_device():
    seen = []

    def loss_fn(p, batch, gen, samples=None):
        seen.append({k: (type(v), getattr(v, "device", None))
                     for k, v in batch.items()})
        loss = torch.sum((p["w"] * batch["x"]) ** 2)
        return loss, {}

    params = {"w": torch.ones(4)}
    batches = iter([{"x": np.arange(4, dtype=np.float32), "e": None}] * 2)
    run_training(loss_fn, params, batches, make_optimizer(), 2, 0,
                 log_fn=None)
    assert seen == [{"x": (torch.Tensor, params["w"].device),
                     "e": (type(None), None)}] * 2
    moved = batch_to_device({"x": np.zeros(3, np.float32),
                             "t": torch.zeros(2), "n": None}, "meta")
    assert moved["x"].device.type == moved["t"].device.type == "meta"
    assert moved["n"] is None


def test_port_imports_no_matplotlib():
    """Every module of the port imports, and the colormap and the plots
    run, with matplotlib blocked (the card's machine has none)."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys; sys.modules['matplotlib'] = None\n"
        "import importlib, pkgutil, numpy as np, tempfile, os\n"
        "import iris_tpu_torch\n"
        "for m in pkgutil.walk_packages(iris_tpu_torch.__path__,\n"
        "                               'iris_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from iris_tpu_torch.utils import image, metric_crf\n"
        "d = tempfile.mkdtemp()\n"
        "image.save_image(np.eye(4), os.path.join(d, 'a.png'), True)\n"
        "metric_crf.plot_crfs(np.ones((3, 8)), None, os.path.join(d, 'c.png'))\n"
        "assert not [m for m in sys.modules if m.startswith(('jax', 'iris_tpu.'))]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("cli,argv", [
    ("initialize", ["--experiment_name", "x"]),
    ("train_brdf_crf", ["--experiment_name", "x", "--cache_dir", "c"]),
    ("train_emitter", ["--experiment_name", "x", "--ckpt_path", "c"]),
    ("slf_refine", ["--scene", "s", "--output", "o", "--dataset",
                    "synthetic"]),
    ("render", ["--experiment_name", "x", "--output_path", "o"])])
def test_new_clis_default_to_the_card(cli, argv):
    """Without --device every new CLI asks for the card, and raises
    without one before it reads a file."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    main = importlib.import_module(f"iris_tpu_torch.pipeline.{cli}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
