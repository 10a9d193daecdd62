"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points refuse to fall back to the CPU silently."""

import os
import subprocess
import sys

import pytest
import torch

from iris_tpu_torch import (bench, bench_components, bench_scaling,
                            graft_entry)
from iris_tpu_torch.demo import make_demo_batch, make_demo_scene
from iris_tpu_torch.geometry.bvh import build_bvh
from iris_tpu_torch.geometry.procedural import make_box_scene
from iris_tpu_torch.models.crf import init_emor_crf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import iris_tpu_torch
names = [m.name for m in pkgutil.walk_packages(iris_tpu_torch.__path__,
                                               "iris_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "iris_tpu" or m.startswith("iris_tpu."))
print(len(names), bad)
assert not bad, bad
for want in ("train.steps", "train.optim", "train.loop", "utils.losses",
             "train.checkpoint", "models.hashgrid", "models.crf",
             "geometry.cuda_intersect", "geometry.intersect",
             "render.relight", "pipeline.render_relight",
             "pipeline.render_video", "utils.gen_path", "utils.video",
             "utils.extract_emitter_mesh", "utils.export",
             "utils.uv_unwrap", "utils.metric_brdf",
             "utils.extract_geometry", "utils.render_semantic",
             "utils.fuse_segmentation", "utils.hdr2ldr",
             "utils.process_images", "data.colmap", "models.mlps",
             "utils.timing", "utils.profiling", "parallel.sharding",
             "parallel.distributed", "parallel.comms_report", "bench",
             "bench_components", "bench_scaling", "graft_entry"):
    assert "iris_tpu_torch." + want in names, want
from iris_tpu_torch.geometry.intersect import TraversalPolicy, kernel_for
from iris_tpu_torch.train.loop import TrainerConfig, run_training
from iris_tpu_torch.train.checkpoint import (
    load_into, load_pytree, load_train_state, make_state_saver, save_pytree)
assert TraversalPolicy() == TraversalPolicy("auto", "auto", True, False)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 60


@pytest.mark.parametrize("entry", [
    lambda: make_demo_scene(n_clutter=1, log2_table=8, slf_res=4,
                            hash_levels=4, hash_features=16,
                            per_level_scale=-1.0),
    lambda: make_demo_batch(n_side=4),
    lambda: build_bvh(make_box_scene(n_clutter=1)[0].triangles()),
    lambda: init_emor_crf(),
    lambda: make_demo_scene(),
    lambda: make_demo_scene(n_clutter=1, hash_levels=32, log2_table=8),
])
def test_entry_points_default_to_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


@pytest.mark.parametrize("module,argv", [
    ("render_relight", ["--experiment_name", "x", "--output_path", "o",
                        "--light_cfg", "c.yaml"]),
    ("render_video", ["--experiment_name", "x", "--output_path", "o"]),
    ("export", ["--mesh", "m.obj", "--ckpt", "c.pkl", "--output", "o"]),
])
def test_relight_video_and_export_clis_default_to_cuda(module, argv,
                                                       tmp_path,
                                                       monkeypatch):
    """The consumers of a trained scene ask for the card before they read
    a file or write one."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    package = "utils" if module == "export" else "pipeline"
    main = importlib.import_module(f"iris_tpu_torch.{package}.{module}").main
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("module,argv", [
    ("extract_geometry", []),
    ("render_semantic", ["--labels", "labels.npy"]),
    ("fuse_segmentation", []),
])
def test_dataset_tools_default_to_cuda(module, argv, tmp_path, monkeypatch):
    """The ray-casting dataset tools ask for the card before they read the
    dataset or write a file."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    main = importlib.import_module(f"iris_tpu_torch.utils.{module}").main
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--dataset", "synthetic", "--scene", "missing", "--output",
              "out"] + argv)
    assert os.listdir(tmp_path) == []


def test_comms_report_defaults_to_cuda(tmp_path, monkeypatch):
    """The data-parallel traffic count asks for the card before it starts
    a rank or writes a file."""
    from iris_tpu_torch.parallel import comms_report

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        comms_report.main(["--link_bw", "2.5e10"])
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("call", [
    lambda: bench.main([]),
    lambda: bench.main(["--small-only"]),
    lambda: bench_components.main([]),
    lambda: bench_scaling.main([]),
    lambda: graft_entry.entry(),
    lambda: graft_entry.dryrun_multichip(2),
    lambda: graft_entry.main([]),
])
def test_root_script_twins_default_to_cuda(call, tmp_path, monkeypatch):
    """The benchmarks and the graft entry ask for the card before they
    build a scene, start a rank or write a file."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("n_clutter,leaf_size,kernel", [
    (2, 4, "trace_union"), (420, 4, "trace_paired"),
    (420, 16, "trace_ordered"), (420, 4, "trace_paired_streamed"),
    (420, 4, "trace_dense"), (420, 4, "trace_streamed"),
    (420, 4, "trace_dense_streamed")])
def test_cpu_tensors_take_plain_walks(n_clutter, leaf_size, kernel):
    """Without a card, an explicit CPU run goes through the plain
    versions and never counts a kernel launch."""
    from iris_tpu_torch.geometry import cuda_intersect as ci
    from iris_tpu_torch.geometry.intersect import (
        TraversalPolicy, kernel_for, ray_intersect)

    wrappers = [getattr(ci, name) for name in ci.KERNELS]
    before = [w.launches for w in wrappers]
    mesh, _ = make_box_scene(n_clutter=n_clutter)
    tracer = build_bvh(
        mesh.triangles(), leaf_size=leaf_size, device="cpu",
        policy=TraversalPolicy(dense=True) if kernel == "trace_dense"
        else None)
    o = torch.full((16, 3), 0.5)
    d = torch.nn.functional.normalize(
        torch.randn(16, 3, generator=torch.Generator().manual_seed(0)),
        dim=-1)
    if kernel.endswith("streamed"):
        # the dispatch sends only trees past the 10 MiB gates here
        face = getattr(ci, kernel)(tracer, o, d)[3]
        assert (face >= 0).all()
    else:
        assert kernel_for(tracer).__name__ == kernel
        _, _, _, _, valid = ray_intersect(tracer, o, d)
        assert valid.all()
    assert [w.launches for w in wrappers] == before


def test_training_entry_points_run_on_cpu_when_asked():
    """The training functions take the device of what they are given."""
    from iris_tpu_torch.train.loop import make_train_step
    from iris_tpu_torch.train.optim import make_optimizer
    from iris_tpu_torch.train.steps import (
        LossConfig, make_train_emitter_loss)

    tracer, em, ngp, crf, _ = make_demo_scene(
        n_clutter=1, log2_table=8, slf_res=4, hash_levels=4,
        hash_features=16, per_level_scale=-1.0, device="cpu")
    batch = make_demo_batch(n_side=4, device="cpu")
    loss_fn = make_train_emitter_loss(tracer, em, ngp, crf,
                                      LossConfig(spp=1))
    params = {"radiance": em.radiance.clone()}
    opt = make_optimizer()
    step = make_train_step(loss_fn, opt)
    gen = torch.Generator().manual_seed(0)
    params, _, loss, _ = step(params, opt.init(params), batch, gen)
    assert loss.device.type == "cpu" and torch.isfinite(loss)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_run_training_runs_where_its_parameters_lie(device, monkeypatch):
    """run_training names no device of its own: every step's generator is
    made on the device of the parameters it was given (a stand-in device
    here, since there is no card), never on the CPU by default."""
    from iris_tpu_torch.train import loop
    from iris_tpu_torch.train.optim import make_optimizer

    asked = []

    def generator_on(seed, step, dev, group=None):
        assert group is None
        asked.append((step, torch.device(dev).type))
        return torch.Generator().manual_seed(seed + step)

    monkeypatch.setattr(loop, "step_generator", generator_on)

    def loss_fn(p, batch, gen, samples=None):
        loss = (p["w"] * batch["x"]).sum()
        return loss, {}

    params = {"w": torch.ones(3, device=device)}
    batches = iter([{"x": torch.ones(3, device=device)}] * 2)
    out = loop.run_training(loss_fn, params, batches, make_optimizer(), 2,
                            seed=0, log_fn=None)
    assert asked == [(0, device), (1, device)]
    assert out["w"].device.type == device


def test_demo_defaults_are_the_flat_grid_on_cpu_when_asked():
    tracer, em, ngp, crf, _ = make_demo_scene(n_clutter=1, device="cpu")
    assert ngp.table.device.type == "cpu" and ngp.table.dim() == 1
    assert (ngp.cfg.n_levels, ngp.cfg.n_features, ngp.cfg.log2_table_size,
            ngp.cfg.row_gather) == (16, 2, 15, False)
    assert tuple(em.slf.radiance.shape)[0] == 32 ** 3
    assert tracer.policy == tracer.policy.__class__()
