"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points refuse to fall back to the CPU silently."""

import os
import subprocess
import sys

import pytest
import torch

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
             "models.hashgrid", "models.crf", "geometry.cuda_intersect"):
    assert "iris_tpu_torch." + want in names, want
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 26


@pytest.mark.parametrize("entry", [
    lambda: make_demo_scene(n_clutter=1, log2_table=8, slf_res=4),
    lambda: make_demo_batch(n_side=4),
    lambda: build_bvh(make_box_scene(n_clutter=1)[0].triangles()),
    lambda: init_emor_crf(),
])
def test_entry_points_default_to_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


@pytest.mark.parametrize("n_clutter,leaf_size,kernel", [
    (2, 4, "trace_union"), (420, 4, "trace_paired"),
    (420, 16, "trace_ordered"), (420, 4, "trace_paired_streamed")])
def test_cpu_tensors_take_plain_walks(n_clutter, leaf_size, kernel):
    """Without a card, an explicit CPU run goes through the plain
    versions and never counts a kernel launch."""
    from iris_tpu_torch.geometry import cuda_intersect as ci
    from iris_tpu_torch.geometry.intersect import kernel_for, ray_intersect

    wrappers = (ci.trace_union, ci.trace_paired, ci.trace_paired_streamed,
                ci.trace_ordered)
    before = [w.launches for w in wrappers]
    mesh, _ = make_box_scene(n_clutter=n_clutter)
    tracer = build_bvh(mesh.triangles(), leaf_size=leaf_size, device="cpu")
    o = torch.full((16, 3), 0.5)
    d = torch.nn.functional.normalize(
        torch.randn(16, 3, generator=torch.Generator().manual_seed(0)),
        dim=-1)
    if kernel == "trace_paired_streamed":
        # the dispatch sends only trees past the 10 MB gate here
        face = ci.trace_paired_streamed(tracer, o, d)[3]
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
        n_clutter=1, log2_table=8, slf_res=4, device="cpu")
    batch = make_demo_batch(n_side=4, device="cpu")
    loss_fn = make_train_emitter_loss(tracer, em, ngp, crf,
                                      LossConfig(spp=1))
    params = {"radiance": em.radiance.clone()}
    opt = make_optimizer()
    step = make_train_step(loss_fn, opt)
    gen = torch.Generator().manual_seed(0)
    params, _, loss, _ = step(params, opt.init(params), batch, gen)
    assert loss.device.type == "cpu" and torch.isfinite(loss)
