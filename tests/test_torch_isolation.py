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
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20


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


def test_cpu_tensors_take_plain_walks():
    """Without a card, an explicit CPU run goes through the plain
    versions and never counts a kernel launch."""
    from iris_tpu_torch.geometry import cuda_intersect as ci
    from iris_tpu_torch.geometry.intersect import ray_intersect

    before = (ci.trace_union.launches, ci.trace_paired.launches)
    mesh, _ = make_box_scene(n_clutter=2)
    tracer = build_bvh(mesh.triangles(), device="cpu")
    o = torch.full((16, 3), 0.5)
    d = torch.nn.functional.normalize(torch.randn(16, 3), dim=-1)
    _, _, _, _, valid = ray_intersect(tracer, o, d)
    assert valid.all()
    assert (ci.trace_union.launches, ci.trace_paired.launches) == before
