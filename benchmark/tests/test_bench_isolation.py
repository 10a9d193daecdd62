"""Nothing a run imports is JAX or the JAX package (top-level names
compared whole, so that the port's name does not match)."""

from __future__ import annotations

import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT

PROBE = """
import sys
import benchmark.run, benchmark.reference, benchmark.compare
import benchmark.kinds.initialize, benchmark.kinds.render
import iris_tpu_torch.train.loop, iris_tpu_torch.pipeline.render
import iris_tpu_torch.data.datasets, iris_tpu_torch.render.denoise
print(sorted({m.split('.')[0] for m in sys.modules}))
print(benchmark.run.forbidden_modules())
"""


def test_no_jax_in_a_run():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    top, bad = out.stdout.strip().splitlines()[-2:]
    assert bad == "[]"
    assert "'iris_tpu_torch'" in top and "'iris_tpu'" not in top
    assert "'jax'" not in top


def test_forbidden_names_are_whole(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "iris_tpu_torch_probe", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "iris_tpu.x", object())
    assert run.forbidden_modules() == ["iris_tpu"]


def test_no_card_no_result():
    """Without a card the run prints no result and exits non-zero."""
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "init-prod4x16-102k", "--seed", "1", "--seconds", "1"], cwd=ROOT,
        capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""
