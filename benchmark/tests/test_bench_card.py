"""One short run of each cell on the card (marked cuda; skips without
one): correct, and the metrics the cell reports."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.parametrize("workload", ["init-prod4x16-102k",
                                      "render-ref32x2-102k"])
def test_cell_on_card(card, workload):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", workload,
         "--seed", str(2 ** 31 + 77), "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert "setup_s" in res["metrics"]
