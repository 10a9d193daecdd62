"""Shared helpers of the benchmark's own tests, run from the repository's
root: `python -m pytest benchmark/tests -q` (about two minutes on the
CPU; the tests marked `cuda` run a cell on the card and skip without
one)."""

from __future__ import annotations

import importlib
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def tiny_spec(workload: str) -> dict:
    """The cell's files at a size the CPU runs in seconds: 494 faces, a
    2^12 table, 8 x 10 views, a few rays and samples."""
    from benchmark import run

    spec = run.cell_spec(ROOT, workload)
    cfg, tr = spec["config"], spec["traffic"]
    cfg["scene"]["n_clutter"] = 40
    cfg["hash_grid"]["log2_table_size"] = 12
    cfg["slf"]["resolution"] = 8
    tr.update(image_hw=[8, 10], n_views=3, traced_units=2)
    if tr["kind"] == "initialize":
        tr.update(batch_size=64, spp=2, SPP=4, chunk_steps=2)
    else:
        tr.update(spp=2, SPP=4, indir_depth=2, check_pixels=16)
    return spec


def run_tiny(workload: str, seed: int = 2 ** 31 + 11, trace: bool = False,
             faults: dict | None = None, seconds: float = 1.0) -> dict:
    """One run of the cell's driver on the CPU, past the harness's look
    for a card: the result line's object."""
    from benchmark import run

    spec = tiny_spec(workload)
    h = run.Harness(ROOT, spec, seed, seconds, trace, torch.device("cpu"),
                    faults)
    importlib.import_module(
        f"benchmark.kinds.{spec['traffic']['kind']}").run(h)
    return run.assemble(h, spec, ROOT, {"platform": "cpu", "count": 1})


@pytest.fixture
def root(monkeypatch):
    monkeypatch.chdir(ROOT)
    return ROOT
