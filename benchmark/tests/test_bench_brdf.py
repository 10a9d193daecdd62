"""The train_brdf_crf cells' comparison, driven through the rest of a run on
the CPU at a small size: sound runs pass; the faults the cells can have,
planted in the program's timed path, fail (half of each batch, a state
left unchanged, and in the semantic cell partners drawn across segments
and half the partners); the reference's batches of the stage's wide bank
are the trainer's rows."""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from benchmark import compare, run
from benchmark.tests.conftest import ROOT, tiny_spec
from benchmark.tests.test_bench_checks import _NoUpdate, _half_batch

PART, SEM = "brdfcrf-ref32x2-102k", "brdfcrf-sem-ref32x2-102k"


def brdf_spec(workload: str) -> dict:
    """conftest's tiny cell with the stage's batch and chunk: 512 rows
    (every segment of the small views holds several), chunks of 2."""
    spec = tiny_spec(workload)
    spec["traffic"].update(batch_size=512, chunk_steps=2)
    return spec


def run_brdf(workload: str, seed: int = 2 ** 31 + 11, trace: bool = False,
             faults: dict | None = None) -> dict:
    spec = brdf_spec(workload)
    h = run.Harness(ROOT, spec, seed, 1.0, trace, torch.device("cpu"),
                    faults)
    importlib.import_module("benchmark.kinds.brdf_crf").run(h)
    return run.assemble(h, spec, ROOT, {"platform": "cpu", "count": 1})


@pytest.mark.parametrize("workload,trace", [(PART, False), (PART, True),
                                            (SEM, False), (SEM, True)])
def test_sound_runs_pass(root, workload, trace):
    out = run_brdf(workload, trace=trace)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    spec = run.cell_spec(ROOT, workload)
    want = spec["per_layer"] if trace else spec["end_to_end"]
    got = set(out["metrics"])
    assert got <= {m["name"] for m in want}
    if not trace:
        assert got == {"train_step_ms", "setup_s"}


def _across_segments(monkeypatch):
    """The propagation loss's partners drawn among all valid pixels: its
    sort key ignores the segment."""
    from iris_tpu_torch.train import steps

    orig = steps.propagation_loss

    def across(gen, seg, valid, *a, **k):
        return orig(gen, torch.zeros_like(seg), valid, *a, **k)

    monkeypatch.setattr(steps, "propagation_loss", across)


def _half_pairs(cfg):
    import dataclasses

    return dataclasses.replace(cfg, n_pairs=cfg.n_pairs // 2)


@pytest.mark.parametrize("workload,fault", [
    (PART, {"optimizer": _NoUpdate}), (PART, {"loss": _half_batch}),
    (SEM, {"optimizer": _NoUpdate}), (SEM, {"loss": _half_batch}),
    (SEM, {"loss_config": _half_pairs}), (SEM, "across")])
def test_faults_fail(root, monkeypatch, workload, fault):
    if fault == "across":
        _across_segments(monkeypatch)
        fault = None
    out = run_brdf(workload, faults=fault)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", [PART, SEM])
def test_the_control_fails(root, workload):
    spec = brdf_spec(workload)
    h = run.Harness(ROOT, spec, 2 ** 31 + 5, 1.0, False,
                    torch.device("cpu"))
    readings = importlib.import_module("benchmark.kinds.brdf_crf").control(h)
    assert set(readings) == {"sound", "bfloat16", "half_batch"} | (
        {"across_segments", "n_pairs_512"} if workload == SEM else set())
    lim = compare.limits(ROOT, workload)
    for name, nums in readings.items():
        ok, _ = compare.judge(nums, lim)
        assert ok is (name == "sound"), (name, nums)


def test_reference_batches_of_the_wide_bank_are_the_trainers_rows():
    """gen.batches on the stage's bank (its (N, R, 3) specular columns
    beside the flat ones) gives the rows RayBatcher gives, across epochs
    and an epoch's wrapped tail."""
    from iris_tpu_torch.data.datasets import RayBatcher

    from benchmark import gen, gen_brdf

    spec = brdf_spec(SEM)
    tr = spec["traffic"]
    views = gen.views(3, 0, (10, 12), 60)
    bank = gen_brdf.pixel_bank(views, (10, 12), tr, 7)
    assert bank["specular0"].shape == (360, tr["specular_levels"], 3)
    seed = 2 ** 31 + 9
    it = RayBatcher(bank, 64, seed=seed).iter_from(0)
    want = [next(it) for _ in range(13)]
    got = gen.batches(bank, 64, seed, [0, 3, 5, 6, 12])
    for s, rows in got.items():
        for k in bank:
            np.testing.assert_array_equal(rows[k], want[s][k])


def test_room_labels_are_skewed_and_the_same_in_every_view():
    """The semantic traffic's labels: one id a region of the room whatever
    the view, every id in use over the bank, the largest a wall or the
    floor's largest region."""
    from benchmark import gen, gen_brdf

    v = gen.views(4, 0, (30, 40), 60)
    seg = gen_brdf.room_labels(v.reshape(-1, 12), 128, 1.5, 0)
    # the same room point seen from two cameras: the label of a ray from
    # each camera through the point
    o1, o2 = np.array([0.5, 0.5, 0.8]), np.array([1.5, 1.2, 0.7])
    p = np.array([1.1, 1.7, 0.0])
    rays = np.zeros((2, 12), np.float32)
    rays[:, 0:3] = [o1, o2]
    rays[:, 3:6] = [p - o1, p - o2]
    a, b = gen_brdf.room_labels(rays, 128, 1.5, 0)
    assert a == b
    counts = np.bincount(seg.astype(np.int64), minlength=128)
    assert counts.max() > 10 * np.median(counts[counts > 0])


def test_the_scannetpp_deployment_is_ref32x2s_field_under_its_traffic():
    """ref32x2-scannetpp is ref32x2's field, key for key, and the numbers
    of its deployment are the ones the semantic cell's traffic runs."""
    spec = run.cell_spec(ROOT, SEM)
    cfg, tr = spec["config"], spec["traffic"]
    assert cfg["name"] == "ref32x2-scannetpp"
    field = run.cell_spec(ROOT, "render-ref32x2-102k")["config"]
    for k in ("hash_grid", "scene", "mlp", "crf", "slf", "field_bounds",
              "emitter_radiance", "optimizer", "precision"):
        assert cfg[k] == field[k], k
    dep = cfg["deployment"]
    assert dep["has_part"] == tr["loss"]["has_part"] == 0
    assert dep["image_hw"] == tr["image_hw"]
    for k in ("max_segments", "specular_levels", "batch_size"):
        assert dep[k] == tr[k], k
    for k, v in dep["loss"].items():
        assert tr["loss"][k] == v, k
