"""The comparison that decides `correct`, driven through the rest of a run
on the CPU at a small size: sound runs pass, the control (the reference
in bfloat16) and every fault the cells can have fail, and the result line
has the keys the driver reads, in order."""

from __future__ import annotations

import importlib

import pytest
import torch

from benchmark import compare, run
from benchmark.tests.conftest import ROOT, run_tiny, tiny_spec

TRAIN, RENDER = "init-prod4x16-102k", "render-ref32x2-102k"


class _NoUpdate:
    """An optimizer whose step returns the state unchanged."""

    def __init__(self, opt):
        self.opt = opt

    def init(self, params):
        return self.opt.init(params)

    def update(self, params, grads, opt_state):
        return None


def _half_batch(loss_fn):
    def loss(params, batch, gen, samples=None):
        b = batch["rays"].shape[0] // 2
        return loss_fn(params, {k: v[:b] for k, v in batch.items()}, gen,
                       samples)
    return loss


class _Altered:
    """A render round whose radiance is altered where it is produced."""

    def __init__(self, unit):
        self.unit = unit

    def __call__(self, *a, **k):
        out = self.unit(*a, **k)
        return (out[0] * 1.01,) + tuple(out[1:])


@pytest.mark.parametrize("workload,trace", [(TRAIN, False), (TRAIN, True),
                                            (RENDER, False), (RENDER, True)])
def test_sound_runs_pass_and_the_line_has_its_keys(root, workload, trace):
    out = run_tiny(workload, trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    spec = run.cell_spec(ROOT, workload)
    want = spec["per_layer"] if trace else spec["end_to_end"]
    got = set(out["metrics"])
    # a reader that finds nothing to read (no card: no traversal time, no
    # roofline) leaves its metric out
    assert got <= {m["name"] for m in want}
    if not trace:
        assert got == {m["name"] for m in want}


@pytest.mark.parametrize("workload,fault", [
    (TRAIN, {"optimizer": _NoUpdate}), (TRAIN, {"loss": _half_batch}),
    (RENDER, {"round": _Altered})])
def test_faults_fail(root, workload, fault):
    out = run_tiny(workload, faults=fault)
    assert out["correct"] is False


class _StuckAfterStart(_NoUpdate):
    """An optimizer that steps as it should through steps 0-2 and then
    leaves the state unchanged, as a replay whose update was lost would."""

    def __init__(self, opt):
        self.opt, self.n = opt, 0

    def update(self, params, grads, opt_state):
        self.n += 1
        if self.n <= 3:
            return self.opt.update(params, grads, opt_state)
        return None


def _frozen_draws_after_start(loss_fn):
    """A loss whose steps after step 2 all draw one stream, as a replay
    whose generator is not reseeded would."""
    calls = [0]

    def loss(params, batch, gen, samples=None):
        calls[0] += 1
        if calls[0] > 3:
            gen.manual_seed(12345)
        return loss_fn(params, batch, gen, samples)
    return loss


@pytest.mark.parametrize("fault", [{"optimizer": _StuckAfterStart},
                                   {"loss": _frozen_draws_after_start}])
def test_faults_after_the_start_fail_the_checked_chunk(root, fault):
    out = run_tiny(TRAIN, faults=fault)
    assert out["correct"] is False
    c = out["checks"]
    for name in ("loss_gap", "grad_gap", "change_gap"):
        assert c[name]["value"] <= c[name]["limit"], (name, c)
    assert any(c[n]["value"] > c[n]["limit"]
               for n in ("chunk_loss_gap", "chunk_change_gap")), c


@pytest.mark.parametrize("workload", [TRAIN, RENDER])
def test_the_control_fails(root, workload):
    spec = tiny_spec(workload)
    h = run.Harness(ROOT, spec, 2 ** 31 + 5, 1.0, False,
                    torch.device("cpu"))
    kind = importlib.import_module(
        f"benchmark.kinds.{spec['traffic']['kind']}")
    readings = kind.control(h)
    lim = compare.limits(ROOT, workload)
    for name, nums in readings.items():
        ok, _ = compare.judge(nums, lim)
        assert ok is (name == "sound"), (name, nums)


def test_reference_batches_are_the_trainers_rows():
    """The reference's own batches (gen.batches) are the rows the
    trainer's batcher gives, across epochs and an epoch's wrapped tail."""
    import numpy as np

    from iris_tpu_torch.data.datasets import RayBatcher

    from benchmark import gen

    rng = np.random.default_rng(4)
    bank = {"rays": rng.normal(size=(250, 12)).astype(np.float32),
            "rgbs": rng.uniform(size=(250, 3)).astype(np.float32)}
    seed = 2 ** 31 + 9
    it = RayBatcher(bank, 64, seed=seed).iter_from(0)
    want = [next(it) for _ in range(13)]
    got = gen.batches(bank, 64, seed, [0, 3, 4, 7, 12])
    for s, rows in got.items():
        for k in bank:
            np.testing.assert_array_equal(rows[k], want[s][k])
