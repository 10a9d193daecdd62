"""run_training and train/checkpoint of the PyTorch port on their own (no
JAX counterpart is run here; tests/test_torch_refparity.py holds the loop
against the JAX package's): kill and resume from the saved state gives the
uninterrupted run's parameters bit for bit on the CPU, the hooks' cadence,
atomic checkpoint writes, and load_train_state's three fallbacks."""

import dataclasses
import functools
import os
import pickle

import numpy as np
import pytest
import torch

from iris_tpu_torch import convert
from iris_tpu_torch.demo import make_demo_batch, make_demo_scene
from iris_tpu_torch.device import resolve_device
from iris_tpu_torch.models import crf as tcrf
from iris_tpu_torch.models.brdf import NGPBRDF, ngp_brdf_apply
from iris_tpu_torch.render.integrator import path_tracing_single
from iris_tpu_torch.train import checkpoint as ck
from iris_tpu_torch.train.loop import (
    TrainerConfig, run_training, step_generator)
from iris_tpu_torch.train.optim import make_optimizer

SPP = 2
N_STEPS = 6


@pytest.fixture(scope="module")
def world():
    tracer, em, ngp, crf, _ = make_demo_scene(
        n_clutter=4, slf_res=8, hash_levels=4, log2_table=8, device="cpu")
    ngp = dataclasses.replace(ngp, cfg=dataclasses.replace(
        ngp.cfg, stochastic_fwd=True, stochastic_bwd=True,
        bwd_level_sample=1))
    rays = make_demo_batch(n_side=4, device="cpu")["rays"]
    # three pixel batches in turn: the iterator's position matters
    bank = [{"rays": rays}, {"rays": rays.flip(0)},
            {"rays": rays.roll(5, 0)}]

    def loss_fn(p, batch, gen, samples=None):
        r = batch["rays"]
        o, d, dxdu, dydv = (r[:, i:i + 3] for i in (0, 3, 6, 9))
        em2 = dataclasses.replace(em, radiance=p["radiance"])
        crf2 = dataclasses.replace(crf, weight=p["crf_w"])
        mat_fn = functools.partial(ngp_brdf_apply, p["material"], gen=gen)
        l = path_tracing_single(gen, tracer, em2, mat_fn, o, d, dxdu, dydv,
                                SPP)
        loss = torch.mean((tcrf.crf_forward(crf2, l, 1.0) - 0.5) ** 2)
        return loss, {"loss": loss, "mean_l": l.mean()}

    def params0():
        return {"material": dataclasses.replace(
                    ngp, table=ngp.table.clone(),
                    mlp={k: [t.clone() for t in v]
                         for k, v in ngp.mlp.items()}),
                "radiance": em.radiance.clone(),
                "crf_w": crf.weight.clone()}

    def batches(start=0):
        return (bank[s % len(bank)] for s in range(start, 10 ** 6))

    return loss_fn, params0, batches


def _leaves(params):
    return convert.leaves_to_numpy(params)


def _assert_same_bits(a: dict, b: dict):
    assert set(a) == set(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


@pytest.mark.parametrize("chunk_steps", [1, 2])
def test_kill_and_resume_is_bit_for_bit(world, tmp_path, chunk_steps):
    """Adam, lr halved from step 3, six steps. The run killed after step 4
    and resumed from the state file the saver wrote (parameters, both Adam
    moments, step counts, the scheduler) ends on the uninterrupted run's
    parameters, every bit; a params-only resume does not."""
    loss_fn, params0, batches = world
    opt = make_optimizer(learning_rate=1e-2, milestones=(3,))
    kw = dict(seed=7, log_fn=None, chunk_steps=chunk_steps)
    full, full_state = run_training(loss_fn, params0(), batches(), opt,
                                    N_STEPS, return_state=True, **kw)
    path = str(tmp_path / "state.pkl")
    k = 4
    run_training(loss_fn, params0(), batches(), opt, k,
                 state_hooks=[ck.make_state_saver(path, every=2)], **kw)
    assert os.listdir(tmp_path) == ["state.pkl"]        # no .tmp left
    params, opt_state, start = ck.load_train_state(
        path, str(tmp_path / "none.pkl"), params0(), optimizer=opt,
        device="cpu")
    assert start == k and isinstance(params["material"], NGPBRDF)
    assert params["material"].cfg == params0()["material"].cfg
    resumed, res_state = run_training(
        loss_fn, params, batches(k), opt, N_STEPS, opt_state=opt_state,
        start_step=start, return_state=True, **kw)
    _assert_same_bits(_leaves(resumed), _leaves(full))
    assert res_state["sched"].get_last_lr() == \
        full_state["sched"].get_last_lr() == [5e-3] * 3
    # the optimizer's moments too
    a = ck.opt_state_to_numpy(res_state)["opt"]["state"]
    b = ck.opt_state_to_numpy(full_state)["opt"]["state"]
    for i in a:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            np.testing.assert_array_equal(a[i][name], b[i][name])
    # guard against passing vacuously: without the moments it differs
    bad = run_training(loss_fn,
                       ck.load_pytree(path, device="cpu")["params"],
                       batches(k), opt, N_STEPS, start_step=k, **kw)
    assert any(np.abs(x - y).max() > 0 for x, y in zip(
        _leaves(bad).values(), _leaves(full).values()))


def test_chunked_run_is_the_unchunked_run(world):
    """chunk_steps changes when hooks look, not what is computed: the same
    generators per absolute step and the same updates, chunk sizes that do
    not divide the step count included."""
    loss_fn, params0, batches = world
    opt = make_optimizer(learning_rate=1e-2, milestones=(3,))
    runs = [_leaves(run_training(loss_fn, params0(), batches(), opt, 5,
                                 seed=7, log_fn=None, chunk_steps=c))
            for c in (1, 2, 4)]
    _assert_same_bits(runs[0], runs[1])
    _assert_same_bits(runs[0], runs[2])
    other_seed = _leaves(run_training(loss_fn, params0(), batches(), opt, 5,
                                      seed=8, log_fn=None))
    assert np.abs(other_seed["material.table"]
                  - runs[0]["material.table"]).max() > 0


def test_step_generator_is_a_function_of_seed_and_absolute_step():
    a = torch.rand(4, generator=step_generator(3, 10, "cpu"))
    b = torch.rand(4, generator=step_generator(3, 10, "cpu"))
    c = torch.rand(4, generator=step_generator(3, 11, "cpu"))
    d = torch.rand(4, generator=step_generator(4, 10, "cpu"))
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)


@pytest.mark.parametrize("chunk_steps,state_steps", [
    (1, [0, 1, 2, 3, 4]), (2, [1, 3, 4]), (3, [2, 4])])
def test_hook_and_state_hook_cadence(world, chunk_steps, state_steps):
    """hooks once per step with that step's loss; state_hooks once per
    chunk at its last step index; the log line at log_every and at the last
    step, in the JAX package's format."""
    loss_fn, params0, batches = world
    opt = make_optimizer(learning_rate=1e-3)
    seen, states, lines = [], [], []
    params = params0()
    run_training(
        loss_fn, params, batches(), opt, 5, seed=1, log_every=2,
        log_fn=lines.append, chunk_steps=chunk_steps,
        hooks=[lambda s, p, loss, aux: seen.append(
            (s, p is params, float(loss), sorted(aux)))],
        state_hooks=[lambda s, p, o: states.append(
            (s, p is params, sorted(o)))])
    assert [s for s, *_ in seen] == [0, 1, 2, 3, 4]
    assert all(same and aux == ["loss", "mean_l"]
               for _, same, _, aux in seen)
    assert [s for s, *_ in states] == state_steps
    assert all(same and keys == ["opt", "sched"] for _, same, keys in states)
    assert [int(line.split()[1]) for line in lines] == [0, 2, 4]
    import re
    for line, (_, _, loss, _) in zip(lines, (seen[0], seen[2], seen[4])):
        assert re.fullmatch(
            r"step +\d+  loss \d+\.\d{6}  loss=\d+\.\d{5}  "
            r"mean_l=-?\d+\.\d{5}  \[\d+\.\d+s\]", line), line
        assert f"loss {loss:.6f}" in line
    # the losses do not depend on the chunking
    ref = []
    run_training(loss_fn, params0(), batches(), opt, 5, seed=1, log_fn=None,
                 hooks=[lambda s, p, loss, aux: ref.append(float(loss))])
    assert [v for _, _, v, _ in seen] == ref


def test_run_training_takes_no_step_past_n_steps(world):
    loss_fn, params0, batches = world
    params = params0()
    before = _leaves(params)
    taken = []
    out = run_training(loss_fn, params, batches(), make_optimizer(), 3,
                       seed=0, log_fn=None, start_step=3,
                       hooks=[lambda *a: taken.append(a)])
    assert out is params and not taken
    _assert_same_bits(_leaves(params), before)
    assert TrainerConfig().log_every == 50


# ------------------------------------------------------------ checkpoints

def _tree():
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": [torch.ones(2), torch.zeros(1)]},
            "step": np.int64(3)}


def test_save_pytree_round_trip_and_no_tmp(tmp_path):
    path = str(tmp_path / "sub" / "p.pkl")      # the directory is made
    ck.save_pytree(path, _tree())
    assert os.listdir(tmp_path / "sub") == ["p.pkl"]
    back = ck.load_pytree(path, device="cpu")
    assert torch.equal(back["w"], _tree()["w"])
    assert torch.equal(back["nested"]["b"][0], torch.ones(2))
    assert int(back["step"]) == 3
    with open(path, "rb") as f:                 # numpy inside, no tensors
        raw = pickle.load(f)
    assert isinstance(raw["w"], np.ndarray)


def test_save_pytree_survives_a_write_that_raises(tmp_path, monkeypatch):
    """A write that dies half-way leaves the old file intact and no temp
    file behind."""
    path = str(tmp_path / "p.pkl")
    ck.save_pytree(path, _tree())
    old = open(path, "rb").read()

    def dump_then_die(obj, f):
        f.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(ck.pickle, "dump", dump_then_die)
    with pytest.raises(OSError, match="disk full"):
        ck.save_pytree(path, {"w": torch.zeros(3)})
    monkeypatch.undo()
    assert open(path, "rb").read() == old
    assert os.listdir(tmp_path) == ["p.pkl"]
    assert torch.equal(ck.load_pytree(path, device="cpu")["w"],
                       _tree()["w"])


def test_state_saver_cadence(tmp_path):
    path = str(tmp_path / "s.pkl")
    opt = make_optimizer()
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    hook = ck.make_state_saver(path, every=3)
    for step in range(2):
        hook(step, params, state)
    assert not os.path.exists(path)
    hook(2, params, state)
    assert int(ck.load_pytree(path, device="cpu")["step"]) == 3
    ck.make_state_saver(str(tmp_path / "never.pkl"), every=0)(2, params,
                                                              state)
    assert not os.path.exists(tmp_path / "never.pkl")


def test_load_train_state_three_fallbacks(tmp_path, capsys):
    opt = make_optimizer()
    fresh = {"w": torch.full((3,), 7.0)}
    state_path, params_path = (str(tmp_path / "state.pkl"),
                               str(tmp_path / "params.pkl"))
    # 3: nothing on disk -> the fresh params
    got = ck.load_train_state(state_path, params_path, fresh, opt,
                              device="cpu")
    assert got[0] is fresh and got[1:] == (None, 0)
    # 2: a params-only file -> its params, optimizer state reset
    ck.save_pytree(params_path, {"w": torch.ones(3)})
    p, o, s = ck.load_train_state(state_path, params_path, fresh, opt,
                              device="cpu")
    assert torch.equal(p["w"], torch.ones(3)) and o is None and s == 0
    assert "params only" in capsys.readouterr().out
    # an unreadable state file falls through to the params file
    with open(state_path, "wb") as f:
        f.write(b"not a pickle")
    p, o, s = ck.load_train_state(state_path, params_path, fresh, opt,
                              device="cpu")
    assert torch.equal(p["w"], torch.ones(3)) and o is None and s == 0
    assert "unreadable state file" in capsys.readouterr().out
    # 1: the full state -> params, a live optimizer state, the step
    trained = {"w": torch.full((3,), 2.0)}
    st = opt.init(trained)
    opt.update(trained, {"w": torch.ones(3)}, st)
    ck.make_state_saver(state_path, every=1)(4, trained, st)
    p, o, s = ck.load_train_state(state_path, params_path, fresh, opt,
                              device="cpu")
    assert s == 5 and torch.equal(p["w"], trained["w"])
    assert o["opt"].state_dict()["state"][0]["exp_avg"].abs().sum() > 0
    assert o["opt"].param_groups[0]["params"][0] is p["w"]
    assert "full state" in capsys.readouterr().out
    # without an optimizer the saved state comes back as numpy
    _, raw, _ = ck.load_train_state(state_path, params_path, fresh,
                                  device="cpu")
    assert isinstance(raw["opt"]["state"][0]["exp_avg"], np.ndarray)


def test_load_into_fills_the_template_in_place(tmp_path):
    path = str(tmp_path / "p.pkl")
    ck.save_pytree(path, {"a": torch.arange(6.0), "b": [torch.ones(2)]})
    template = {"a": torch.zeros((2, 3)), "b": [torch.zeros(2)]}
    a = template["a"]
    out = ck.load_into(path, template)
    assert out is template and out["a"] is a
    assert torch.equal(a, torch.arange(6.0).reshape(2, 3))
    with pytest.raises(ValueError, match="structure mismatch"):
        ck.load_into(path, {"a": torch.zeros(6)})


def test_checkpoint_loaders_default_to_the_card(tmp_path, monkeypatch,
                                                capsys):
    """load_pytree and load_train_state put the restored tensors on the
    card unless asked for the CPU: with no card their default raises what
    device.resolve_device raises, before any file is read, so a present
    state file is not taken for an unreadable one. load_into follows its
    template's device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError) as no_card:
        resolve_device(None)
    path = str(tmp_path / "p.pkl")
    ck.save_pytree(path, _tree())
    with pytest.raises(RuntimeError) as got:
        ck.load_pytree(path)
    assert str(got.value) == str(no_card.value)
    opt = make_optimizer()
    params = {"w": torch.zeros(3)}
    ck.make_state_saver(path, every=1)(0, params, opt.init(params))
    for params_path in (path, str(tmp_path / "none.pkl")):
        with pytest.raises(RuntimeError) as got:
            ck.load_train_state(path, params_path, params, opt)
        assert str(got.value) == str(no_card.value)
    assert "falling back" not in capsys.readouterr().out
    template = {"w": torch.ones(3)}
    ck.save_pytree(path, {"w": torch.arange(3.0)})
    assert torch.equal(ck.load_into(path, template)["w"], torch.arange(3.0))
