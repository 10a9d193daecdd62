"""Data-parallel training of the PyTorch port (iris_tpu_torch/parallel/,
train/loop.run_training(group=...), the trainers' --n_devices), on the CPU
with gloo ranks in spawned processes (tests/torch_ranks.py).

The slice's claim: an N-rank step is the one-process step on the same
global batch, up to the order of the gradient sums, and the JAX package's
GSPMD step over N devices. Sizes: the 4-clutter demo scene, a 4 x 4 x 2^10
hash grid, 64 pixels (32 a rank), spp 2.

Tolerances, two ranks against one process under the same generators:
loss and aux within 1e-6 relative (measured: equal); each gradient leaf
within 1e-6 of its largest entry (measured <= 1.1e-7), but for the MLP's
weights, within 1e-2 (measured <= 4.6e-3). Only the order of sums differs:
the per-ray gradients of the ranks are added by the all-reduce, and the
MLP's products run on 32 rows where they ran on 64. The MLP rounds its
operands to bf16 (models/mlp.py, as the JAX package does), so the
backward rounds each weight gradient to bf16 (8 bits) as well: on two
ranks each half is rounded and the halves added, on one process the whole
is rounded once. Two ranks against the JAX package: the bars of
tests/test_torch_train.py (loss rtol 2e-3, gradient cosine >= 0.9999 and
norm within 1%), the bf16 MLP rounding in each package at other places."""

import dataclasses
import json
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_tpu.demo import make_demo_batch as jax_demo_batch
from iris_tpu.demo import make_demo_scene as jax_demo_scene
from iris_tpu.parallel.sharding import data_mesh
from iris_tpu.train import steps as jsteps
from iris_tpu.train.loop import make_train_step as jax_train_step
from iris_tpu.train.optim import make_optimizer as jax_make_optimizer
from iris_tpu_torch import convert
from iris_tpu_torch.parallel import sharding
from iris_tpu_torch.parallel.distributed import ensure_multihost
from iris_tpu_torch.pipeline import initialize
from iris_tpu_torch.pipeline.common import mesh_batch_size
from iris_tpu_torch.train.checkpoint import load_pytree
from torch_parity import (
    CLI_TRAIN, cosine, hold_leaves, jax_brdf_crf_draws, jax_emitter_draws,
    jax_initialize_draws, jax_leaves_by_name, logged_losses,
    one_torch_thread, port_crf, port_emitter, port_ngp, port_tracer,
    write_cli_dataset)
from torch_ranks import loss_cases, one_case, spawn

SPP = 2
CASES = {
    "initialize": ("initialize", dict(spp=SPP, n_spp_rounds=2,
                                      max_segments=8)),
    "train_emitter": ("train_emitter", dict(spp=SPP,
                                            radiance_log_space=True)),
    "brdf_crf_part": ("brdf_crf", dict(max_segments=8, has_part=True,
                                       la=0.1, n_pairs=64)),
    "brdf_crf_semantic": ("brdf_crf", dict(max_segments=8, has_part=False,
                                           la=0.1, n_pairs=64)),
}
JAX_KEYS = {"initialize": 5, "train_emitter": 6, "brdf_crf_part": 7,
            "brdf_crf_semantic": 8}


@pytest.fixture(scope="module")
def scene():
    """The JAX scene and batch, and their port copies (convert): the
    trainers' estimators (stochastic forward and backward, one level block
    a step, float32 compact scatter), the coarse level spread over
    (-1, 1)."""
    tracer, em, ngp, crf, _ = jax_demo_scene(
        n_clutter=4, slf_res=16, hash_levels=4, log2_table=10,
        hash_features=4, per_level_scale=-1.0)
    rng = np.random.default_rng(0)
    rad = rng.uniform(0.05, 0.5, em.slf.radiance.shape).astype(np.float32)
    em = dataclasses.replace(em, slf=dataclasses.replace(
        em.slf, radiance=jnp.asarray(rad)))
    table = np.asarray(ngp.table).reshape(4, -1, 4).copy()
    table[0] = rng.uniform(-1, 1, table[0].shape)
    ngp = dataclasses.replace(
        ngp, table=jnp.asarray(table.reshape(-1)),
        cfg=dataclasses.replace(
            ngp.cfg, stochastic_fwd=True, stochastic_bwd=True,
            bwd_level_sample=1, bwd_scatter_dtype="float32"))
    crf = dataclasses.replace(crf, weight=jnp.asarray(
        rng.normal(0, 0.05, (3, 3)).astype(np.float32)))
    batch = {k: np.asarray(v) for k, v in jax_demo_batch(n_side=8).items()}
    b = batch["rays"].shape[0]
    batch["diffuse"] = rng.uniform(0, 1, (b, 3)).astype(np.float32)
    batch["specular0"] = rng.uniform(0, 1, (b, 6, 3)).astype(np.float32)
    batch["specular1"] = rng.uniform(0, 1, (b, 6, 3)).astype(np.float32)
    port = (port_tracer(tracer), port_emitter(em), port_ngp(ngp),
            port_crf(crf))
    return (tracer, em, ngp, crf), port, batch


def _jax_draws(name, key, hcfg, b):
    kind, cfg = CASES[name]
    if kind == "initialize":
        return jax_initialize_draws(key, hcfg, b, SPP, cfg["n_spp_rounds"])
    if kind == "train_emitter":
        return jax_emitter_draws(key, b, SPP, 1)
    return jax_brdf_crf_draws(key, hcfg, b, cfg["n_pairs"])


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    """Every case on two gloo ranks (one spawn), under the port's
    generators and under the JAX keys' replayed draws, and in this process
    with no group under the port's generators."""
    (_, _, jn, _), port, batch = scene
    b = batch["rays"].shape[0]
    cases = [(*CASES[n], None) for n in CASES] + [
        (*CASES[n], _jax_draws(n, jax.random.PRNGKey(JAX_KEYS[n]), jn.cfg,
                               b)) for n in CASES]
    ranks = spawn(loss_cases, 2, tmp_path_factory.mktemp("ranks"), port,
                  batch, cases)
    ref = {n: one_case(port, batch, *CASES[n], None) for n in CASES}
    k = len(CASES)
    return ({n: [r[i] for r in ranks] for i, n in enumerate(CASES)},
            {n: [r[k + i] for r in ranks] for i, n in enumerate(CASES)},
            ref, [r[2 * k] for r in ranks])


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_equal_one_process(runs, name):
    """Loss and aux within 1e-6 relative, every gradient leaf within 1e-6
    of its largest entry (the MLP's weights 1e-2, module docstring), on
    both ranks alike; after 3 Adam steps the two ranks' parameters are the
    same bits, and each step's logged loss is within 1e-4 of the
    one-process run's (the step-0 loss within 1e-6; later steps start from
    parameters that Adam's normalized updates have moved apart where the
    MLP's bf16 weight gradients differ in their last bits). Hooks, state
    hooks and the log ran on rank 0 alone."""
    two, _, ref, _ = runs
    one = ref[name]
    r0, r1 = two[name]
    for r in (r0, r1):
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=1e-6)
        for k, v in one["aux"].items():
            np.testing.assert_allclose(r["aux"][k], v, rtol=1e-6, atol=1e-9)
        assert r["grads"].keys() == one["grads"].keys()
        for k, g in one["grads"].items():
            rel = 1e-2 if ".mlp.w." in k else 1e-6
            assert np.abs(r["grads"][k] - g).max() <= rel * np.abs(
                g).max(), k
    assert r0["loss"] == r1["loss"]
    assert all(np.array_equal(r0["grads"][k], r1["grads"][k])
               for k in r0["grads"])
    assert r0["params"].keys() == r1["params"].keys()
    for k in r0["params"]:
        assert r0["params"][k].tobytes() == r1["params"][k].tobytes(), k
    want = [lo for _, lo in one["seen"]["hooks"]]
    assert [s for s, _ in r0["seen"]["hooks"]] == [0, 1, 2]
    np.testing.assert_allclose([lo for _, lo in r0["seen"]["hooks"]], want,
                               rtol=1e-4)
    assert r0["seen"]["hooks"][0][1] == pytest.approx(want[0], rel=1e-6)
    assert r0["seen"]["state_hooks"] == [0, 1, 2]
    assert len(r0["seen"]["log"]) == 3
    assert r1["seen"] == {"hooks": [], "state_hooks": [], "log": []}


def test_resume_takes_rank_0s_state(runs):
    """initialize, 2 steps then a resume to 3 with rank 1 holding another
    state at the resume: run_training broadcasts rank 0's parameters and
    Adam state, and both ranks end on the uninterrupted run's bits."""
    *_, resumed = runs
    for r in resumed:
        assert r["full"].keys() == r["resumed"].keys()
        for k, v in resumed[0]["full"].items():
            assert r["full"][k].tobytes() == v.tobytes(), k
            assert r["resumed"][k].tobytes() == v.tobytes(), k


def _jax_loss(jscene, name):
    jt, je, jn, jc = jscene
    kind, cfg = CASES[name]
    lc = jsteps.LossConfig(**cfg)
    if kind == "initialize":
        return (jsteps.make_initialize_loss(jt, je, jc, lc),
                {"material": jn, "radiance": je.radiance})
    if kind == "train_emitter":
        return (jsteps.make_train_emitter_loss(jt, je, jn, jc, lc),
                {"radiance": jsteps.radiance_to_param(je.radiance)})
    return (jsteps.make_brdf_crf_loss(jt, jc, lc, -0.1, 2.1),
            {"material": jn, "crf_weight": jc.weight})


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_the_jax_gspmd_step(scene, runs, name):
    """The port's two ranks, under the JAX key's draws replayed at the
    global batch's shape, against one SGD step (rate 1) of the JAX
    package's make_train_step over a two-device data mesh: the loss and
    aux rtol 2e-3; each gradient leaf against the JAX step's parameter
    change at cosine >= 0.9999 and within 1% in norm."""
    jscene, _, batch = scene
    _, replayed, _, _ = runs
    loss_fn, params = _jax_loss(jscene, name)
    mesh = data_mesh(devices=jax.devices("cpu")[:2])
    assert mesh.devices.size == 2
    opt = jax_make_optimizer(learning_rate=1.0, optimizer="SGD")
    step = jax_train_step(loss_fn, opt, mesh, donate=False)
    start = jax_leaves_by_name(params)
    new, _, loss, aux = step(params, opt.init(params),
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.PRNGKey(JAX_KEYS[name]))
    moved = {k: start[k] - v for k, v in jax_leaves_by_name(new).items()}
    for r in replayed[name]:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=2e-3)
        for k, v in aux.items():
            np.testing.assert_allclose(r["aux"][k], float(v), rtol=2e-3,
                                       atol=1e-7)
        got = r["grads"]
        checked = 0
        for k, ref in moved.items():
            if k.endswith(("voxel_min", "voxel_max")):
                continue
            assert np.linalg.norm(ref) > 0, k
            assert cosine(got[k], ref) >= 0.9999, (k, cosine(got[k], ref))
            assert np.linalg.norm(got[k] - ref) <= 0.01 * np.linalg.norm(
                ref), k
            checked += 1
        assert checked == len(got)


@pytest.mark.parametrize("name", list(CASES))
def test_one_rank_gives_the_bits_of_no_group(scene, tmp_path, name):
    """A group of one rank (gloo, in this process): the loss, aux,
    gradients and the parameters after 3 steps are the bits of the run
    with no group."""
    _, port, batch = scene
    group = ensure_multihost("file://" + str(tmp_path / "rv"), 1, 0,
                             timeout_s=30, device="cpu")
    try:
        got = one_case(port, batch, *CASES[name], group)
    finally:
        group.close()
    want = one_case(port, batch, *CASES[name], None)
    assert got["loss"] == want["loss"] and got["aux"] == want["aux"]
    for part in ("grads", "params"):
        assert got[part].keys() == want[part].keys()
        for k in want[part]:
            assert got[part][k].tobytes() == want[part][k].tobytes(), k
    assert got["seen"]["state_hooks"] == want["seen"]["state_hooks"]


_FAIL_HARD = """
import sys, time
from iris_tpu_torch.parallel.distributed import ensure_multihost
t0 = time.time()
try:
    ensure_multihost(sys.argv[1], 2, int(sys.argv[2]), timeout_s=5,
                     device="cpu")
except RuntimeError as e:
    print("RuntimeError", round(time.time() - t0, 1), e)
"""


@pytest.mark.parametrize("how", ["dead_coordinator", "one_of_two"])
def test_ensure_multihost_fails_hard(tmp_path, how):
    """A coordinator that does not answer (a bound TCP port nobody listens
    on, this process a client rank), and a run of two processes where only
    one comes: RuntimeError naming the coordinator within the 5 s timeout.
    Each in a process of its own: a process whose group failed to start
    does not join another (torch.distributed's group count has moved on)."""
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        coordinator, rank = (
            (f"tcp://localhost:{s.getsockname()[1]}", 1)
            if how == "dead_coordinator"
            else ("file://" + str(tmp_path / "rv"), 0))
        out = subprocess.run(
            [sys.executable, "-c", _FAIL_HARD, coordinator, str(rank)],
            env=env, capture_output=True, text=True, timeout=120)
    words = out.stdout.split()
    assert words[:1] == ["RuntimeError"], out.stdout + out.stderr
    assert float(words[1]) < 30
    assert f"coordinator={coordinator!r}" in out.stdout
    assert ensure_multihost() is None


def test_mesh_batch_size(capsys):
    """Rounded down to a positive multiple of the rank count, with the JAX
    package's notice; one rank leaves it."""
    assert mesh_batch_size(8192, None) == 8192
    assert mesh_batch_size(221, 1) == 221
    assert capsys.readouterr().out == ""
    assert mesh_batch_size(221, 2, "init") == 220
    assert "batch_size 221 -> 220" in capsys.readouterr().out
    assert mesh_batch_size(3, 4) == 4
    assert mesh_batch_size(8192, 8) == 8192


class _Group:
    def __init__(self, rank, world_size):
        self.rank, self.world_size = rank, world_size


def test_shard_rows_and_draws():
    """Each rank's contiguous rows, in order, make the batch; a
    RankGenerator's draw along a ray axis is the rank's rows of a plain
    generator's draw of the whole batch, replayed samples the same."""
    x = np.arange(24).reshape(12, 2)
    parts = [sharding.shard_rows({"x": x, "e": None}, _Group(r, 3))
             for r in range(3)]
    assert all(p["e"] is None for p in parts)
    assert np.array_equal(np.concatenate([p["x"] for p in parts]), x)
    assert sharding.shard_rows(x, None) is x
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard_rows(x[:7], _Group(0, 2))
    plain = torch.Generator().manual_seed(3)
    whole = sharding.draw_uniform(plain, (2, 12, 4, 1), "cpu", -0.5, 0.5)
    for r in range(3):
        g = sharding.RankGenerator("cpu", r, 3)
        g.manual_seed(3)
        mine = sharding.draw_uniform(g, (2, 4, 4, 1), "cpu", -0.5, 0.5,
                                     axis=1)
        assert torch.equal(mine, whole[:, 4 * r:4 * r + 4])
        assert torch.equal(sharding.rank_rows(whole, g, 1), mine)
        # a whole draw (the propagation loss's partners) is not sliced
        assert sharding.draw_uniform(g, (5,), "cpu").shape == (5,)
    padded, n = sharding.pad_to_multiple(np.arange(5), 4)
    assert n == 5 and padded.tolist() == [0, 1, 2, 3, 4, 4, 4, 4]


def test_host_shard_indices_disjoint_and_complete():
    per = [sharding.host_shard_indices(1000, 256, 7, 3, _Group(r, 4))
           for r in range(4)]
    assert all(len(p) == 64 for p in per)
    every = np.concatenate(per)
    assert len(np.unique(every)) == 256
    whole = sharding.host_shard_indices(1000, 256, 7, 3, None)
    assert np.array_equal(every, whole)
    assert not np.array_equal(
        whole, sharding.host_shard_indices(1000, 256, 7, 4, None))


def _watch_gradients(monkeypatch):
    """Wrap the port's optimizer update (in this process): the starting
    leaves, and the masks of tests/torch_parity.jax_noise_bound taken from
    the port's own gradients ({name: entries nonzero and below 0.15 of
    the leaf's largest at some step}, {name: nonzero at some step}), as
    numpy."""
    from iris_tpu_torch.train import optim

    real = optim.Optimizer.update
    seen = {"start": {}, "bound": {}, "touched": {}}

    def update(opt, params, grads, opt_state):
        if not seen["start"]:
            seen["start"] = convert.leaves_to_numpy(params)
        for n, g in grads.items():
            a = g.abs().numpy()
            seen["bound"][n] = seen["bound"].get(n, False) | (
                (a > 0) & (a < 0.15 * a.max()))
            seen["touched"][n] = seen["touched"].get(n, False) | (a > 0)
        real(opt, params, grads, opt_state)

    monkeypatch.setattr(optim.Optimizer, "update", update)
    return seen


def test_initialize_cli_two_ranks_equal_one(tmp_path, monkeypatch):
    """initialize.main --device cpu --n_devices 2 (two gloo ranks it starts
    itself) against --n_devices 1 on the CLI parity dataset, 3 steps:
    every logged loss within 1e-5 relative, one log line a step, and the
    same files written once; the final leaves by the Adam rule of
    tests/torch_parity.hold_leaves, with the one-process run's gradients
    in place of the JAX package's (Adam's normalized steps of 1e-3 a step
    turn the gradients' last-bit differences into up to a step's size at
    entries whose gradient is near zero)."""
    ds, bake = write_cli_dataset(str(tmp_path / "data"), n_val=0)
    monkeypatch.chdir(tmp_path)
    argv = (["--dataset", "synthetic", ds, "--ldr_img_dir", "ldr",
             "--voxel_path", os.path.join(bake, "vslf.npz"),
             "--emitter_path", os.path.join(bake, "emitter.npz"),
             "--device", "cpu"] + CLI_TRAIN)
    with monkeypatch.context() as m:
        seen = _watch_gradients(m)
        initialize.main(argv + ["--experiment_name", "one", "--n_devices",
                                "1"])
    initialize.main(argv + ["--experiment_name", "two", "--n_devices", "2"])
    a, b = (logged_losses(os.path.join("outputs", e, "train_log.jsonl"))
            for e in ("one", "two"))
    assert [s for s, _ in b] == [s for s, _ in a] == [0, 1, 2]
    np.testing.assert_allclose([v for _, v in b], [v for _, v in a],
                               rtol=1e-5)
    for e in ("one", "two"):
        assert sorted(os.listdir(os.path.join("checkpoints", e))) == [
            "last.pkl", "last_state.pkl"]
        assert os.listdir(os.path.join("outputs", e)) == ["train_log.jsonl"]
    one, two = (convert.leaves_to_numpy(load_pytree(os.path.join(
        "checkpoints", e, "last.pkl"), "cpu")) for e in ("one", "two"))
    assert one.keys() == two.keys() == seen["start"].keys()
    hold_leaves(two, one, seen["start"], seen["bound"], seen["touched"],
                3 * 1e-3)
    with open(os.path.join("outputs", "two", "train_log.jsonl")) as f:
        assert all("loss" in json.loads(line) for line in f)
