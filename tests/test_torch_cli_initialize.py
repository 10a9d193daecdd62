"""The initialize stage CLI, PyTorch port against the JAX package: the
same tiny dataset (the port's generator, 16 x 20, 2 train frames), the
same starting material (the JAX package's build_material, carried across
with convert), 3 Adam steps in chunks of 2, so that a chunk boundary falls
inside the run, with JAX's keys replayed into the port step for step
(fold_in(PRNGKey(0), step), the level-block phase included).

Tolerances: every logged loss rtol 2e-3 (the bf16 MLP sums its products in
another order, ROADMAP.md Queue 3); the final leaves by Adam's rule of
test_torch_train.py (torch_parity.hold_leaves). --resume on the CPU gives
the uninterrupted run's bits."""

import os

import jax
import numpy as np
import pytest

from iris_tpu.pipeline import common as jcommon
from iris_tpu.pipeline import initialize as jinit
from iris_tpu.train.checkpoint import load_pytree as jax_load_pytree
from iris_tpu_torch import convert
from iris_tpu_torch.pipeline import initialize
from iris_tpu_torch.train.checkpoint import load_pytree
from torch_parity import (
    CLI_TRAIN, capture_jax_training, hold_leaves, jax_initialize_draws,
    jax_leaves_by_name, logged_losses, jax_noise_bound, port_ngp,
    same_checkpoints, write_cli_dataset)

B, SPP, ROUNDS, STEPS = 256, 2, 2, 3


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("init")
    return write_cli_dataset(str(root), n_val=0)


def _args(ds, bake, name):
    return (["--dataset", "synthetic", ds, "--ldr_img_dir", "ldr",
             "--voxel_path", os.path.join(bake, "vslf.npz"),
             "--emitter_path", os.path.join(bake, "emitter.npz"),
             "--experiment_name", name] + CLI_TRAIN)


def test_initialize_cli_matches_jax(data, tmp_path, monkeypatch):
    ds, bake = data
    monkeypatch.chdir(tmp_path)
    jax_mat = {}

    def jax_build(args, vmin, vmax, key=None):
        m = jcommon.build_material(args, vmin, vmax, key)
        # carried across before the JAX step donates its buffers
        jax_mat.update(cfg=m.cfg, port=port_ngp(m))
        return m

    monkeypatch.setattr(jinit, "build_material", jax_build)
    cap = capture_jax_training(monkeypatch, jinit)
    jinit.main(_args(ds, bake, "jax"))
    hcfg = jax_mat["cfg"]
    assert hcfg.row_gather and hcfg.stochastic_fwd and hcfg.stochastic_bwd
    monkeypatch.setattr(initialize, "build_material",
                        lambda args, vmin, vmax, device=None:
                        jax_mat["port"])
    key = jax.random.PRNGKey(0)
    initialize.main(
        _args(ds, bake, "port") + ["--device", "cpu"],
        samples_for_step=lambda s: jax_initialize_draws(
            jax.random.fold_in(key, s), hcfg, B, SPP, ROUNDS))

    want = logged_losses(os.path.join("outputs", "jax", "train_log.jsonl"))
    got = logged_losses(os.path.join("outputs", "port", "train_log.jsonl"))
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(STEPS))
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=2e-3)
    ref = jax_leaves_by_name(jax_load_pytree(os.path.join(
        "checkpoints", "jax", "last.pkl")))
    out = convert.leaves_to_numpy(load_pytree(os.path.join(
        "checkpoints", "port", "last.pkl"), "cpu"))
    assert set(out) == {"radiance", "material.table"} | {
        f"material.mlp.{k}.{i}" for k in "wb" for i in range(3)}
    bound, touched, start = jax_noise_bound(cap)
    hold_leaves(out, ref, start, bound, touched, STEPS * 1e-3)


def test_initialize_resume_gives_the_same_bits(data, tmp_path, monkeypatch):
    """2 steps, then --resume to 3, against 3 steps in one run (the port's
    own generators): the same losses, last.pkl and last_state.pkl."""
    ds, bake = data
    monkeypatch.chdir(tmp_path)
    full = _args(ds, bake, "full") + ["--device", "cpu"]
    initialize.main(full)
    part = _args(ds, bake, "part") + ["--device", "cpu"]
    initialize.main(part + ["--max_steps", "2"])
    initialize.main(part + ["--resume"])
    assert logged_losses(os.path.join("outputs", "part", "train_log.jsonl")) \
        == logged_losses(os.path.join("outputs", "full", "train_log.jsonl"))
    same_checkpoints(os.path.join("checkpoints", "full"),
                     os.path.join("checkpoints", "part"),
                     ("last.pkl", "last_state.pkl"))
