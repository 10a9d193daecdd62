"""The train_emitter stage CLI, PyTorch port against the JAX package: the
same tiny dataset and SLF (the port's generator, slf_bake and
extract_emitter), material and CRF weights frozen from a JAX package
checkpoint carried across with convert, 3 Adam steps of the emitter
radiance in chunks of 2, so that a chunk boundary falls inside the run,
with JAX's keys replayed into the port step for step.

Tolerances: every logged loss rtol 2e-3 (the bf16 MLP sums its products in
another order, ROADMAP.md Queue 3); the radiance by Adam's rule of
test_torch_train.py (torch_parity.hold_leaves). --resume on the CPU gives
the uninterrupted run's bits."""

import os
from argparse import ArgumentParser

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from iris_tpu.pipeline import common as jcommon
from iris_tpu.pipeline import train_emitter as jemitter
from iris_tpu.pipeline.config import add_model_specific_args
from iris_tpu.train.checkpoint import load_pytree as jax_load_pytree
from iris_tpu.train.checkpoint import save_pytree as jax_save_pytree
from iris_tpu_torch import convert
from iris_tpu_torch.pipeline import train_emitter
from iris_tpu_torch.train.checkpoint import load_pytree, save_pytree
from torch_parity import (
    CLI_TRAIN, capture_jax_training, hold_leaves, jax_emitter_draws,
    jax_leaves_by_name, logged_losses, jax_noise_bound, port_ngp,
    same_checkpoints, tt, write_cli_dataset)

B, SPP, ROUNDS, STEPS = 256, 2, 2, 3


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The dataset, and the frozen material and CRF in both formats."""
    root = str(tmp_path_factory.mktemp("emitter"))
    ds, bake = write_cli_dataset(root, n_val=0)
    z = np.load(os.path.join(bake, "vslf.npz"))
    args = add_model_specific_args(ArgumentParser()).parse_args(
        CLI_TRAIN[:4])
    jn = jcommon.build_material(args, float(z["voxel_min"]),
                                float(z["voxel_max"]))
    w = np.random.default_rng(5).normal(0, 0.1, (3, 3)).astype(np.float32)
    jax_ckpt = os.path.join(root, "jax_brdf.pkl")
    jax_save_pytree(jax_ckpt, {"material": jn, "crf_weight": jnp.asarray(w)})
    port_ckpt = os.path.join(root, "port_brdf.pkl")
    save_pytree(port_ckpt, {"material": port_ngp(jn), "crf_weight": tt(w)})
    return ds, bake, jax_ckpt, port_ckpt


def _args(data, name, ckpt):
    ds, bake, _, _ = data
    return (["--dataset", "synthetic", ds, "--ldr_img_dir", "ldr",
             "--voxel_path", os.path.join(bake, "vslf.npz"),
             "--emitter_path", os.path.join(bake, "emitter.npz"),
             "--ckpt_path", ckpt, "--experiment_name", name] + CLI_TRAIN)


def test_train_emitter_cli_matches_jax(data, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cap = capture_jax_training(monkeypatch, jemitter)
    jemitter.main(_args(data, "jax", data[2]))
    key = jax.random.PRNGKey(0)
    train_emitter.main(
        _args(data, "port", data[3]) + ["--device", "cpu"],
        samples_for_step=lambda s: jax_emitter_draws(
            jax.random.fold_in(key, s), B, SPP, ROUNDS))

    want = logged_losses(os.path.join("outputs", "jax", "train_log.jsonl"))
    got = logged_losses(os.path.join("outputs", "port", "train_log.jsonl"))
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(STEPS))
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=2e-3)
    ref = jax_leaves_by_name(jax_load_pytree(os.path.join(
        "checkpoints", "jax", "emitter_last.pkl")))
    out = convert.leaves_to_numpy(load_pytree(os.path.join(
        "checkpoints", "port", "emitter_last.pkl"), "cpu"))
    assert set(out) == {"radiance"} and out["radiance"].shape == (2, 3)
    bound, touched, start = jax_noise_bound(cap)
    # extracted radiance is zero; three steps of lr 1e-3 move it up
    assert np.abs(start["radiance"]).max() == 0
    assert (ref["radiance"] > 0).all()
    hold_leaves(out, ref, start, bound, touched, STEPS * 1e-3)


def test_train_emitter_resume_gives_the_same_bits(data, tmp_path,
                                                   monkeypatch):
    """2 steps, then --resume to 3, against 3 steps in one run (the port's
    own generators): the same losses, emitter_last.pkl and
    emitter_last_state.pkl."""
    monkeypatch.chdir(tmp_path)
    full = _args(data, "full", data[3]) + ["--device", "cpu"]
    train_emitter.main(full)
    part = _args(data, "part", data[3]) + ["--device", "cpu"]
    train_emitter.main(part + ["--max_steps", "2"])
    train_emitter.main(part + ["--resume"])
    assert logged_losses(os.path.join("outputs", "part", "train_log.jsonl")) \
        == logged_losses(os.path.join("outputs", "full", "train_log.jsonl"))
    same_checkpoints(os.path.join("checkpoints", "full"),
                     os.path.join("checkpoints", "part"),
                     ("emitter_last.pkl", "emitter_last_state.pkl"))
