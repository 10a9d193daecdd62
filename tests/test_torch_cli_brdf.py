"""The train_brdf_crf stage CLI, PyTorch port against the JAX package: the
same tiny dataset and shading caches (written by the port's generator and
its bake_shading, which both packages read), a warm start from a JAX
package checkpoint (material and CRF weights, --load_crf) carried across
with convert, 3 Adam steps in chunks of 2, so that a chunk boundary falls
inside the run, with JAX's keys replayed into the port step for step.

Tolerances: every logged loss rtol 2e-3 (the bf16 MLP sums its products in
another order, ROADMAP.md Queue 3); the final leaves by Adam's rule of
test_torch_train.py (torch_parity.hold_leaves). --resume on the CPU gives
the uninterrupted run's bits."""

import os
from argparse import ArgumentParser

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from iris_tpu.pipeline import common as jcommon
from iris_tpu.pipeline import train_brdf_crf as jbrdf
from iris_tpu.pipeline.config import add_model_specific_args
from iris_tpu.train.checkpoint import load_pytree as jax_load_pytree
from iris_tpu.train.checkpoint import save_pytree as jax_save_pytree
from iris_tpu_torch import convert
from iris_tpu_torch.pipeline import bake_shading, train_brdf_crf
from iris_tpu_torch.train.checkpoint import load_pytree, save_pytree
from torch_parity import (
    CLI_TRAIN, capture_jax_training, hold_leaves, jax_brdf_crf_draws,
    jax_leaves_by_name, logged_losses, jax_noise_bound, port_ngp,
    same_checkpoints, tt, write_cli_dataset)

B, STEPS, N_PAIRS = 256, 3, 1024


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The dataset, its caches, and the warm start in both formats."""
    root = str(tmp_path_factory.mktemp("brdf"))
    ds, bake = write_cli_dataset(root, n_val=0)
    cache = os.path.join(root, "shading")
    bake_shading.main(["--dataset", "synthetic", "--scene", ds,
                       "--ldr_img_dir", "ldr", "--device", "cpu",
                       "--slf_path", os.path.join(bake, "vslf.npz"),
                       "--emitter_path", os.path.join(bake, "emitter.npz"),
                       "--output", cache, "--spp_diffuse", "16"])
    z = np.load(os.path.join(bake, "vslf.npz"))
    args = add_model_specific_args(ArgumentParser()).parse_args(
        CLI_TRAIN[:4])
    jn = jcommon.build_material(args, float(z["voxel_min"]),
                                float(z["voxel_max"]))
    w = np.random.default_rng(2).normal(0, 0.1, (3, 3)).astype(np.float32)
    jax_ckpt = os.path.join(root, "jax_init.pkl")
    jax_save_pytree(jax_ckpt, {"material": jn, "crf_weight": jnp.asarray(w),
                               "radiance": jnp.zeros((2, 3))})
    port_ckpt = os.path.join(root, "port_init.pkl")
    save_pytree(port_ckpt, {"material": port_ngp(jn), "crf_weight": tt(w),
                            "radiance": tt(np.zeros((2, 3)))})
    return ds, bake, cache, jax_ckpt, port_ckpt


def _args(data, name, ckpt):
    ds, bake, cache, _, _ = data
    return (["--dataset", "synthetic", ds, "--ldr_img_dir", "ldr",
             "--voxel_path", os.path.join(bake, "vslf.npz"),
             "--emitter_path", os.path.join(bake, "emitter.npz"),
             "--cache_dir", cache, "--ckpt_path", ckpt, "--load_crf", "1",
             "--lp", "0.005", "--la", "0.01", "--l_crf_weight", "0.001",
             "--experiment_name", name] + CLI_TRAIN)


def test_train_brdf_crf_cli_matches_jax(data, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cap = capture_jax_training(monkeypatch, jbrdf)
    jbrdf.main(_args(data, "jax", data[3]))
    hcfg = cap["params"]["material"].cfg
    assert hcfg.row_gather and hcfg.stochastic_fwd and hcfg.bwd_level_sample
    key = jax.random.PRNGKey(0)
    train_brdf_crf.main(
        _args(data, "port", data[4]) + ["--device", "cpu"],
        samples_for_step=lambda s: jax_brdf_crf_draws(
            jax.random.fold_in(key, s), hcfg, B, N_PAIRS))

    want = logged_losses(os.path.join("outputs", "jax", "train_log.jsonl"))
    got = logged_losses(os.path.join("outputs", "port", "train_log.jsonl"))
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(STEPS))
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=2e-3)
    ref = jax_leaves_by_name(jax_load_pytree(os.path.join(
        "checkpoints", "jax", "last.pkl")))
    out = convert.leaves_to_numpy(load_pytree(os.path.join(
        "checkpoints", "port", "last.pkl"), "cpu"))
    assert set(out) == {"crf_weight", "material.table"} | {
        f"material.mlp.{k}.{i}" for k in "wb" for i in range(3)}
    bound, touched, start = jax_noise_bound(cap)
    # the warm start's CRF weights were loaded (--load_crf), then trained
    assert np.abs(start["crf_weight"]).max() > 0.05
    hold_leaves(out, ref, start, bound, touched, STEPS * 1e-3)


def test_train_brdf_crf_resume_gives_the_same_bits(data, tmp_path,
                                                    monkeypatch):
    """2 steps, then --resume to 3, against 3 steps in one run (the port's
    own generators): the same losses, last.pkl and last_state.pkl."""
    monkeypatch.chdir(tmp_path)
    full = _args(data, "full", data[4]) + ["--device", "cpu"]
    train_brdf_crf.main(full)
    part = _args(data, "part", data[4]) + ["--device", "cpu"]
    train_brdf_crf.main(part + ["--max_steps", "2"])
    train_brdf_crf.main(part + ["--resume"])
    assert logged_losses(os.path.join("outputs", "part", "train_log.jsonl")) \
        == logged_losses(os.path.join("outputs", "full", "train_log.jsonl"))
    same_checkpoints(os.path.join("checkpoints", "full"),
                     os.path.join("checkpoints", "part"),
                     ("last.pkl", "last_state.pkl"))
