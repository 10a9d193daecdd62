"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
carry JAX-package objects into the port through iris_tpu_torch.convert,
the hit-agreement bar for traversals, replays of the JAX package's key
streams (the uniforms its functions draw from a PRNG key, in the same
split/fold_in order) as the port's `samples` dicts, and the stage CLIs'
tiny dataset, JAX-run capture and Adam leaf rule."""

from __future__ import annotations

import numpy as np
import torch

from iris_tpu_torch import convert

DEV = "cpu"


def port_tracer(jt):
    return convert.tracer(
        nodes=np.asarray(jt.nodes), tris=np.asarray(jt.tris),
        face_normals=np.asarray(jt.face_normals), n_nodes=jt.n_nodes,
        leaf_size=jt.leaf_size, n_faces=jt.n_faces, layout=jt.layout,
        depth=jt.depth, device=DEV)


def port_ngp(jn):
    cfg = {k: getattr(jn.cfg, k) for k in convert.HASHGRID_FIELDS}
    return convert.ngp_brdf(
        table=np.asarray(jn.table),
        mlp_w=[np.asarray(w) for w in jn.mlp["w"]],
        mlp_b=[np.asarray(b) for b in jn.mlp["b"]],
        voxel_min=np.asarray(jn.voxel_min), voxel_max=np.asarray(jn.voxel_max),
        cfg=cfg, device=DEV)


def port_slf(js):
    return convert.voxel_slf(
        inds=np.asarray(js.inds), radiance=np.asarray(js.radiance),
        count=np.asarray(js.count), voxel_min=np.asarray(js.voxel_min),
        voxel_max=np.asarray(js.voxel_max), H=js.H, device=DEV)


def port_emitter(je):
    return convert.emitter(
        is_emitter=np.asarray(je.is_emitter),
        emitter_idx=np.asarray(je.emitter_idx),
        triangle_idx=np.asarray(je.triangle_idx),
        emitter_vertices=np.asarray(je.emitter_vertices),
        emitter_area=np.asarray(je.emitter_area),
        radiance=np.asarray(je.radiance),
        emitter_pdf=np.asarray(je.emitter_pdf),
        emitter_cdf=np.asarray(je.emitter_cdf),
        slf=None if je.slf is None else port_slf(je.slf), device=DEV)


def port_crf(jc):
    return convert.emor_crf(weight=np.asarray(jc.weight),
                            f0=np.asarray(jc.f0), basis=np.asarray(jc.basis),
                            device=DEV)


def tt(a, dtype=torch.float32):
    """numpy -> CPU tensor."""
    return torch.as_tensor(np.array(a), dtype=dtype)


def assert_hits_agree(t1, f1, t2, f2):
    """The traversal bar: hit/miss equal on >= 99.9% of rays; t within
    1e-5 relative where both hit; face ids equal except where the two
    walks met faces at t equal within 1e-6 (the first of equal-t hits in
    visiting order wins, and visiting orders differ)."""
    t1, t2 = np.asarray(t1, np.float64), np.asarray(t2, np.float64)
    f1, f2 = np.asarray(f1).astype(np.int64), np.asarray(f2).astype(np.int64)
    v1, v2 = f1 >= 0, f2 >= 0
    assert (v1 == v2).mean() >= 0.999, (v1 != v2).sum()
    both = v1 & v2
    np.testing.assert_allclose(t1[both], t2[both], rtol=1e-5)
    differ = both & (f1 != f2)
    tie = np.abs(t1 - t2) <= 1e-6 * np.maximum(1.0, np.abs(t1))
    assert np.all(tie[differ]), np.flatnonzero(differ & ~tie)


# ------------------------------------------------- gradients, leaf by leaf

def jax_leaves_by_name(tree) -> dict:
    """{leaf name: numpy} of a JAX pytree, named as the port names its
    leaves (iris_tpu_torch.train.optim.named_leaves)."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [str(getattr(k, "key", getattr(k, "name",
                                               getattr(k, "idx", k))))
                 for k in path]
        out[".".join(parts)] = np.asarray(leaf)
    return out


def cosine(a, b) -> float:
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


# ------------------------------------------------------ key-stream replays

def _np(x):
    return np.asarray(x)


def jax_hashgrid_draws(key, cfg, b: int) -> dict:
    """What hashgrid_encode(table, cfg, x (b, 3), key) draws
    (hashgrid.py:609-621, 663-671, 679), as the port's samples dict."""
    import jax

    l = cfg.n_levels
    stoch = cfg.stochastic_bwd or cfg.stochastic_fwd
    out = {}
    l_eff = l
    fwd_k = cfg.fwd_level_sample if (stoch and cfg.stochastic_fwd) else 0
    if fwd_k and 0 < fwd_k < l:
        key, k_f = jax.random.split(key)
        out["fphase"] = int(jax.random.randint(k_f, (), 0, l // fwd_k))
        l_eff = fwd_k
    bwd_k = cfg.bwd_level_sample if stoch else 0
    if bwd_k and 0 < bwd_k < l_eff:
        key, k_p = jax.random.split(key)
        out["phase"] = int(jax.random.randint(k_p, (), 0, l_eff // bwd_k))
    out["u3"] = tt(_np(jax.random.uniform(key, (3, b * l_eff))))
    return out


def jax_single_draws(key, b: int, spp: int) -> dict:
    """What path_tracing_single(key, ...) draws for b pixels at spp
    (integrator.py:195, 50, 92-97)."""
    import jax

    n = b * spp
    k_jit, k_b = jax.random.split(key)
    k1, k2, k3, k4 = jax.random.split(k_b, 4)
    return {
        "dudv": tt(_np(jax.random.uniform(k_jit, (2, b, spp, 1),
                                          minval=-0.5, maxval=0.5))),
        "s1": tt(_np(jax.random.uniform(k1, (n,)))),
        "s2": tt(_np(jax.random.uniform(k2, (n, 2)))),
        "s1b": tt(_np(jax.random.uniform(k3, (n,)))),
        "s2b": tt(_np(jax.random.uniform(k4, (n, 2)))),
    }


def jax_initialize_draws(key, hcfg, b: int, spp: int, rounds: int) -> dict:
    """The draws of make_initialize_loss's loss_fn (steps.py:210-228)."""
    import jax

    k_render, k_jit = jax.random.split(key)
    render = [jax_single_draws(jax.random.fold_in(k_render, r), b, spp)
              for r in range(rounds)]
    k_jit, k_mat = jax.random.split(k_jit)
    dudv = jax.random.uniform(k_jit, (2, b, 1), minval=-0.5, maxval=0.5)
    return {"render": render, "dudv": tt(_np(dudv)),
            "mat": jax_hashgrid_draws(k_mat, hcfg, b)}


def jax_emitter_draws(key, b: int, spp: int, rounds: int) -> dict:
    """The draws of make_train_emitter_loss's loss_fn (steps.py:255-259)."""
    import jax

    return {"render": [jax_single_draws(jax.random.fold_in(key, r), b, spp)
                       for r in range(rounds)]}


def jax_brdf_crf_draws(key, hcfg, b: int, n_pairs: int) -> dict:
    """The draws of make_brdf_crf_loss's loss_fn (steps.py:286, 150)."""
    import jax

    key, k_mat = jax.random.split(key)
    return {"mat": jax_hashgrid_draws(k_mat, hcfg, b),
            "pairs_u": tt(_np(jax.random.uniform(key, (b, n_pairs))))}


# ------------------------------------------------------------ stage CLIs

def write_cli_dataset(root, n_val=1):
    """The tiny dataset of the CLI parity tests, written by the port's
    generator (no JAX generator compiles): 16 x 20 pixels, 2 train frames,
    spp 4, depth 2; its SLF (16^3) and emitter mask under root/bake by the
    port's slf_bake and extract_emitter, which both packages read. With
    n_val=0 the val split is removed, so that neither package's trainer
    builds its validation hooks."""
    import os
    import shutil

    from iris_tpu_torch.data.make_demo_dataset import make_dataset
    from iris_tpu_torch.pipeline import extract_emitter, slf_bake

    ds = os.path.join(root, "ds")
    make_dataset(ds, img_hw=(16, 20), n_train=2, n_val=1, spp=4,
                 indir_depth=2, device=DEV)
    if n_val == 0:
        shutil.rmtree(os.path.join(ds, "val"))
    bake = os.path.join(root, "bake")
    s = ["--dataset", "synthetic", "--scene", ds, "--ldr_img_dir", "ldr",
         "--device", DEV, "--output", bake]
    slf_bake.main(s + ["--voxel_num", "16"])
    extract_emitter.main(s + ["--threshold", "0.99"])
    return ds, bake


# the tiny trainer settings: 4 levels x 16 features x 2^10 rows, batch 256,
# SPP 4 at spp 2 (two rounds), 3 steps in chunks of 2
CLI_TRAIN = ["--hash_levels", "4", "--log2_hashmap_size", "10",
             "--batch_size", "256", "--SPP", "4", "--spp", "2",
             "--indir_depth", "2", "--chunk_steps", "2", "--max_steps", "3",
             "--save_every", "2"]


def capture_jax_training(monkeypatch, module) -> dict:
    """Wrap a JAX stage module's run_training: keep its loss_fn, optimizer,
    key, start step, a copy of the starting params (the jitted step donates
    them) and every batch it takes."""
    import jax
    import jax.numpy as jnp

    cap = {"batches": []}
    real = module.run_training

    def run(loss_fn, params, batches, optimizer, n_steps, key, **kw):
        cap.update(loss_fn=loss_fn, optimizer=optimizer, key=key,
                   start=kw.get("start_step", 0),
                   params=jax.tree_util.tree_map(
                       lambda x: jnp.array(x, copy=True), params))

        def taken(it):
            for b in it:
                cap["batches"].append(b)
                yield b
        return real(loss_fn, params, taken(batches), optimizer, n_steps,
                    key, **kw)

    monkeypatch.setattr(module, "run_training", run)
    return cap


def jax_noise_bound(cap) -> tuple[dict, dict, dict]:
    """The JAX steps of a captured run replayed one by one (the key of
    step s is fold_in(key, s), as in both of run_training's paths):
    ({leaf name: entries whose JAX gradient was nonzero and below 0.15 of
    the leaf's largest at some step}, {leaf name: entries whose JAX
    gradient was nonzero at some step}, {leaf name: starting value}).
    Adam's normalized update gives the first kind a step of about +-lr
    whatever their size, so bf16 rounding can decide their sign (ROADMAP
    Queue 3)."""
    import jax
    import optax

    loss_fn, opt = cap["loss_fn"], cap["optimizer"]
    grad = jax.jit(jax.grad(lambda p, b, k: loss_fn(p, b, k)[0]))
    update = jax.jit(opt.update)
    params = cap["params"]
    start = jax_leaves_by_name(params)
    state = opt.init(params)
    bound, touched = {}, {}
    for i, batch in enumerate(cap["batches"]):
        g = grad(params, batch, jax.random.fold_in(cap["key"],
                                                   cap["start"] + i))
        for name, gl in jax_leaves_by_name(g).items():
            gl = np.abs(gl)
            bound[name] = bound.get(name, False) | (
                (gl > 0) & (gl < 0.15 * gl.max()))
            touched[name] = touched.get(name, False) | (gl > 0)
        updates, state = update(g, state, params)
        params = optax.apply_updates(params, updates)
    return bound, touched, start


def hold_leaves(got: dict, ref: dict, start: dict, bound: dict,
                touched: dict, lr_sum: float):
    """Adam's leaves, by the rule of test_torch_train.py's
    test_five_train_steps_match_optax: every entry not noise-bound within
    rtol 1e-4 / atol 2e-4; of the noise-bound entries of a leaf >= 80%
    within the same tolerance; no entry further than the 2 * sum(lr) that
    sign flips at every step can give; the leaf's movement at cosine >=
    0.99. Two departures, both for what a stage's loss does that the
    benchmark loss did not:

    - a corner bit of the stochastic encode can come out the other way
      (ROADMAP Queue 3: u3 < frac, with frac an ulp apart; the encode
      tests allow it for 0.5% of (query, level) pairs), and then the port
      steps a row the JAX run did not and leaves without that query's step
      a row the JAX run stepped: at most 0.5% of the entries the JAX
      gradient reached may lie outside the tolerance without being
      noise-bound;
    - the cosine is taken over the entries the JAX gradient reached and
      that are not noise-bound. A noise-bound entry moves by about +-lr
      whatever its gradient, so in a leaf made mostly of them (96% of the
      hash table's reached entries under train_brdf_crf's loss) the whole
      leaf's cosine measures their sign noise alone, which the 80% bar
      above already holds; and an entry the JAX gradient never reached
      moves in the port by a corner flip alone, held by the 0.5% bar."""
    for name, g in got.items():
        weak = bound[name].reshape(g.shape)
        reached = touched[name].reshape(g.shape)
        close = np.isclose(g, ref[name], rtol=1e-4, atol=2e-4)
        off = int((~weak & ~close).sum())
        assert off <= 0.005 * reached.sum(), (name, off, int(reached.sum()))
        assert not weak.any() or close[weak].mean() >= 0.8, (
            name, close[weak].mean())
        assert np.abs(g - ref[name]).max() <= 2 * lr_sum, name
        firm = reached & ~weak
        moved = (ref[name] - start[name])[firm]
        if np.abs(moved).max(initial=0) > 0:
            assert cosine((g - start[name])[firm], moved) >= 0.99, name


def logged_losses(path) -> list:
    """(step, loss) of a trainer's train_log.jsonl scalar records (either
    package's)."""
    import json

    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [(r["step"], r["loss"]) for r in recs if "loss" in r]


def same_tree(a, b) -> bool:
    """Two checkpoint trees (nested dicts and lists of numpy arrays and
    plain values) are the same, array bits included."""
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same_tree(x, y) for x, y in zip(a, b)))
    return a == b


def same_checkpoints(dir_a, dir_b, names) -> None:
    """The files `names` of two checkpoint directories hold the same
    trees."""
    import os
    import pickle

    for name in names:
        with open(os.path.join(dir_a, name), "rb") as f:
            a = pickle.load(f)
        with open(os.path.join(dir_b, name), "rb") as f:
            b = pickle.load(f)
        assert same_tree(a, b), name
