"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
carry JAX-package objects into the port through iris_tpu_torch.convert,
the hit-agreement bar for traversals, and replays of the JAX package's key
streams (the uniforms its functions draw from a PRNG key, in the same
split/fold_in order) as the port's `samples` dicts."""

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
