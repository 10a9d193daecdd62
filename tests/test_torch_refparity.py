"""The reference-parity slice as a whole, PyTorch port vs the JAX package,
at small size: a 12-clutter scene, an 8-level x 2-feature x 2^10 flat or
packed hash grid, spp 2, depth 2. path_tracing under replayed draws, and
four SGD steps of the benchmark loss through run_training on both sides,
chunk_steps 1 and 2; then what carries a model across: convert and the
demo scene's defaults.

Tolerances: radiance rtol 2e-3 / atol 1e-4 (the bf16 MLP sums its products
in another order, ROADMAP.md Queue 3); losses rtol 2e-3; every parameter
leaf after four SGD steps rtol 1e-4 / atol 1e-6."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_tpu.demo import demo_mat_fn as jax_mat_fn
from iris_tpu.demo import make_demo_scene as jax_demo_scene
from iris_tpu.geometry.procedural import camera_rays
from iris_tpu.models import crf as jcrf
from iris_tpu.models.brdf import ngp_brdf_apply as jax_ngp_apply
from iris_tpu.models.hashgrid import auto_bwd_level_sample
from iris_tpu.parallel.sharding import data_mesh
from iris_tpu.render import integrator as jint
from iris_tpu.train.loop import make_train_chunk as jax_make_train_chunk
from iris_tpu.train.loop import run_training as jax_run_training
from iris_tpu.train.optim import make_optimizer as jax_make_optimizer
from iris_tpu_torch import convert
from iris_tpu_torch.demo import demo_mat_fn, make_demo_scene
from iris_tpu_torch.models import crf as tcrf
from iris_tpu_torch.models.brdf import ngp_brdf_apply
from iris_tpu_torch.render import integrator as tint
from iris_tpu_torch.train.loop import make_train_chunk, run_training
from iris_tpu_torch.train.optim import make_optimizer
from torch_parity import (
    jax_hashgrid_draws, jax_leaves_by_name, jax_single_draws, port_crf,
    port_emitter, port_ngp, port_tracer, tt)

SPP = 2
DEPTH = 2
RTOL, ATOL = 2e-3, 1e-4
LEVELS = 8


@pytest.fixture(scope="module")
def scene():
    """JAX objects of the small scene; the table's four coarse levels vary
    the material over the room, the fine ones keep their init scale."""
    tracer, em, ngp, crf, _ = jax_demo_scene(
        n_clutter=12, slf_res=16, hash_levels=LEVELS, log2_table=10,
        hash_features=2, per_level_scale=1.3)
    assert ngp.table.ndim == 1 and ngp.cfg.packed_gather
    rng = np.random.default_rng(0)
    rad = rng.uniform(0, 1, em.slf.radiance.shape).astype(np.float32)
    rad[::3] = 0.0
    em = dataclasses.replace(em, slf=dataclasses.replace(
        em.slf, radiance=jnp.asarray(rad)))
    table = np.asarray(ngp.table).reshape(2, LEVELS, -1).copy()
    table[:, :4] = rng.uniform(-1, 1, table[:, :4].shape)
    ngp = dataclasses.replace(ngp, table=jnp.asarray(table.reshape(-1)))
    crf = dataclasses.replace(crf, weight=jnp.asarray(
        rng.normal(0, 0.05, (3, 3)).astype(np.float32)))
    o, d, dxdu, dydv = camera_rays(8)
    rays = np.concatenate([o, d, dxdu, dydv], -1).astype(np.float32)
    return tracer, em, ngp, crf, rays


def _with_cfg(ngp, **fields):
    return dataclasses.replace(ngp, cfg=dataclasses.replace(ngp.cfg,
                                                            **fields))


def _render_samples(seed, b, spp, depth):
    rng = np.random.default_rng(seed)
    n = b * spp

    def u(*shape):
        return rng.uniform(0, 1, shape).astype(np.float32)

    return {"dudv": u(2, b, spp, 1) - 0.5, "s1": u(n), "s2": u(n, 2),
            "s1b": u(n), "s2b": u(n, 2),
            "indirect": {"s1": u(depth, n), "s2": u(depth, n, 2),
                         "s1b": u(depth, n), "s2b": u(depth, n, 2)}}


def _map(f, s):
    return {k: _map(f, v) if isinstance(v, dict) else f(v)
            for k, v in s.items()}


@pytest.mark.parametrize("packed", [False, True])
def test_path_tracing_flat_and_packed(scene, packed):
    """A render reads the exact 8-corner encode: float32 features from the
    flat table, bfloat16 ones from the packed table."""
    jt, je, jn, _, rays = scene
    jn = _with_cfg(jn, packed_gather=packed)
    pn = port_ngp(jn)
    assert pn.table.dim() == 1 and pn.cfg.packed_gather is packed
    r = [rays[:, i:i + 3] for i in (0, 3, 6, 9)]
    s = _render_samples(1, rays.shape[0], SPP, DEPTH)
    ref = jax.jit(lambda sm, *rr: jint.path_tracing(
        jax.random.PRNGKey(0), jt, je, jax_mat_fn(jn), *rr, SPP, DEPTH,
        samples=sm))(_map(jnp.asarray, s), *map(jnp.asarray, r))
    out = tint.path_tracing(None, port_tracer(jt), port_emitter(je),
                            demo_mat_fn(pn), *map(tt, r), SPP, DEPTH,
                            samples=_map(tt, s))
    assert np.abs(np.asarray(ref)).max() > 0
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def test_packed_render_reads_bfloat16_features(scene):
    """The packed and the flat render of one table differ (by the bf16
    rounding of the features), so the two cases above are two paths."""
    jt, je, jn, _, rays = scene
    r = [tt(rays[:, i:i + 3]) for i in (0, 3, 6, 9)]
    s = _map(tt, _render_samples(1, rays.shape[0], SPP, DEPTH))
    outs = [tint.path_tracing(
        None, port_tracer(jt), port_emitter(je),
        demo_mat_fn(port_ngp(_with_cfg(jn, packed_gather=packed))), *r, SPP,
        DEPTH, samples=s) for packed in (False, True)]
    assert not torch.equal(outs[0], outs[1])
    assert float((outs[0] - outs[1]).abs().max()) < 0.2


# ------------------------------------------------------------ run_training

def _loss_jax(jt, je, jc):
    def loss_fn(p, batch, key):
        rays = batch["rays"]
        o, d, dxdu, dydv = (rays[:, i:i + 3] for i in (0, 3, 6, 9))
        em2 = dataclasses.replace(je, radiance=p["radiance"])
        crf2 = dataclasses.replace(jc, weight=p["crf_w"])
        key, k_mat = jax.random.split(key)
        mat_fn = functools.partial(jax_ngp_apply, p["material"], key=k_mat)
        l = jint.path_tracing_single(key, jt, em2, mat_fn, o, d, dxdu, dydv,
                                     SPP)
        loss = jnp.mean((jcrf.crf_forward(crf2, l, 1.0) - 0.5) ** 2)
        return loss, {"loss": loss}

    return loss_fn


def _loss_port(pt, pe, pc):
    def loss_fn(p, batch, gen, samples=None):
        rays = batch["rays"]
        o, d, dxdu, dydv = (rays[:, i:i + 3] for i in (0, 3, 6, 9))
        em2 = dataclasses.replace(pe, radiance=p["radiance"])
        crf2 = dataclasses.replace(pc, weight=p["crf_w"])
        mat_fn = functools.partial(
            ngp_brdf_apply, p["material"], gen=gen,
            samples=None if samples is None else samples["mat"])
        l = tint.path_tracing_single(
            gen, pt, em2, mat_fn, o, d, dxdu, dydv, SPP,
            samples=None if samples is None else samples["render"])
        loss = torch.mean((tcrf.crf_forward(crf2, l, 1.0) - 0.5) ** 2)
        return loss, {"loss": loss}

    return loss_fn


def _step_draws(key, step, hcfg, b):
    """What the JAX loss above draws at one step of run_training
    (loop.py:180 fold_in, then the loss's own split)."""
    key, k_mat = jax.random.split(jax.random.fold_in(key, step))
    return {"render": jax_single_draws(key, b, SPP),
            "mat": jax_hashgrid_draws(k_mat, hcfg, b * SPP)}


@pytest.mark.parametrize("chunk_steps", [1, 2])
@pytest.mark.parametrize("packed", [False, True])
def test_four_run_training_steps_match_jax(scene, packed, chunk_steps):
    """The trainers' estimator settings (stochastic forward and backward,
    auto level-block subsampling = 2 of 8, compact scatter) on the flat and
    the packed table, SGD lr 1e-2, four steps through run_training in both
    packages on one device."""
    jt, je, jn, jc, rays = scene
    jn = _with_cfg(jn, packed_gather=packed, stochastic_fwd=True,
                   stochastic_bwd=True,
                   bwd_level_sample=auto_bwd_level_sample(LEVELS))
    assert jn.cfg.bwd_level_sample == 2
    n_steps = 4
    # two pixel batches in turn, so the iterator's position matters
    batches = [{"rays": rays}, {"rays": rays[::-1].copy()}] * 2
    key = jax.random.PRNGKey(9)
    kw = dict(learning_rate=1e-2, milestones=(2,), optimizer="SGD")

    jlosses = []
    # fresh buffers: the jitted step donates params and opt_state
    jparams = jax_run_training(
        _loss_jax(jt, je, jc),
        jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), {
            "material": jn, "radiance": je.radiance, "crf_w": jc.weight}),
        iter(batches), jax_make_optimizer(**kw), n_steps, key,
        mesh=data_mesh(1), log_fn=None, chunk_steps=chunk_steps,
        hooks=[lambda s, p, loss, aux: jlosses.append((s, float(loss)))])

    pt, pe, pn, pc = (port_tracer(jt), port_emitter(je), port_ngp(jn),
                      port_crf(jc))
    pparams = {"material": pn, "radiance": pe.radiance.clone(),
               "crf_w": pc.weight.clone()}
    start = convert.leaves_to_numpy(pparams)
    plosses = []
    b = rays.shape[0]
    out = run_training(
        _loss_port(pt, pe, pc), pparams,
        iter({k: tt(v) for k, v in bt.items()} for bt in batches),
        make_optimizer(**kw), n_steps, seed=0, log_fn=None,
        chunk_steps=chunk_steps,
        hooks=[lambda s, p, loss, aux: plosses.append((s, float(loss)))],
        samples_for_step=lambda s: _step_draws(key, s, jn.cfg, b))
    assert out is pparams
    assert [s for s, _ in plosses] == [s for s, _ in jlosses] == [0, 1, 2, 3]
    np.testing.assert_allclose([v for _, v in plosses],
                               [v for _, v in jlosses], rtol=2e-3)
    ref = jax_leaves_by_name(jparams)
    got = convert.leaves_to_numpy(pparams)
    assert len(got) == 9 and got["material.table"].ndim == 1
    for name, g in got.items():
        assert np.abs(g - start[name]).max() > 0, name      # it moved
        np.testing.assert_allclose(g, ref[name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    # the table moved in the sampled level blocks only: <= 2 of 8 levels
    # per step, both features alike
    moved = np.abs(got["material.table"] - start["material.table"]) \
        .reshape(2, LEVELS, -1).sum(2) > 0
    assert (moved[0] == moved[1]).all() and 2 <= moved[0].sum() <= LEVELS


def test_make_train_chunk_matches_jax(scene):
    """make_train_chunk in both packages: three SGD steps of the benchmark
    loss from step0 = 5 in one chunk (one lax.scan on a one-device mesh;
    the port's eager steps on the CPU), the rate cut by the milestone at
    the chunk's second step, under the JAX chunk's replayed keys
    (fold_in(key, step0 + j)): losses (K,) and auxes {name: (K,)} within
    rtol 2e-3, every leaf within rtol 1e-4 / atol 1e-6, as four
    run_training steps are held."""
    jt, je, jn, jc, rays = scene
    jn = _with_cfg(jn, stochastic_fwd=True, stochastic_bwd=True,
                   bwd_level_sample=auto_bwd_level_sample(LEVELS))
    k, step0 = 3, 5
    batches = [{"rays": rays}, {"rays": rays[::-1].copy()},
               {"rays": rays[::2].repeat(2, 0)}]
    key = jax.random.PRNGKey(4)
    kw = dict(learning_rate=1e-2, milestones=(1,), optimizer="SGD")
    jopt = jax_make_optimizer(**kw)
    jparams = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), {
        "material": jn, "radiance": je.radiance, "crf_w": jc.weight})
    jchunk = jax_make_train_chunk(_loss_jax(jt, je, jc), jopt, data_mesh(1),
                                  k)
    jparams, _, jlosses, jauxes = jchunk(
        jparams, jopt.init(jparams),
        {"rays": np.stack([b["rays"] for b in batches])}, key,
        jnp.int32(step0))

    pparams = {"material": port_ngp(jn),
               "radiance": port_emitter(je).radiance.clone(),
               "crf_w": port_crf(jc).weight.clone()}
    start = convert.leaves_to_numpy(pparams)
    opt = make_optimizer(**kw)
    chunk = make_train_chunk(_loss_port(port_tracer(jt), port_emitter(je),
                                        port_crf(jc)), opt, k)
    b = rays.shape[0]
    out, _, losses, auxes = chunk(
        pparams, opt.init(pparams),
        [{"rays": tt(v["rays"])} for v in batches], 0, step0,
        samples_for_step=lambda s: _step_draws(key, s, jn.cfg, b))
    assert out is pparams and losses.shape == (k,)
    assert set(auxes) == {"loss"} and auxes["loss"].shape == (k,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=2e-3)
    np.testing.assert_allclose(auxes["loss"].numpy(),
                               np.asarray(jauxes["loss"]), rtol=2e-3)
    ref = jax_leaves_by_name(jparams)
    for name, g in convert.leaves_to_numpy(pparams).items():
        assert np.abs(g - start[name]).max() > 0, name
        np.testing.assert_allclose(g, ref[name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)


# ------------------------------------------------- convert and the demo

@pytest.mark.parametrize("mode", ["flat", "packed", "row", "row_native"])
def test_converted_table_keeps_its_layout(scene, mode):
    """A JAX NGPBrdf state -> port -> leaves_to_numpy returns the arrays
    it was given, in the layout it was given, and every config field."""
    _, _, jn, _, _ = scene
    rng = np.random.default_rng(3)
    n = LEVELS * 1024
    if mode in ("flat", "packed"):
        jn = _with_cfg(jn, packed_gather=mode == "packed",
                       fwd_block_gather=mode == "flat")
        table = rng.uniform(-1, 1, 2 * n).astype(np.float32)
    else:
        jn = _with_cfg(jn, row_gather=True,
                       row_native_layout=mode == "row_native")
        table = rng.uniform(-1, 1, 2 * n).astype(np.float32)
        if mode == "row_native":
            table = table.reshape(n, 2)
    jn = dataclasses.replace(jn, table=jnp.asarray(table))
    pn = port_ngp(jn)
    assert dataclasses.asdict(pn.cfg) == dataclasses.asdict(jn.cfg)
    assert pn.table.shape == ((2 * n,) if mode in ("flat", "packed")
                              else (n, 2))
    back = convert.leaves_to_numpy({"material": pn})
    ref = jax_leaves_by_name({"material": jn})
    assert set(back) == {k for k in ref
                         if not k.endswith(("voxel_min", "voxel_max"))}
    for name, a in back.items():
        assert a.shape == ref[name].shape, name
        np.testing.assert_array_equal(a, ref[name], err_msg=name)
    # the encode reads the converted table as the JAX package reads its own
    from iris_tpu.models.hashgrid import hashgrid_encode as jax_encode
    from iris_tpu_torch.models.hashgrid import hashgrid_encode
    x = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    np.testing.assert_allclose(
        hashgrid_encode(pn.table, pn.cfg, tt(x)).numpy(),
        np.asarray(jax_encode(jn.table, jn.cfg, jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)


def test_convert_refuses_a_table_of_the_wrong_shape(scene):
    _, _, jn, _, _ = scene
    cfg = {k: getattr(jn.cfg, k) for k in convert.HASHGRID_FIELDS}
    args = dict(mlp_w=[], mlp_b=[], voxel_min=0.0, voxel_max=1.0,
                device="cpu")
    with pytest.raises(ValueError, match="2-D table"):
        convert.ngp_brdf(np.zeros((LEVELS * 1024, 2), np.float32), cfg=cfg,
                         **args)
    with pytest.raises(ValueError, match="values for a"):
        convert.ngp_brdf(np.zeros(100, np.float32), cfg=cfg, **args)


DEMO_ARGS = [
    {},
    dict(hash_levels=32, log2_table=12),
    dict(hash_levels=4, log2_table=10, hash_features=16,
         per_level_scale=-1.0),
    dict(hash_levels=8, log2_table=10, hash_features=8, per_level_scale=0.0,
         slf_res=16, leaf_size=5),
]


@pytest.mark.parametrize("kwargs", DEMO_ARGS,
                         ids=["defaults", "32x2", "4x16", "8x8"])
def test_demo_scene_builds_the_jax_demo_model(kwargs):
    """The same arguments give the same HashGridConfig fields, table
    layout, SLF size and tree in both packages."""
    jt, je, jn, jc, _ = jax_demo_scene(n_clutter=4, **kwargs)
    pt, pe, pn, pc, _ = make_demo_scene(n_clutter=4, device="cpu", **kwargs)
    assert dataclasses.asdict(pn.cfg) == dataclasses.asdict(jn.cfg)
    row = kwargs.get("hash_features", 2) > 2
    assert pn.cfg.row_gather is row
    n = jn.cfg.n_levels * jn.cfg.table_size
    assert pn.table.shape == ((n, jn.cfg.n_features) if row
                              else (n * jn.cfg.n_features,))
    assert pn.table.numel() == jn.table.size
    assert tuple(pe.slf.radiance.shape) == tuple(je.slf.radiance.shape)
    assert [tuple(w.shape) for w in pn.mlp["w"]] == \
        [tuple(w.shape) for w in jn.mlp["w"]]
    assert (pt.n_nodes, pt.leaf_size, pt.depth) == \
        (jt.n_nodes, jt.leaf_size, jt.depth)
    np.testing.assert_array_equal(pt.nodes.numpy(), np.asarray(jt.nodes))
    assert pc.weight.shape == tuple(jc.weight.shape)
