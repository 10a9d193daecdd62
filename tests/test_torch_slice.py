"""The render slice, PyTorch port vs the JAX package, under common random
numbers: path_tracing, the path_tracing_single forward, render_chunk and
aov_chunk on a small demo scene (4 clutter boxes, 2 hash levels x 16
features, 64 pixels, spp 2).

Tolerance on radiance and AOVs: rtol 2e-3, atol 1e-4. The bf16 MLP rounds
its operands alike in both packages but sums the products in another
order, and gathers and reductions run in other orders, so materials differ
in the last bits and the image by a little more after a few bounces."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_tpu.demo import demo_mat_fn as jax_mat_fn
from iris_tpu.demo import make_demo_scene as jax_demo_scene
from iris_tpu.geometry.procedural import camera_rays
from iris_tpu.pipeline.render import make_render_fns as jax_render_fns
from iris_tpu.render import integrator as jint
from iris_tpu_torch.demo import demo_mat_fn
from iris_tpu_torch.pipeline.render import make_render_fns
from iris_tpu_torch.render import integrator as tint
from torch_parity import port_emitter, port_ngp, port_tracer, tt

SPP = 2
DEPTH = 2
RTOL, ATOL = 2e-3, 1e-4


@pytest.fixture(scope="module")
def scene():
    tracer, em, ngp, _, _ = jax_demo_scene(
        n_clutter=4, slf_res=16, hash_levels=2, log2_table=10,
        hash_features=16, per_level_scale=-1.0)
    rng = np.random.default_rng(0)
    # nonzero radiance cache, so the cache-termination branch runs
    rad = rng.uniform(0, 1, em.slf.radiance.shape).astype(np.float32)
    rad[::3] = 0.0
    em = dataclasses.replace(em, slf=dataclasses.replace(
        em.slf, radiance=jnp.asarray(rad)))
    # the coarse level varies the material over the scene; the fine level
    # (54K cells across) keeps its init scale, or position rounding noise
    # (~1e-7) would move the field by ~1e-2
    table = np.asarray(ngp.table).reshape(2, -1, 16).copy()
    table[0] = rng.uniform(-1, 1, table[0].shape)
    ngp = dataclasses.replace(ngp, table=jnp.asarray(table.reshape(-1)))
    o, d, dxdu, dydv = camera_rays(8)
    rays = np.concatenate([o, d, dxdu, dydv], -1).astype(np.float32)
    jax_side = (tracer, em, jax_mat_fn(ngp))
    port_side = (port_tracer(tracer), port_emitter(em),
                 demo_mat_fn(port_ngp(ngp)))
    return jax_side, port_side, rays


def _samples(seed, b, spp, depth, indirect=True):
    rng = np.random.default_rng(seed)
    n = b * spp

    def u(*shape):
        return rng.uniform(0, 1, shape).astype(np.float32)

    s = {"dudv": u(2, b, spp, 1) - 0.5, "s1": u(n), "s2": u(n, 2),
         "s1b": u(n), "s2b": u(n, 2)}
    if indirect:
        s["indirect"] = {"s1": u(depth, n), "s2": u(depth, n, 2),
                         "s1b": u(depth, n), "s2b": u(depth, n, 2)}
    return s


def _map(f, s):
    return {k: _map(f, v) if isinstance(v, dict) else f(v)
            for k, v in s.items()}


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def _ray_args(rays):
    return rays[:, :3], rays[:, 3:6], rays[:, 6:9], rays[:, 9:12]


def test_path_tracing(scene):
    (jt, je, jm), (pt, pe, pm), rays = scene
    s = _samples(1, rays.shape[0], SPP, DEPTH)
    ref = jax.jit(lambda sm, *r: jint.path_tracing(
        jax.random.PRNGKey(0), jt, je, jm, *r, SPP, DEPTH, samples=sm))(
        _map(jnp.asarray, s), *map(jnp.asarray, _ray_args(rays)))
    out = tint.path_tracing(None, pt, pe, pm, *map(tt, _ray_args(rays)), SPP,
                            DEPTH, samples=_map(tt, s))
    assert np.abs(np.asarray(ref)).max() > 0
    _close(out.detach(), ref)


def _counting(mat_fn):
    """mat_fn, and a list that gets one entry per call of it."""
    calls = []

    def counted(x):
        calls.append(x.shape[0])
        return mat_fn(x)

    return counted, calls


def _path_tracing_second_eval(gen, tracer, em, mat_fn, rays_o, rays_d,
                              dx_du, dy_dv, spp, depth, samples=None):
    """path_tracing as the JAX package writes it: trace_indirect's start
    material evaluated again at the first bounce's hit points."""
    b = rays_o.shape[0]
    position, normal, wo, mat, l, active = tint._first_hit(
        gen, tracer, em, mat_fn, rays_o, rays_d, dx_du, dy_dv, spp, samples)
    nee, bounce, pos_n, nrm_n, wo_n, _, active_n, brdf_w = \
        tint._nee_and_bounce(gen, tracer, em, mat_fn, position, wo, normal,
                             mat, active, 1e-6, 0.0, trace_roughness=None,
                             samples=samples)
    l = l + nee + bounce
    with torch.no_grad():
        mat_again = mat_fn(pos_n)
    l_indir = tint.trace_indirect(
        gen, tracer, em, mat_fn, pos_n, wo_n, nrm_n, mat_again, active_n,
        depth, samples=None if samples is None else samples["indirect"])
    l = l + torch.where(active_n[:, None], brdf_w * l_indir, 0.0)
    return l.reshape(b, spp, 3).mean(1)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_path_tracing_evaluates_the_first_bounce_material_once(scene,
                                                               depth):
    """One material evaluation at the camera hits, one per bounce: D + 2
    in all (the JAX package's trace_indirect makes a D + 3rd at the first
    bounce's hit points, which the port takes from _nee_and_bounce)."""
    _, (pt, pe, pm), rays = scene
    counted, calls = _counting(pm)
    s = _samples(3, rays.shape[0], SPP, depth)
    tint.path_tracing(None, pt, pe, counted, *map(tt, _ray_args(rays)), SPP,
                      depth, samples=_map(tt, s))
    n = rays.shape[0] * SPP
    assert calls == [n, n] + [n] * depth


@pytest.mark.parametrize("draws", ["samples", "generator"])
def test_path_tracing_equals_the_second_evaluation(scene, draws):
    """The render's material makes no draws, so the material passed to
    trace_indirect is the second evaluation's, bit for bit: the image is
    the same bits, under replayed draws and under a generator."""
    _, (pt, pe, pm), rays = scene
    args = (pt, pe, pm, *map(tt, _ray_args(rays)), SPP, DEPTH)
    if draws == "samples":
        s = _map(tt, _samples(4, rays.shape[0], SPP, DEPTH))
        got = tint.path_tracing(None, *args, samples=s)
        want = _path_tracing_second_eval(None, *args, samples=s)
    else:
        got = tint.path_tracing(torch.Generator().manual_seed(9), *args)
        want = _path_tracing_second_eval(torch.Generator().manual_seed(9),
                                         *args)
    assert float(want.abs().max()) > 0
    assert torch.equal(got, want)


def test_path_tracing_single_forward(scene):
    (jt, je, jm), (pt, pe, pm), rays = scene
    s = _samples(2, rays.shape[0], SPP, DEPTH, indirect=False)
    ref = jax.jit(lambda sm, *r: jint.path_tracing_single(
        jax.random.PRNGKey(0), jt, je, jm, *r, SPP, samples=sm))(
        _map(jnp.asarray, s), *map(jnp.asarray, _ray_args(rays)))
    out = tint.path_tracing_single(None, pt, pe, pm,
                                   *map(tt, _ray_args(rays)), SPP,
                                   samples=_map(tt, s))
    _close(out.detach(), ref)


def _jax_render_draws(key, b, spp, depth):
    """The uniforms JAX's render_chunk draws from `key` inside
    path_tracing (integrator.py:265, :92-97, :246), as a samples dict."""
    n = b * spp
    k_jit, k_b, k_ind = jax.random.split(key, 3)

    def bounce(k):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        return {"s1": jax.random.uniform(k1, (n,)),
                "s2": jax.random.uniform(k2, (n, 2)),
                "s1b": jax.random.uniform(k3, (n,)),
                "s2b": jax.random.uniform(k4, (n, 2))}

    s = bounce(k_b)
    s["dudv"] = jax.random.uniform(k_jit, (2, b, spp, 1), minval=-0.5,
                                   maxval=0.5)
    per_depth = [bounce(k) for k in jax.random.split(k_ind, depth)]
    s["indirect"] = {k: jnp.stack([p[k] for p in per_depth])
                     for k in per_depth[0]}
    return s


def test_render_chunk(scene):
    (jt, je, jm), (pt, pe, pm), rays = scene
    key = jax.random.PRNGKey(42)
    ref = jax_render_fns(jt, je, jm, SPP, DEPTH)[0](jnp.asarray(rays), key)
    s = _jax_render_draws(key, rays.shape[0], SPP, DEPTH)
    render_chunk, _ = make_render_fns(pt, pe, pm, SPP, DEPTH)
    out = render_chunk(tt(rays), samples=_map(lambda x: tt(np.asarray(x)),
                                               s))
    _close(out, ref)


def test_aov_chunk(scene):
    (jt, je, jm), (pt, pe, pm), rays = scene
    key = jax.random.PRNGKey(7)
    ref = jax_render_fns(jt, je, jm, SPP, DEPTH)[1](jnp.asarray(rays), key)
    b = rays.shape[0]
    # JAX's AOV draws (render.py:49,57): jitter in [0, 1), not centred
    s = {"dudv": np.asarray(jax.random.uniform(key, (2, b, SPP, 1))),
         "s2": np.asarray(jax.random.uniform(jax.random.fold_in(key, 1),
                                             (b * SPP, 2)))}
    _, aov_chunk = make_render_fns(pt, pe, pm, SPP, DEPTH)
    out = aov_chunk(tt(rays), samples=_map(tt, s))
    assert len(out) == len(ref) == 6
    for a, r in zip(out, ref):
        _close(a, r)
