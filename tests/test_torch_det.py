"""The deterministic integrators of the shading bakes, PyTorch port vs the
JAX package: the diffuse lobe and ConstantBRDF of models/brdf.py,
path_tracing_det_diff and path_tracing_det_spec under common random
numbers (the same `samples` dict in both) on a small demo scene, and the
two analytic oracles of tests/test_oracles.py re-run on the port.

Tolerances: the analytic lobe functions and ConstantBRDF 1e-6; the det
integrators with ConstantBRDF (no MLP) rtol 1e-5 / atol 1e-6; with the NGP
material under the exact encode, 95% of values within rtol 2e-3 / atol
1e-4 (the bf16 MLP sums, ROADMAP Queue 3, can move a material value by
~1e-3 and with it a cache gate or a lobe)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_tpu.demo import demo_mat_fn as jax_mat_fn
from iris_tpu.demo import make_demo_scene as jax_demo_scene
from iris_tpu.geometry.intersect import ray_intersect as jax_intersect
from iris_tpu.geometry.procedural import camera_rays
from iris_tpu.models import brdf as JB
from iris_tpu.render import integrator as jint
from iris_tpu_torch.demo import demo_mat_fn
from iris_tpu_torch.geometry.bvh import build_bvh
from iris_tpu_torch.geometry.mesh import Mesh
from iris_tpu_torch.models import brdf as TB
from iris_tpu_torch.models import emitter as TE
from iris_tpu_torch.render import integrator as tint
from test_oracles import _form_factor_polygon, _ggx_terms_np
from torch_parity import port_emitter, port_ngp, port_tracer, tt

SPP = 4
DEPTH = 2
NGP_RTOL, NGP_ATOL, NGP_SHARE = 2e-3, 1e-4, 0.95


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_eval_and_sample_diffuse():
    rng = np.random.default_rng(0)
    nrm, wi = _unit(rng, 257), _unit(rng, 257)
    s2 = rng.uniform(0, 1, (257, 2)).astype(np.float32)
    for got, want in zip(TB.eval_diffuse(tt(wi), tt(nrm)),
                         JB.eval_diffuse(jnp.asarray(wi), jnp.asarray(nrm))):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    for got, want in zip(TB.sample_diffuse(tt(s2), tt(nrm)),
                         JB.sample_diffuse(jnp.asarray(s2),
                                           jnp.asarray(nrm))):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("shape", [(), (1,)])
def test_constant_brdf_apply(shape):
    albedo = np.asarray([0.2, 0.5, 0.7], np.float32)
    rough = np.full(shape, 0.35, np.float32)
    metal = np.full(shape, 0.1, np.float32)
    pos = np.zeros((5, 3), np.float32)
    got = TB.constant_brdf_apply(TB.ConstantBRDF(tt(albedo), tt(rough),
                                                 tt(metal)), tt(pos))
    want = JB.constant_brdf_apply(JB.ConstantBRDF(
        jnp.asarray(albedo), jnp.asarray(rough), jnp.asarray(metal)),
        jnp.asarray(pos))
    for k in ("albedo", "roughness", "metallic"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)


def test_sample_specular_takes_a_scalar_level():
    """bake_shading passes one roughness level for the whole batch: the
    same bits as the level broadcast to (B, 1) by hand, and the JAX
    package's values within rtol 1e-4 (the GGX pdf goes through arccos,
    sqrt and a division by a clamped cosine, a few ulps apart in the two
    libraries)."""
    rng = np.random.default_rng(1)
    nrm, wo = _unit(rng, 64), _unit(rng, 64)
    s2 = rng.uniform(0, 1, (64, 2)).astype(np.float32)
    got = TB.sample_specular(tt(s2), tt(wo), tt(nrm), 0.412)
    by_hand = TB.sample_specular(tt(s2), tt(wo), tt(nrm),
                                 torch.full((64, 1), 0.412))
    want = JB.sample_specular(jnp.asarray(s2), jnp.asarray(wo),
                              jnp.asarray(nrm), jnp.float32(0.412))
    for g, b, w in zip(got, by_hand, want):
        assert torch.equal(g, b)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


def test_sharpest_level_gap_is_a_fused_multiply_add():
    """The bakes' sharpest level (roughness 0.02, alpha^2 = 1.6e-7) is
    held by share in test_torch_stages: its half vector comes from
    c2 = (1 - u) / (u (alpha^2 - 1) + 1), which cancels for u near 1. The
    port rounds the product and the sum apart; the cause named is that
    XLA rounds them once (a fused multiply-add). The witness: the port's
    sampler with that denominator rounded once (the product of two
    float32 values is exact in float64, then the sum is rounded to
    float32) gives the JAX package's jitted directions within 1e-6, where
    the port's own directions are further apart."""
    from iris_tpu_torch.core.vecmath import (
        angle2xyz, get_normal_space, normalize, reflect, to_world,
    )

    rng = np.random.default_rng(5)
    n = 4096
    nrm, wo = _unit(rng, n), _unit(rng, n)
    wo = np.where((wo * nrm).sum(-1, keepdims=True) < 0, -wo, wo)
    s2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    rough = np.full((n, 1), 0.02, np.float32)
    want = np.asarray(jax.jit(JB.specular_sampler)(
        jnp.asarray(s2), jnp.asarray(rough), jnp.asarray(wo),
        jnp.asarray(nrm)))
    own = TB.specular_sampler(tt(s2), tt(rough), tt(wo), tt(nrm)).numpy()

    # the port's specular_sampler, its denominator rounded once
    alpha = rough[:, 0] * rough[:, 0]
    u = s2[:, 0]
    den = (u.astype(np.float64) * (alpha * alpha - np.float32(1.0))
           .astype(np.float64) + 1.0).astype(np.float32)
    c2 = tt((np.float32(1.0) - u) / den)
    theta = torch.arccos(torch.sqrt(torch.clamp(c2, 0.0, 1.0)))
    wh = to_world(get_normal_space(tt(nrm)),
                  angle2xyz(theta, 2.0 * TB.PI * tt(s2[:, 1])))
    fused = normalize(reflect(tt(wo), wh)).numpy()

    gap_own = np.abs(own - want).max()
    gap_fused = np.abs(fused - want).max()
    assert gap_fused <= 1e-6, gap_fused
    assert gap_own > 10 * max(gap_fused, 1e-7), (gap_own, gap_fused)


@pytest.fixture(scope="module")
def scene():
    tracer, em, ngp, _, _ = jax_demo_scene(
        n_clutter=4, slf_res=16, hash_levels=2, log2_table=10,
        hash_features=16, per_level_scale=-1.0)
    rng = np.random.default_rng(0)
    rad = rng.uniform(0, 1, em.slf.radiance.shape).astype(np.float32)
    rad[::3] = 0.0
    em = dataclasses.replace(em, slf=dataclasses.replace(
        em.slf, radiance=jnp.asarray(rad)))
    # the coarse level varies the material; the fine level keeps its init
    # scale (test_torch_slice.py says why)
    table = np.asarray(ngp.table).reshape(2, -1, 16).copy()
    table[0] = rng.uniform(-1, 1, table[0].shape)
    ngp = dataclasses.replace(ngp, table=jnp.asarray(table.reshape(-1)))
    o, d, _, _ = camera_rays(8)
    pos, nrm, uv, tri, _ = jax_intersect(tracer, jnp.asarray(o),
                                         jnp.asarray(d))
    hits = tuple(np.asarray(x) for x in (pos, d, nrm, uv, tri))
    assert (hits[4] >= 0).mean() > 0.5
    const = (np.asarray([0.6, 0.4, 0.3], np.float32),
             np.asarray([0.45], np.float32), np.asarray([0.2], np.float32))
    return {"jax": (tracer, em, jax_mat_fn(ngp),
                    functools.partial(JB.constant_brdf_apply,
                                      JB.ConstantBRDF(*map(jnp.asarray,
                                                           const)))),
            "port": (port_tracer(tracer), port_emitter(em),
                     demo_mat_fn(port_ngp(ngp)),
                     functools.partial(TB.constant_brdf_apply,
                                       TB.ConstantBRDF(*map(tt, const)))),
            "hits": hits}


def _det_samples(seed, n, depth):
    rng = np.random.default_rng(seed)

    def u(*shape):
        return rng.uniform(0, 1, shape).astype(np.float32)

    return {"det_s2": u(n, 2),
            "indirect": {"s1": u(depth, n), "s2": u(depth, n, 2),
                         "s1b": u(depth, n), "s2b": u(depth, n, 2)}}


def _map(f, s):
    return {k: _map(f, v) if isinstance(v, dict) else f(v)
            for k, v in s.items()}


def _run_det(scene, kind, material, seed):
    jt, je, jm_ngp, jm_const = scene["jax"]
    pt, pe, pm_ngp, pm_const = scene["port"]
    jm, pm = ((jm_ngp, pm_ngp) if material == "ngp"
              else (jm_const, pm_const))
    pos, wis, nrm, uv, tri = scene["hits"]
    s = _det_samples(seed, pos.shape[0] * SPP, DEPTH)
    if kind == "diff":
        ref = jax.jit(lambda sm, *a: (jint.path_tracing_det_diff(
            jax.random.PRNGKey(0), jt, je, jm, *a, SPP, DEPTH,
            samples=sm),))(_map(jnp.asarray, s),
                           *map(jnp.asarray, scene["hits"]))
        out = (tint.path_tracing_det_diff(
            None, pt, pe, pm, *map(tt, (pos, wis, nrm, uv)),
            tt(tri, torch.int64), SPP, DEPTH, samples=_map(tt, s)),)
    else:
        ref = jax.jit(lambda sm, *a: jint.path_tracing_det_spec(
            jax.random.PRNGKey(0), jt, je, jm, jnp.float32(0.412), *a, SPP,
            DEPTH, samples=sm))(_map(jnp.asarray, s),
                                *map(jnp.asarray, scene["hits"]))
        out = tint.path_tracing_det_spec(
            None, pt, pe, pm, 0.412, *map(tt, (pos, wis, nrm, uv)),
            tt(tri, torch.int64), SPP, DEPTH, samples=_map(tt, s))
    return [o.detach().numpy() for o in out], [np.asarray(r) for r in ref]


@pytest.mark.parametrize("kind", ["diff", "spec"])
def test_det_constant_brdf(scene, kind):
    got, want = _run_det(scene, kind, "const", seed=3)
    for g, w in zip(got, want):
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["diff", "spec"])
def test_det_ngp_exact_encode(scene, kind):
    got, want = _run_det(scene, kind, "ngp", seed=4)
    for g, w in zip(got, want):
        assert np.abs(w).max() > 0
        close = np.abs(g - w) <= NGP_ATOL + NGP_RTOL * np.abs(w)
        assert close.mean() >= NGP_SHARE, (close.mean(),
                                           np.abs(g - w).max())


def test_det_material_evaluations(scene):
    """One material evaluation at the bounce vertices, then one per depth:
    the bounce vertices' material is handed to trace_indirect, where the
    JAX package evaluates it again (integrator.py:227)."""
    pt, pe, pm, _ = scene["port"]
    pos, wis, nrm, uv, tri = scene["hits"]
    calls = []

    def counted(x):
        calls.append(x.shape[0])
        return pm(x)

    s = _det_samples(5, pos.shape[0] * SPP, DEPTH)
    tint.path_tracing_det_diff(None, pt, pe, counted,
                               *map(tt, (pos, wis, nrm, uv)),
                               tt(tri, torch.int64), SPP, DEPTH,
                               samples=_map(tt, s))
    assert calls == [pos.shape[0] * SPP] * (1 + DEPTH)


# ------------------------------------------- analytic oracles, on the port

def _quad_scene(h, z, le):
    verts = np.asarray([[-h, -h, z], [-h, h, z], [h, h, z], [h, -h, z]],
                       np.float32)
    mesh = Mesh(verts, np.asarray([[0, 1, 2], [0, 2, 3]], np.int32))
    tracer = build_bvh(mesh.triangles(), device="cpu")
    em = TE.make_emitter(np.asarray([True, True]), mesh.triangles(),
                         radiance=np.full((2, 3), le, np.float32),
                         device="cpu")
    return verts.tolist(), tracer, em


def test_det_diff_matches_analytic_form_factor():
    """Diffuse bake under one emissive quad == Le * the analytic
    point-to-polygon form factor (tests/test_oracles.py:106), within 5%."""
    poly, tracer, em = _quad_scene(0.35, 1.0, 6.0)
    mat_fn = functools.partial(TB.constant_brdf_apply, TB.ConstantBRDF(
        tt([0.5, 0.5, 0.5]), tt([0.9]), tt([0.0])))
    p0 = np.asarray([0.12, -0.2, 0.0], np.float32)
    n0 = np.asarray([0.0, 0.0, 1.0], np.float32)
    out = tint.path_tracing_det_diff(
        torch.Generator().manual_seed(0), tracer, em, mat_fn, tt(p0[None]),
        tt(-n0[None]), tt(n0[None]), torch.zeros((1, 2)),
        torch.tensor([0]), spp=32768, indir_depth=1)
    expected = 6.0 * _form_factor_polygon(p0, n0, poly)
    got = float(out[0].mean())
    assert abs(got - expected) / expected < 0.05, (got, expected)


def test_det_spec_matches_uniform_hemisphere_mc():
    """Specular bake at a fixed roughness level under one emissive quad ==
    the uniform-hemisphere numpy MC of the Fresnel-split integral
    (tests/test_oracles.py:318), within 5%."""
    h, z, le, rough = 0.8, 1.0, 5.0, 0.5
    _, tracer, em = _quad_scene(h, z, le)
    mat_fn = functools.partial(TB.constant_brdf_apply, TB.ConstantBRDF(
        tt([0.5, 0.5, 0.5]), tt([0.7]), tt([0.0])))
    n0 = torch.tensor([[0.0, 0.0, 1.0]])
    l0, l1 = tint.path_tracing_det_spec(
        torch.Generator().manual_seed(0), tracer, em, mat_fn, rough,
        torch.zeros((1, 3)), -n0, n0, torch.zeros((1, 2)),
        torch.tensor([0]), spp=65536, indir_depth=0)

    rng = np.random.default_rng(42)
    n = 2_000_000
    zc = rng.uniform(0, 1, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    s = np.sqrt(np.maximum(1 - zc * zc, 0))
    wi = np.stack([s * np.cos(phi), s * np.sin(phi), zc], -1)
    t = z / np.maximum(zc, 1e-9)
    hit = (np.abs(wi[:, 0] * t) <= h) & (np.abs(wi[:, 1] * t) <= h)
    nrm = np.asarray([0.0, 0.0, 1.0])[None]
    d, g, fc, _, nov, _, _ = _ggx_terms_np(wi, nrm, nrm, rough)
    base = d * g / (4.0 * nov) * le * hit
    exp0 = 2 * np.pi * np.mean(base * (1 - fc))
    exp1 = 2 * np.pi * np.mean(base * fc)
    got0, got1 = float(l0[0].mean()), float(l1[0].mean())
    assert abs(got0 - exp0) / exp0 < 0.05, (got0, exp0)
    assert abs(got1 - exp1) / exp1 < 0.05, (got1, exp1)
