"""The training slice, PyTorch port vs the JAX package: the pieces with a
gradient of their own, the three stage losses, the bench step (fwd+bwd of
path_tracing_single through the CRF) and five optimizer steps, under
replayed draws (tests/torch_parity.py replays the JAX key streams).

Sizes: a 4-clutter-box scene (62 faces), 4 hash levels x 16 features x
2^10 entries with only the coarse level spread over (-1, 1) (finer levels
at init scale: a fine level turns 1e-7 of position noise into 1e-2 of
feature), 64 pixels. Tolerances are stated at each test; the common
reasons are the bf16 MLP (products summed in another order round to the
other bf16 neighbour now and then) and float32 sums taken in another
order."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iris_tpu.core.ggx import lerp_specular as jax_lerp_specular
from iris_tpu.demo import make_demo_batch as jax_demo_batch
from iris_tpu.demo import make_demo_scene as jax_demo_scene
from iris_tpu.models import crf as jcrf
from iris_tpu.models.brdf import ngp_brdf_apply as jax_ngp_apply
from iris_tpu.models.emitter import _radiance_rows
from iris_tpu.render.integrator import path_tracing_single as jax_single
from iris_tpu.train import steps as jsteps
from iris_tpu.train.loop import make_train_step as jax_train_step
from iris_tpu.train.optim import make_optimizer as jax_make_optimizer
from iris_tpu.train.optim import scale_updates_for_key as jax_scale_updates
from iris_tpu.utils import losses as jlosses
from iris_tpu_torch import convert
from iris_tpu_torch.bench import make_bench_loss
from iris_tpu_torch.core.ggx import lerp_specular
from iris_tpu_torch.models import crf as tcrf
from iris_tpu_torch.models.emitter import radiance_rows
from iris_tpu_torch.train import steps as tsteps
from iris_tpu_torch.train.loop import make_train_step, value_and_grad
from iris_tpu_torch.train.optim import (
    make_optimizer, named_leaves, scale_updates_for_key)
from iris_tpu_torch.utils import losses as tlosses
from torch_parity import (
    cosine, jax_brdf_crf_draws, jax_emitter_draws, jax_hashgrid_draws,
    jax_initialize_draws, jax_leaves_by_name, jax_single_draws, port_crf,
    port_emitter, port_ngp, port_tracer, tt)

SPP = 2
LOSS_RTOL = 2e-3


# ------------------------------------------------------------ small pieces

@pytest.mark.parametrize("k", [8, 300])
def test_radiance_rows_backward(k):
    """One-hot product (K <= 256) and scatter-add (above): 1e-5, sums of
    ~B/K float32 terms in another order."""
    rng = np.random.default_rng(k)
    rad = rng.uniform(0, 5, (k, 3)).astype(np.float32)
    idx = rng.integers(0, k, 500).astype(np.int32)
    g = rng.normal(size=(500, 3)).astype(np.float32)
    ref, vjp = jax.vjp(lambda r: _radiance_rows(r, jnp.asarray(idx)),
                       jnp.asarray(rad))
    r = tt(rad).requires_grad_(True)
    out = radiance_rows(r, tt(idx, torch.int64))
    (d,) = torch.autograd.grad(out, r, tt(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=1e-5)


@pytest.fixture(scope="module")
def crf_pair():
    jc = jcrf.init_emor_crf(3)
    w = np.random.default_rng(0).normal(0, 0.3, (3, 3)).astype(np.float32)
    jc = dataclasses.replace(jc, weight=jnp.asarray(w))
    return jc, port_crf(jc)


def test_crf_inverse(crf_pair):
    """Monotone projection + numeric inversion: 2e-5 (a cumulative sum of
    1023 float32 terms and two interpolations)."""
    jc, pc = crf_pair
    ldr = np.random.default_rng(1).uniform(-0.1, 1.1, (200, 3)
                                           ).astype(np.float32)
    np.testing.assert_allclose(tcrf.get_inv_crf(pc).numpy(),
                               np.asarray(jcrf.get_inv_crf(jc)), atol=2e-5)
    for exposure in (None, 0.7):
        np.testing.assert_allclose(
            tcrf.crf_inverse(pc, tt(ldr), exposure).numpy(),
            np.asarray(jcrf.crf_inverse(jc, jnp.asarray(ldr), exposure)),
            atol=5e-5)
    # forward then inverse gives the input back where the curve is
    # monotone (weights zero)
    zero = port_crf(jcrf.init_emor_crf(3))
    hdr = tt(np.linspace(0.05, 0.95, 50, dtype=np.float32)[:, None]
             .repeat(3, 1))
    back = tcrf.crf_inverse(zero, tcrf.crf_forward(zero, hdr))
    np.testing.assert_allclose(back.numpy(), hdr.numpy(), atol=2e-3)


@pytest.mark.parametrize("name", ["reg_weight",
                                  "reg_monotonically_increasing",
                                  "reg_smoothness"])
def test_crf_regularizers(crf_pair, name):
    """Value and gradient in the CRF weights: rtol 1e-4 (float32 sums over
    3 x 1024 curve samples)."""
    jc, pc = crf_pair
    val, grad = jax.value_and_grad(lambda w: getattr(jcrf, name)(
        dataclasses.replace(jc, weight=w)))(jc.weight)
    w = pc.weight.clone().requires_grad_(True)
    out = getattr(tcrf, name)(dataclasses.replace(pc, weight=w))
    (g,) = torch.autograd.grad(out, w)
    np.testing.assert_allclose(float(out.detach()), float(val), rtol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(grad), rtol=1e-4,
                               atol=1e-7)


def test_fit_weight_to_crf(crf_pair):
    jc, pc = crf_pair
    target = np.asarray(jcrf.get_crf(jc))
    np.testing.assert_allclose(tcrf.fit_weight_to_crf(pc, target),
                               jcrf.fit_weight_to_crf(jc, target), atol=1e-5)
    np.testing.assert_allclose(tcrf.fit_weight_to_crf(pc, target),
                               np.asarray(jc.weight), atol=1e-4)


def test_lerp_specular():
    rng = np.random.default_rng(2)
    spec = rng.uniform(0, 1, (64, 6, 3)).astype(np.float32)
    rough = rng.uniform(0.0, 1.1, (64, 1)).astype(np.float32)
    rough[:4, 0] = [0.02, 1.0, 0.216, 0.5]
    ref, vjp = jax.vjp(lambda r: jax_lerp_specular(jnp.asarray(spec), r),
                       jnp.asarray(rough))
    r = tt(rough).requires_grad_(True)
    out = lerp_specular(tt(spec), r)
    (g,) = torch.autograd.grad(out.sum(), r)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-6)
    np.testing.assert_allclose(
        g.numpy(), np.asarray(vjp(jnp.ones_like(ref))[0]), atol=1e-5)


LOSS_FNS = ["compute_scale", "compute_scale_shift", "scale_invariant_mse",
            "scale_shift_invariant_mse", "mse", "segment_mean"]


@pytest.mark.parametrize("name", LOSS_FNS)
def test_utils_losses(name):
    """Each function of utils/losses.py, value and (where it has one)
    gradient in its first argument: rtol 1e-5 / atol 1e-6."""
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    if name == "segment_mean":
        seg = rng.integers(0, 5, 40)
        w = rng.uniform(0, 1, 40).astype(np.float32)
        for vals, weights in ((a, w), (a[:, 0], None)):
            jm, je = jlosses.segment_mean(
                jnp.asarray(vals), jnp.asarray(seg), 6,
                None if weights is None else jnp.asarray(weights))
            tm, te = tlosses.segment_mean(
                tt(vals), tt(seg, torch.int64), 6,
                None if weights is None else tt(weights))
            np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6)
            np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-6)
        return

    def scalar(fn, x, y):
        out = fn(x, y)
        return out[0] + 2.0 * out[1] if isinstance(out, tuple) else out

    val, grad = jax.value_and_grad(
        lambda x: scalar(getattr(jlosses, name), x, jnp.asarray(b)))(
        jnp.asarray(a))
    x = tt(a).requires_grad_(True)
    out = scalar(getattr(tlosses, name), x, tt(b))
    (g,) = torch.autograd.grad(out, x)
    np.testing.assert_allclose(float(out.detach()), float(val), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(grad), rtol=1e-4,
                               atol=1e-6)


def test_radiance_param_and_segment_guard():
    r = np.asarray([0.0, 1e-4, 1e-2, 0.5, 10.0, 1000.0], np.float32)
    np.testing.assert_allclose(
        tsteps.radiance_to_param(tt(r)).numpy(),
        np.asarray(jsteps.radiance_to_param(jnp.asarray(r))), rtol=1e-6)
    np.testing.assert_allclose(
        tsteps.param_to_radiance(tsteps.radiance_to_param(tt(r[1:]))
                                 ).numpy(), r[1:], rtol=1e-5)
    x = tt(r)
    assert tsteps.radiance_to_param(x, False) is x
    assert tsteps.param_to_radiance(x, False) is x
    tsteps.check_max_segments(tt([0, 3, 7]), 8)
    with pytest.raises(ValueError, match="max_segments"):
        tsteps.check_max_segments(np.asarray([0, 3, 8]), 8)


def test_propagation_loss():
    """Value rtol 1e-4; gradients in roughness and metallic rtol 1e-3 /
    atol 1e-6 (sums over 256 partners in another order). The partner
    draws are the JAX key's."""
    rng = np.random.default_rng(4)
    b = 256
    seg = rng.integers(0, 6, b)
    valid = rng.uniform(size=b) > 0.15
    pos = rng.uniform(-1, 1, (b, 3)).astype(np.float32)
    alb = rng.uniform(0, 1, (b, 3)).astype(np.float32)
    rough = rng.uniform(0, 1, b).astype(np.float32)
    metal = rng.uniform(0, 1, b).astype(np.float32)
    kw = dict(max_segments=8, n_pairs=256, sigma_albedo=0.3, sigma_pos=0.5)
    key = jax.random.PRNGKey(3)
    val, (gr, gm) = jax.value_and_grad(
        lambda r, m: jsteps.propagation_loss(
            key, jnp.asarray(seg, jnp.int32), jnp.asarray(valid),
            jnp.asarray(pos), jnp.asarray(alb), r, m,
            jsteps.LossConfig(**kw)), argnums=(0, 1))(
        jnp.asarray(rough), jnp.asarray(metal))
    u = tt(np.asarray(jax.random.uniform(key, (b, 256))))
    r = tt(rough).requires_grad_(True)
    m = tt(metal).requires_grad_(True)
    out = tsteps.propagation_loss(
        None, tt(seg, torch.int64), tt(valid, torch.bool), tt(pos), tt(alb),
        r, m, tsteps.LossConfig(**kw), u=u)
    g_r, g_m = torch.autograd.grad(out, (r, m))
    np.testing.assert_allclose(float(out.detach()), float(val), rtol=1e-4)
    np.testing.assert_allclose(g_r.numpy(), np.asarray(gr), rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_allclose(g_m.numpy(), np.asarray(gm), rtol=1e-3,
                               atol=1e-6)


# ------------------------------------------------------- the stage losses

@pytest.fixture(scope="module")
def scene():
    return _make_scene()


def _make_scene():
    """JAX and port objects of one small scene with the trainers'
    estimator settings: stochastic forward and backward, one level block
    per step, float32 compact scatter (the bf16 one is held by cosine in
    test_bench_step)."""
    tracer, em, ngp, crf, _ = jax_demo_scene(
        n_clutter=4, slf_res=16, hash_levels=4, log2_table=10,
        hash_features=16, per_level_scale=-1.0)
    rng = np.random.default_rng(0)
    rad = rng.uniform(0.05, 0.5, em.slf.radiance.shape).astype(np.float32)
    em = dataclasses.replace(em, slf=dataclasses.replace(
        em.slf, radiance=jnp.asarray(rad)))
    table = np.asarray(ngp.table).reshape(4, -1, 16).copy()
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
    return (tracer, em, ngp, crf), batch


def _port(scene):
    (tracer, em, ngp, crf), batch = scene
    return (port_tracer(tracer), port_emitter(em), port_ngp(ngp),
            port_crf(crf)), {k: tt(v) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _check_grads(port_grads: dict, jax_grads, min_cos=0.9999, rel=0.01,
                 zero=()):
    """Every JAX gradient leaf against the port's leaf of the same name:
    cosine >= min_cos and |difference| <= rel * |reference| (norms). The
    bf16 MLP rounds activations to 8 bits in both packages, at slightly
    different places, so single entries differ by ~1e-3 relative and a few
    by more; directions and norms agree (measured: cosine >= 0.999998,
    relative difference <= 0.0021). Leaves in `zero` must be zero (or
    absent) on both sides."""
    ref = jax_leaves_by_name(jax_grads)
    got = convert.leaves_to_numpy(port_grads)
    checked = 0
    for name, r in ref.items():
        if name.endswith(("voxel_min", "voxel_max")):
            assert not np.any(r)           # no gradient path in either
            continue
        if name in zero or name.split(".")[0] in zero:
            assert not np.any(r), name
            assert name not in got or not np.any(got[name]), name
            continue
        g = got[name]
        assert g.shape == r.shape, name
        assert np.all(np.isfinite(g)), name
        assert np.linalg.norm(r) > 0, name
        assert cosine(g, r) >= min_cos, (name, cosine(g, r))
        assert np.linalg.norm(g - r) <= rel * np.linalg.norm(r), (
            name, np.linalg.norm(g - r) / np.linalg.norm(r))
        checked += 1
    return checked


def test_initialize_loss(scene):
    """Loss rtol 2e-3; material gradient is the albedo anchor's alone,
    radiance gradient the render's."""
    (jt, je, jn, jc), batch = scene
    (pt, pe, pn, pc), pbatch = _port(scene)
    cfg = dict(spp=SPP, n_spp_rounds=2, max_segments=8)
    key = jax.random.PRNGKey(5)
    jparams = {"material": jn, "radiance": je.radiance}
    (val, aux), grads = jax.jit(jax.value_and_grad(
        jsteps.make_initialize_loss(jt, je, jc, jsteps.LossConfig(**cfg)),
        has_aux=True))(jparams, _jbatch(batch), key)
    b = batch["rays"].shape[0]
    loss, paux, pgrads = value_and_grad(
        tsteps.make_initialize_loss(pt, pe, pc, tsteps.LossConfig(**cfg)),
        {"material": pn, "radiance": pe.radiance}, pbatch, None,
        jax_initialize_draws(key, jn.cfg, b, SPP, 2))
    np.testing.assert_allclose(float(loss), float(val), rtol=LOSS_RTOL)
    for k in ("loss_c", "loss_a"):
        np.testing.assert_allclose(float(paux[k]), float(aux[k]),
                                   rtol=LOSS_RTOL)
    assert _check_grads(pgrads, grads) == 8


def test_train_emitter_loss(scene):
    """Loss rtol 2e-3; the only leaf is the radiance (log space here)."""
    (jt, je, jn, jc), batch = scene
    (pt, pe, pn, pc), pbatch = _port(scene)
    cfg = dict(spp=SPP, radiance_log_space=True)
    key = jax.random.PRNGKey(6)
    jparams = {"radiance": jsteps.radiance_to_param(je.radiance)}
    (val, _), grads = jax.jit(jax.value_and_grad(
        jsteps.make_train_emitter_loss(jt, je, jn, jc,
                                       jsteps.LossConfig(**cfg)),
        has_aux=True))(jparams, _jbatch(batch), key)
    pparams = {"radiance": tsteps.radiance_to_param(pe.radiance)}
    loss, _, pgrads = value_and_grad(
        tsteps.make_train_emitter_loss(pt, pe, pn, pc,
                                       tsteps.LossConfig(**cfg)),
        pparams, pbatch, None,
        jax_emitter_draws(key, batch["rays"].shape[0], SPP, 1))
    np.testing.assert_allclose(float(loss), float(val), rtol=LOSS_RTOL)
    assert set(pgrads) == {"radiance"}
    assert _check_grads(pgrads, grads) == 1
    # the frozen material takes no gradient: its leaves are not even asked
    assert not pn.table.requires_grad


@pytest.mark.parametrize("has_part", [True, False])
def test_brdf_crf_loss(scene, has_part):
    """Loss and each aux term rtol 2e-3; gradients into the table, the MLP
    and the CRF weights."""
    (jt, je, jn, jc), batch = scene
    (pt, pe, pn, pc), pbatch = _port(scene)
    cfg = dict(max_segments=8, has_part=has_part, la=0.1, n_pairs=64)
    key = jax.random.PRNGKey(7)
    jparams = {"material": jn, "crf_weight": jc.weight}
    (val, aux), grads = jax.jit(jax.value_and_grad(
        jsteps.make_brdf_crf_loss(jt, jc, jsteps.LossConfig(**cfg), -0.1,
                                  2.1), has_aux=True))(
        jparams, _jbatch(batch), key)
    loss, paux, pgrads = value_and_grad(
        tsteps.make_brdf_crf_loss(pt, pc, tsteps.LossConfig(**cfg), -0.1,
                                  2.1),
        {"material": pn, "crf_weight": pc.weight}, pbatch, None,
        jax_brdf_crf_draws(key, jn.cfg, batch["rays"].shape[0], 64))
    np.testing.assert_allclose(float(loss), float(val), rtol=LOSS_RTOL)
    for k in ("loss_c", "loss_d", "loss_seg", "reg_crf"):
        np.testing.assert_allclose(float(paux[k]), float(aux[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    assert _check_grads(pgrads, grads) == 8


# ------------------------------------- the bench step and the train steps

def _bench_loss_jax(jt, je, jn_cfg, jc, rays, target):
    o, d, dxdu, dydv = (jnp.asarray(rays[:, i:i + 3]) for i in (0, 3, 6, 9))

    def loss_fn(p, batch, key):
        em2 = dataclasses.replace(je, radiance=p["radiance"])
        crf2 = dataclasses.replace(jc, weight=p["crf_w"])
        key, k_mat = jax.random.split(key)
        mat_fn = functools.partial(jax_ngp_apply, p["material"], key=k_mat)
        l = jax_single(key, jt, em2, mat_fn, o, d, dxdu, dydv, SPP)
        ldr = jcrf.crf_forward(crf2, l, 1.0)
        loss = jnp.mean((ldr - target) ** 2)
        return loss, {"loss": loss}

    return loss_fn


def _bench_draws(key, hcfg, b):
    key, k_mat = jax.random.split(key)
    return {"render": jax_single_draws(key, b, SPP),
            "mat": jax_hashgrid_draws(k_mat, hcfg, b * SPP)}


@pytest.mark.parametrize("scatter", ["float32", "bfloat16"])
def test_bench_step_forward_backward(scene, scatter):
    """The benchmark's step: MSE of crf_forward(path_tracing_single) to
    0.5, gradients into material (table + MLP), radiance and CRF weights.
    Loss rtol 2e-3; gradient leaves by _check_grads (float32 scatter), the
    bf16 compact scatter's leaves by cosine > 0.9999 and twice the
    relative bound; only one level block
    of the table gradient is nonzero."""
    (jt, je, jn, jc), batch = scene
    jn = dataclasses.replace(jn, cfg=dataclasses.replace(
        jn.cfg, bwd_scatter_dtype=scatter))
    pt, pe, pn, pc = _port(((jt, je, jn, jc), batch))[0]
    rays = batch["rays"]
    key = jax.random.PRNGKey(8)
    jparams = {"material": jn, "radiance": je.radiance, "crf_w": jc.weight}
    (val, _), grads = jax.jit(jax.value_and_grad(
        _bench_loss_jax(jt, je, jn.cfg, jc, rays, 0.5), has_aux=True))(
        jparams, {}, key)
    loss, _, pgrads = value_and_grad(
        make_bench_loss(pt, pe, pc, tt(rays), SPP),
        {"material": pn, "radiance": pe.radiance, "crf_w": pc.weight}, {},
        None, _bench_draws(key, jn.cfg, rays.shape[0]))
    np.testing.assert_allclose(float(loss), float(val), rtol=LOSS_RTOL)
    assert _check_grads(pgrads, grads,
                        rel=0.01 if scatter == "float32" else 0.02) == 9
    blocks = pgrads["material.table"].abs().reshape(4, -1).sum(1) > 0
    assert int(blocks.sum()) == 1


@pytest.mark.parametrize("kind", ["SGD", "Adam"])
def test_five_train_steps_match_optax(scene, kind):
    """Five optimizer steps (lr 1e-2, halved from step 2) of the bench step
    through make_train_step on both sides, fresh replayed draws each step.
    Losses rtol 2e-3 at every step. Parameters against optax's:

    - SGD: every leaf within rtol 1e-4 / atol 1e-6;
    - Adam: every entry within rtol 1e-4 / atol 2e-4, apart from those
      picked by a rule on the reference gradient alone: an entry is
      noise-bound if at any of the five steps its JAX gradient is nonzero
      and below 0.15 of the largest in its leaf at that step. Adam's
      normalized update turns any gradient into a step of about +-lr
      whatever its size, so where the bf16 MLP's rounding noise (a few
      1e-3 of the leaf's large entries, see _check_grads) is a good part of
      an entry, or decides its sign, the entry lands up to 2*lr per step
      away. The rule is applied to all nine leaves, none is named: entries
      never touched (most of the table) and entries with a strong gradient
      at every step are held tightly. The noise-bound entries of each leaf
      are held loosely: >= 80% of them within the same tolerance
      (measured: 85% in the MLP's first layer, >= 98% elsewhere), none
      further than the 2 * sum(lr) that five sign flips can give, and the
      leaf's five-step movement at cosine >= 0.99."""
    (jt, je, jn, jc), batch = scene
    (pt, pe, pn, pc), _ = _port(scene)
    rays = batch["rays"]
    kw = dict(learning_rate=1e-2, milestones=(2,), optimizer=kind)
    jopt = jax_make_optimizer(**kw)
    jparams = {"material": jn, "radiance": je.radiance, "crf_w": jc.weight}
    jstate = jopt.init(jparams)
    jstep = jax_train_step(_bench_loss_jax(jt, je, jn.cfg, jc, rays, 0.5),
                           jopt, donate=False)
    popt = make_optimizer(**kw)
    pparams = {"material": pn, "radiance": pe.radiance.clone(),
               "crf_w": pc.weight.clone()}
    start = convert.leaves_to_numpy(pparams)
    pstate = popt.init(pparams)
    pstep = make_train_step(make_bench_loss(pt, pe, pc, tt(rays), SPP), popt)
    jgrad = jax.jit(jax.grad(
        lambda p, b, k: _bench_loss_jax(jt, je, jn.cfg, jc, rays, 0.5)(
            p, b, k)[0]))
    noise_bound = {}
    lr_sum = 0.0
    for i in range(5):
        key = jax.random.PRNGKey(100 + i)
        if kind == "Adam":
            for name, g in jax_leaves_by_name(
                    jgrad(jparams, {}, key)).items():
                g = np.abs(g)
                weak = (g > 0) & (g < 0.15 * g.max())
                noise_bound[name] = noise_bound.get(name, False) | weak
        lr_sum += pstate["sched"].get_last_lr()[0]
        jparams, jstate, jloss, _ = jstep(jparams, jstate, {}, key)
        pparams, pstate, ploss, _ = pstep(
            pparams, pstate, {}, None,
            _bench_draws(key, jn.cfg, rays.shape[0]))
        np.testing.assert_allclose(float(ploss), float(jloss),
                                   rtol=LOSS_RTOL)
    assert pstate["sched"].get_last_lr()[0] == pytest.approx(5e-3)
    assert lr_sum == pytest.approx(2 * 1e-2 + 3 * 5e-3)
    ref = jax_leaves_by_name(jparams)
    got = convert.leaves_to_numpy(pparams)
    assert len(got) == 9
    for name, g in got.items():
        assert np.abs(g - start[name]).max() > 0, name      # it moved
        if kind == "SGD":
            np.testing.assert_allclose(g, ref[name], rtol=1e-4, atol=1e-6,
                                       err_msg=name)
            continue
        weak = noise_bound[name].reshape(g.shape)
        np.testing.assert_allclose(g[~weak], ref[name][~weak], rtol=1e-4,
                                   atol=2e-4, err_msg=name)
        close = np.isclose(g[weak], ref[name][weak], rtol=1e-4, atol=2e-4)
        assert not weak.any() or close.mean() >= 0.8, (name, close.mean())
        assert np.abs(g - ref[name]).max() <= 2 * lr_sum, name
        assert cosine(g - start[name], ref[name] - start[name]) >= 0.99


# ------------------------------------------------------------ the optimizer

@pytest.mark.parametrize("kind,wd", [("Adam", 0.0), ("Adam", 0.01),
                                     ("SGD", 0.0)])
def test_optimizer_matches_optax(kind, wd):
    """Adam, AdamW and SGD with milestones (2, 4) and a 10x update scale on
    one key, six steps on fixed gradients: rtol 1e-4 (float32 divisions and
    square roots round differently in the two libraries, and six steps
    compound it to ~1e-5)."""
    rng = np.random.default_rng(9)
    p0 = {"radiance": rng.normal(size=(4, 3)).astype(np.float32),
          "w": rng.normal(size=(5,)).astype(np.float32)}
    gs = [{k: rng.normal(size=v.shape).astype(np.float32)
           for k, v in p0.items()} for _ in range(6)]
    kw = dict(learning_rate=1e-2, weight_decay=wd, milestones=(2, 4),
              scheduler_rate=0.5, optimizer=kind)
    jopt = jax_scale_updates(jax_make_optimizer(**kw), "radiance", 10.0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jopt.init(jp)
    popt = scale_updates_for_key(make_optimizer(**kw), "radiance", 10.0)
    pp = {k: tt(v) for k, v in p0.items()}
    ps = popt.init(pp)
    for g in gs:
        up, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp)
        jp = optax.apply_updates(jp, up)
        popt.update(pp, {k: tt(v) for k, v in g.items()}, ps)
    for k in p0:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-4, atol=1e-6)
    base = make_optimizer(**kw)
    assert scale_updates_for_key(base, "radiance", 1.0) is base


def test_named_leaves_follow_the_jax_pytree(scene):
    (_, _, jn, _), _ = scene
    pn = _port(scene)[0][2]
    names = [n for n, _ in named_leaves({"material": pn})]
    ref = [n for n in jax_leaves_by_name({"material": jn})
           if not n.endswith(("voxel_min", "voxel_max"))]
    assert sorted(names) == sorted(ref)
    flat = convert.leaves_to_numpy({"material": pn})
    np.testing.assert_array_equal(flat["material.table"],
                                  np.asarray(jn.table))
