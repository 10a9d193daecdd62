"""Path-tracing integrators (counterpart of iris_tpu/render/integrator.py;
reference utils/path_tracing.py path_tracing_det_diff :50,
path_tracing_det_spec :127, path_tracing :214, path_tracing_single :320,
trace_indirect :409).

Like the JAX package, every lane of a fixed-size batch computes and a
boolean `active` mask gates contributions (the reference compacts the ray
set each bounce instead). MIS weights, pdf clamps, geometry terms and the
radiance-cache early termination follow the reference formulas.

Random draws come from a torch.Generator. Each function also takes a
`samples` dict that replaces every draw, with the JAX package's keys: the
common-random-number hook the parity tests feed from one numpy stream.
The per-ray draws name their ray axis, so that under a data-parallel
rank's generator they are made at the global batch's shape and sliced to
the rank's rows, replayed samples alike (parallel/sharding.py).
"""

from __future__ import annotations

from typing import Callable

import torch

from iris_tpu_torch.const import RAY_EPS
from iris_tpu_torch.core.vecmath import dot, normalize
from iris_tpu_torch.geometry.bvh import Tracer
from iris_tpu_torch.geometry.intersect import ray_intersect
from iris_tpu_torch.models import brdf as B
from iris_tpu_torch.models.emitter import (
    Emitter, eval_emitter, sample_emitter,
)
from iris_tpu_torch.parallel.sharding import draw_uniform, rank_rows
from iris_tpu_torch.utils.profiling import spanned

MatFn = Callable[[torch.Tensor], dict]


def _jitter_rays(gen, rays_o, rays_d, dx_du, dy_dv, spp, dudv=None):
    """Pixel-jittered camera rays replicated spp times (reference
    :232-234). dudv (2, B, spp, 1) overrides the uniform draws in
    [-0.5, 0.5)."""
    b = rays_o.shape[0]
    if dudv is None:
        dudv = draw_uniform(gen, (2, b, spp, 1), rays_o.device, -0.5, 0.5,
                            axis=1)
    else:
        dudv = rank_rows(dudv, gen, 1)
    du, dv = dudv[0], dudv[1]
    wi = normalize(rays_d[:, None] + dx_du[:, None] * du
                   + dy_dv[:, None] * dv)
    wi = wi.reshape(-1, 3)
    position = torch.repeat_interleave(rays_o, spp, dim=0)
    return position, wi


def _mis_power2(pdf_a: torch.Tensor, pdf_b: torch.Tensor,
                clamp_denom: float) -> torch.Tensor:
    """Power-2 MIS weight of strategy a against b with the reference's
    inf/0 guards (:274-275): 0 unless pdf_a > 0 and pdf_b finite; 1 when
    pdf_a is inf or pdf_b == 0."""
    denom = pdf_a * pdf_a + pdf_b * pdf_b
    if clamp_denom > 0:
        denom = torch.clamp(denom, min=clamp_denom)
    w = torch.where((pdf_a > 0) & (~torch.isinf(pdf_b)),
                    pdf_a * pdf_a / denom, 0.0)
    return torch.where(torch.isinf(pdf_a) | (pdf_b == 0), 1.0, w)


@spanned("integrator.bounce")
def _nee_and_bounce(gen, tracer: Tracer, em: Emitter, mat_fn: MatFn,
                    position, wo, normal, mat, active, g_clamp: float,
                    mis_clamp: float, trace_roughness: float | None,
                    samples: dict | None = None):
    """One bounce of light transport: the NEE direct term (reference
    :253-276) and the BRDF-sampled term (:279-299), with the shadow and
    bounce rays traced as ONE 2N-ray batch.

    `samples` overrides the draws: 's1' (n,), 's2' (n, 2) for the emitter
    sample, 's1b'/'s2b' for the BRDF sample.

    Returns (nee_contrib, bounce_contrib, next_position, next_normal,
    next_wo, next_mat, next_active, brdf_weight)."""
    n = position.shape[0]
    dev = position.device
    if samples is None:
        s1, s2, s1b, s2b = (draw_uniform(gen, shape, dev, axis=0) for shape
                            in ((n,), (n, 2), (n,), (n, 2)))
    else:
        s1, s2, s1b, s2b = (rank_rows(samples[k], gen) for k in
                            ("s1", "s2", "s1b", "s2b"))
    wi_e, emit_pdf, emit_tri = sample_emitter(em, s1, s2, position)
    wi_b, brdf_pdf_b, brdf_weight = B.sample_brdf(s1b, s2b, wo, normal, mat)

    o2 = torch.cat([position + RAY_EPS * wi_e, position + RAY_EPS * wi_b], 0)
    d2 = torch.cat([wi_e, wi_b], 0)
    # dead lanes are parked far above the scene pointing +z: they miss the
    # root box in one step instead of re-tracing stale rays. The batch is
    # spatially incoherent, so ray_intersect may sort it (big trees).
    act2 = torch.cat([active, active], 0)[:, None]
    o2 = torch.where(act2, o2, 1e7)
    park = torch.zeros(3, device=dev)     # +z, filled on the device
    park.narrow(0, 2, 1).fill_(1.0)
    d2 = torch.where(act2, d2, park)
    pos2, nrm2, _, tri2, valid2 = ray_intersect(tracer, o2, d2, sort=True)
    emit_pos, pos_next = pos2[:n], pos2[n:]
    emit_nrm, nrm_next = nrm2[:n], nrm2[n:]
    tri_e, tri_b = tri2[:n], tri2[n:]
    emit_valid = valid2[:n]

    # ---- NEE half
    emit_vis = (~emit_valid) | (emit_tri == tri_e)
    emit_weight, _, _ = eval_emitter(em, emit_pos, wi_e, tri_e)
    g = torch.abs(dot(-wi_e, emit_nrm, keepdims=False)) / torch.clamp(
        torch.sum((emit_pos - position) ** 2, -1), min=g_clamp)
    g = torch.where(emit_valid, g, 1.0)[:, None]
    emit_weight = emit_weight * emit_vis[:, None] * g / torch.clamp(
        emit_pdf, min=g_clamp)
    emit_brdf, nee_brdf_pdf = B.eval_brdf(wi_e, wo, normal, mat)
    nee_brdf_pdf = nee_brdf_pdf * g
    w_mis = _mis_power2(emit_pdf, nee_brdf_pdf, mis_clamp)
    nee_contrib = torch.where(active[:, None],
                              emit_brdf * emit_weight * w_mis, 0.0)

    # ---- BRDF-sampled half
    if trace_roughness == 0.0:
        # the bounce-hit material would only feed the (vacuous)
        # roughness > 0 cache gate: skip its encode, as the JAX package does
        mat_next = None
        le, emit_pdf2, valid_next = eval_emitter(
            em, pos_next, wi_b, tri_b,
            torch.ones((pos_next.shape[0], 1), device=dev), 0.0)
    elif trace_roughness is None:
        mat_next = mat_fn(pos_next)
        le, emit_pdf2, valid_next = eval_emitter(
            em, pos_next, wi_b, tri_b, mat_next["roughness"])
    else:
        mat_next = mat_fn(pos_next)
        le, emit_pdf2, valid_next = eval_emitter(
            em, pos_next, wi_b, tri_b, mat_next["roughness"],
            trace_roughness)
    g2 = torch.abs(dot(-nrm_next, wi_b, keepdims=False)) / torch.clamp(
        torch.sum((position - pos_next) ** 2, -1), min=g_clamp)
    g2 = torch.where(valid_next, g2, 1.0)
    brdf_pdf_b = brdf_pdf_b * g2[:, None]
    w_mis2 = _mis_power2(brdf_pdf_b, emit_pdf2, 0.0)
    bounce_contrib = torch.where(active[:, None],
                                 brdf_weight * le * w_mis2, 0.0)
    active_next = active & valid_next
    return (nee_contrib, bounce_contrib, pos_next, nrm_next, -wi_b,
            mat_next, active_next, brdf_weight)


@spanned("integrator.first_hit")
def _first_hit(gen, tracer, em, mat_fn, rays_o, rays_d, dx_du, dy_dv, spp,
               samples):
    position, wi = _jitter_rays(gen, rays_o, rays_d, dx_du, dy_dv, spp,
                                None if samples is None
                                else samples["dudv"])
    position, normal, _, tri, _ = ray_intersect(tracer, position, wi)
    l, _, active = eval_emitter(em, position, wi, tri)
    return position, normal, -wi, mat_fn(position), l, active


def path_tracing_single(gen, tracer: Tracer, em: Emitter, mat_fn: MatFn,
                        rays_o, rays_d, dx_du, dy_dv, spp: int,
                        samples: dict | None = None):
    """Differentiable single-bounce estimator, the training forward
    (reference :320-407 with trace_roughness=0.0): first-hit emission + MIS
    direct light, the bounce always ending in the SLF radiance cache.
    Gradients reach what mat_fn and the emitter's radiance carry; the
    traversal itself carries none. Returns (B, 3).

    `samples`: 'dudv' (2, B, spp, 1) jitter in [-0.5, 0.5), plus
    _nee_and_bounce's 's1'/'s2'/'s1b'/'s2b' per flat lane."""
    b = rays_o.shape[0]
    position, normal, wo, mat, l, active = _first_hit(
        gen, tracer, em, mat_fn, rays_o, rays_d, dx_du, dy_dv, spp, samples)
    nee, bounce, *_ = _nee_and_bounce(
        gen, tracer, em, mat_fn, position, wo, normal, mat, active,
        1e-6, 1e-6, trace_roughness=0.0, samples=samples)
    l = l + nee + bounce
    return l.reshape(b, spp, 3).mean(1)


@torch.no_grad()
def trace_indirect(gen, tracer: Tracer, em: Emitter, mat_fn: MatFn,
                   position, wo, normal, mat, active, indir_depth: int,
                   samples: dict | None = None):
    """No-grad multi-bounce indirect tail (reference :409-502), a Python
    loop over depth with masked fixed-size state; the radiance cache
    (trace_roughness 0.6) ends lanes as in the reference.

    `mat` is the material at the start vertices, mat_fn(position), which
    the caller has already evaluated. The JAX package evaluates it again
    here (iris_tpu/render/integrator.py:227); the two agree bit for bit
    where mat_fn makes no draws, which holds for every render (the exact
    encode). A stochastic mat_fn would have drawn afresh there.

    `samples`: per-depth stacked draws 's1' (D, n), 's2' (D, n, 2), 's1b',
    's2b'."""
    n = position.shape[0]
    throughput = torch.ones((n, 3), device=position.device)
    l = torch.zeros((n, 3), device=position.device)
    for depth in range(indir_depth):
        smp = (None if samples is None
               else {k: v[depth] for k, v in samples.items()})
        (nee, bounce, position, normal, wo, mat, active,
         brdf_w) = _nee_and_bounce(
            gen, tracer, em, mat_fn, position, wo, normal, mat, active,
            1e-12, 0.0, trace_roughness=None, samples=smp)
        dl = throughput * nee
        l = l + torch.where(torch.isnan(dl), 0.0, dl)
        dl = throughput * bounce
        l = l + torch.where(torch.isnan(dl), 0.0, dl)
        throughput = throughput * brdf_w
    return l


def path_tracing(gen, tracer: Tracer, em: Emitter, mat_fn: MatFn,
                 rays_o, rays_d, dx_du, dy_dv, spp: int, indir_depth: int,
                 samples: dict | None = None):
    """Full estimator: differentiable first bounce + no-grad indirect
    tail (reference :214-318). Returns (B, 3).

    `samples`: 'dudv' + first-bounce 's1'/'s2'/'s1b'/'s2b' as in
    path_tracing_single, plus 'indirect' = trace_indirect's draws."""
    b = rays_o.shape[0]
    position, normal, wo, mat, l, active = _first_hit(
        gen, tracer, em, mat_fn, rays_o, rays_d, dx_du, dy_dv, spp, samples)
    (nee, bounce, pos_n, nrm_n, wo_n, mat_n, active_n,
     brdf_w) = _nee_and_bounce(
        gen, tracer, em, mat_fn, position, wo, normal, mat, active,
        1e-6, 0.0, trace_roughness=None, samples=samples)
    l = l + nee + bounce
    # the first bounce's material, evaluated once: trace_indirect starts
    # from those vertices
    l_indir = trace_indirect(gen, tracer, em, mat_fn, pos_n.detach(),
                             wo_n.detach(), nrm_n.detach(),
                             {k: v.detach() for k, v in mat_n.items()},
                             active_n, indir_depth,
                             samples=None if samples is None
                             else samples["indirect"])
    l = l + torch.where(active_n[:, None], brdf_w * l_indir, 0.0)
    return l.reshape(b, spp, 3).mean(1)


def _det_common(gen, tracer, em, mat_fn, positions, wis, normals,
                triangle_idxs, spp, indir_depth, sample_fn,
                samples: dict | None = None):
    """The shading bakes' common path from deterministic first hits:
    sample_fn(gen, wo, normal, s2) -> (wi, [weights]) picks the lobe; one
    traced bounce, then trace_indirect. Returns one (B, 3) result per
    weight, zero where the first hit missed (triangle_idxs == -1).

    `samples`: 'det_s2' (B*spp, 2) lobe draws, rows i*spp + j, and
    'indirect', trace_indirect's stacked per-depth draws."""
    emit_mask = triangle_idxs != -1
    position = torch.repeat_interleave(positions, spp, dim=0)
    normal = torch.repeat_interleave(normals, spp, dim=0)
    wo = torch.repeat_interleave(-wis, spp, dim=0)
    active = torch.repeat_interleave(emit_mask, spp, dim=0)

    wi, weights = sample_fn(gen, wo, normal,
                            None if samples is None else samples["det_s2"])
    pos_next, nrm_next, _, tri, _ = ray_intersect(
        tracer, position + RAY_EPS * wi, wi)
    mat_next = mat_fn(pos_next)
    le, _, valid_next = eval_emitter(em, pos_next, wi, tri,
                                     mat_next["roughness"])
    results = [torch.where(active[:, None], w * le, 0.0) for w in weights]

    active_next = active & valid_next
    # the material at the bounce vertices, evaluated once: the JAX package
    # evaluates it again inside trace_indirect (integrator.py:227), which
    # gives the same bits under the exact encode
    l_indir = trace_indirect(gen, tracer, em, mat_fn, pos_next, -wi,
                             nrm_next, mat_next, active_next, indir_depth,
                             samples=None if samples is None
                             else samples["indirect"])
    b = positions.shape[0]
    out = []
    for r, w in zip(results, weights):
        r = r + torch.where(active_next[:, None], w * l_indir, 0.0)
        r = r.reshape(b, spp, 3).mean(1)
        out.append(torch.where(emit_mask[:, None], r, 0.0))
    return out


def path_tracing_det_diff(gen, tracer: Tracer, em: Emitter, mat_fn: MatFn,
                          positions, wis, normals, uvs, triangle_idxs,
                          spp: int, indir_depth: int,
                          samples: dict | None = None):
    """Diffuse shading bake from deterministic first hits (reference
    :50-124): (B, 3) cosine-importance-sampled incident diffuse shading."""

    def sample(g, wo, normal, s2):
        s2 = (draw_uniform(g, (normal.shape[0], 2), normal.device, axis=0)
              if s2 is None else rank_rows(s2, g))
        wi, _, w = B.sample_diffuse(s2, normal)
        return wi, [w]

    (out,) = _det_common(gen, tracer, em, mat_fn, positions, wis, normals,
                         triangle_idxs, spp, indir_depth, sample,
                         samples=samples)
    return out


def path_tracing_det_spec(gen, tracer: Tracer, em: Emitter, mat_fn: MatFn,
                          roughness_level, positions, wis, normals, uvs,
                          triangle_idxs, spp: int, indir_depth: int,
                          samples: dict | None = None):
    """Specular shading bake at a fixed roughness level (reference
    :127-212): (L0, L1), the two Fresnel-split components, each (B, 3)."""

    def sample(g, wo, normal, s2):
        s2 = (draw_uniform(g, (normal.shape[0], 2), normal.device, axis=0)
              if s2 is None else rank_rows(s2, g))
        wi, _, w0, w1 = B.sample_specular(s2, wo, normal, roughness_level)
        return wi, [w0, w1]

    l0, l1 = _det_common(gen, tracer, em, mat_fn, positions, wis, normals,
                         triangle_idxs, spp, indir_depth, sample,
                         samples=samples)
    return l0, l1
