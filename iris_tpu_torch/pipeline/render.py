"""Render stills + intrinsic AOVs (counterpart of the render functions of
iris_tpu/pipeline/render.py; reference render.py): per frame, SPP-chunked
path_tracing and an AOV pass (kd, a' = g0*ks + g1 + kd reflectance,
roughness, metallic, emission, slf). The CLI (main), which needs the
dataset loaders, checkpoints, EXR output and the denoiser, waits for a
later slice."""

from __future__ import annotations

import torch

from iris_tpu_torch.core.vecmath import normalize
from iris_tpu_torch.geometry.intersect import ray_intersect
from iris_tpu_torch.models import brdf as B
from iris_tpu_torch.models.emitter import eval_emitter, slf_forward
from iris_tpu_torch.render.integrator import draw_uniform, path_tracing


def make_render_fns(tracer, em, mat_fn, spp, indir_depth):
    """(render_chunk, aov_chunk) over rays (B, 12) = [o, d, dxdu, dydv].

    Both take a torch.Generator for their draws, or `samples` in its
    place: render_chunk's are path_tracing's; aov_chunk's are 'dudv'
    (2, B, spp, 1) in [0, 1) — the AOV jitter is not centred, as in the
    JAX package (render.py:49) — and 's2' (B*spp, 2)."""

    @torch.no_grad()
    def render_chunk(rays, gen=None, samples=None):
        o, d = rays[..., :3], normalize(rays[..., 3:6])
        dxdu, dydv = rays[..., 6:9], rays[..., 9:12]
        return path_tracing(gen, tracer, em, mat_fn, o, d, dxdu, dydv, spp,
                            indir_depth, samples=samples)

    @torch.no_grad()
    def aov_chunk(rays, gen=None, samples=None):
        o, d = rays[..., :3], normalize(rays[..., 3:6])
        dxdu, dydv = rays[..., 6:9], rays[..., 9:12]
        b = o.shape[0]
        if samples is None:
            dudv = draw_uniform(gen, (2, b, spp, 1), o.device)
        else:
            dudv = samples["dudv"]
        du, dv = dudv[0], dudv[1]
        ds = normalize(d[:, None] + dxdu[:, None] * du
                       + dydv[:, None] * dv).reshape(-1, 3)
        xs = torch.repeat_interleave(o, spp, dim=0)
        pos, nrm, _, tri, valid = ray_intersect(tracer, xs, ds)
        mat = mat_fn(pos)
        kd = mat["albedo"] * (1 - mat["metallic"])
        ks = 0.04 * (1 - mat["metallic"]) + mat["albedo"] * mat["metallic"]
        if samples is None:
            s2 = draw_uniform(gen, (pos.shape[0], 2), o.device)
        else:
            s2 = samples["s2"]
        _, _, g0, g1 = B.sample_specular(s2, -ds, nrm, mat["roughness"])
        a_prime = g0 * ks + g1 + kd
        emission = eval_emitter(em, pos, ds, tri)[0]
        slf_v = slf_forward(em, pos)
        non_emit = torch.sum(emission, -1) == 0
        ok = (valid & non_emit)[:, None]
        kd = torch.where(ok, kd, 1.0)
        a_prime = torch.where(ok, a_prime, 1.0)
        rough = torch.where(ok, mat["roughness"], 1.0)
        metal = torch.where(ok, mat["metallic"], 0.0)

        def avg(x):
            return x.reshape(b, spp, -1).mean(1)

        return (avg(kd), avg(a_prime), avg(rough), avg(metal),
                avg(emission), avg(slf_v))

    return render_chunk, aov_chunk


def render_frame(render_chunk, aov_chunk, rays, n_rounds, gen):
    """Average n_rounds of render_chunk + aov_chunk over the frame's rays
    (a (B, 12) tensor on the render device). Returns numpy (l (B, 3),
    [kd, a_prime, roughness, metallic, emission, slf])."""
    l_full = None
    aovs = None
    for _ in range(n_rounds):
        l = render_chunk(rays, gen)
        a = aov_chunk(rays, gen)
        l_full = l if l_full is None else l_full + l
        aovs = list(a) if aovs is None else [p + q for p, q in zip(aovs, a)]
    l_full = (l_full / n_rounds).cpu().numpy()
    aovs = [(x / n_rounds).cpu().numpy() for x in aovs]
    return l_full, aovs
