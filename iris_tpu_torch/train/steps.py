"""Stage training-step loss builders (counterpart of
iris_tpu/train/steps.py).

The losses mirror the three reference trainers:
  make_initialize_loss     — initialize.py:150-225 (rendered MSE with the
      material frozen in the render + segment-mean albedo anchor on the
      live material)
  make_brdf_crf_loss       — train_brdf_crf.py:163-314 (cached-shading
      re-render + CRF + diffuse/propagation/albedo/CRF regularizers)
  make_train_emitter_loss  — train_emitter.py (rendered MSE only; material
      and CRF frozen)

Each loss_fn(params, batch, gen, samples=None) returns (loss, aux). `gen`
is the torch.Generator every draw comes from; `samples` replaces the draws
(the common-random-number hook of the parity tests):
  initialize:    {"render": [path_tracing_single samples per spp round],
                  "dudv": (2, B, 1) in [-0.5, 0.5), "mat": hash-grid samples}
  train_emitter: {"render": [...]}
  brdf_crf:      {"mat": hash-grid samples, "pairs_u": (B, n_pairs)}
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace as dc_replace

import numpy as np
import torch

from iris_tpu_torch.core.ggx import lerp_specular
from iris_tpu_torch.core.segment import segment_sum
from iris_tpu_torch.core.vecmath import normalize
from iris_tpu_torch.geometry.intersect import ray_intersect
from iris_tpu_torch.models.brdf import NGPBRDF, ngp_brdf_apply
from iris_tpu_torch.models.crf import (
    EmorCRF, crf_forward, reg_monotonically_increasing, reg_weight,
)
from iris_tpu_torch.render.integrator import draw_uniform, path_tracing_single
from iris_tpu_torch.utils.losses import mse, scale_invariant_mse, segment_mean


@dataclass
class LossConfig:
    """Hyperparameters, defaults per reference configs/config.py."""
    spp: int = 8
    n_spp_rounds: int = 1          # SPP // spp accumulation rounds
    ld: float = 5e-4               # diffuse regularization
    lp: float = 5e-3               # part-segmentation propagation
    ls: float = 1e-3               # semantic-segmentation propagation
    la: float = 0.0                # albedo anchor
    sigma_albedo: float = 0.05 / 3.0
    sigma_pos: float = 0.3 / 3.0
    l_crf_increasing: float = 0.1
    l_crf_weight: float = 0.001
    max_segments: int = 128        # segment-id bound
    has_part: bool = True
    n_pairs: int = 1024            # within-segment partner samples of the
                                   # semantic propagation loss
                                   # (train_brdf_crf.py:249)
    radiance_log_space: bool = False  # train log(radiance), so Adam moves
                                   # radiance multiplicatively


_RAD_EPS = 1e-4


def radiance_to_param(radiance, log_space: bool = True):
    """Stored emitter radiance -> trainable leaf: log(max(r, eps)) in log
    space, the radiance itself otherwise."""
    if not log_space:
        return radiance
    return torch.log(torch.clamp(
        torch.as_tensor(radiance, dtype=torch.float32), min=_RAD_EPS))


def param_to_radiance(param, log_space: bool = True):
    """Trainable leaf -> positive radiance (exp in log space)."""
    if not log_space:
        return param
    return torch.exp(param)


def _seg_ids(segmentation, max_segments):
    return torch.clamp(segmentation.to(torch.int64), 0, max_segments - 1)


def check_max_segments(segmentation, max_segments: int):
    """Host-side guard: ids beyond max_segments would alias into bucket
    max_segments-1 inside the losses, corrupting every segment-propagation
    term. Call once per dataset before training."""
    seg = (segmentation.detach().cpu().numpy()
           if isinstance(segmentation, torch.Tensor)
           else np.asarray(segmentation))
    top = int(seg.max()) if len(seg) else 0
    if top >= max_segments:
        raise ValueError(
            f"dataset has segment id {top} >= max_segments={max_segments}; "
            f"raise --max_segments to at least {top + 1}")


class _Gather1d(torch.autograd.Function):
    """x[idx] for 1-D x and flat idx with an explicit backward, a segment
    sum in an order the indices fix (_gather1d, steps.py:105-123)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[0]
        return x[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return segment_sum(g, idx, ctx.n), None


def _gather1d(x, idx):
    return _Gather1d.apply(x, idx)


def propagation_loss(gen, seg, valid, pos_n, albedo_d, roughness, metallic,
                     cfg: LossConfig, u: torch.Tensor | None = None):
    """Reference train_brdf_crf.py:240-290 as a fixed-shape estimator
    (steps.py:126-180 of the JAX package).

    Per pixel: cfg.n_pairs partners drawn uniformly (with replacement) from
    the VALID pixels of the SAME segment, bilateral weights
    exp(-|da|^2/2sa^2)*exp(-|dp|^2/2sp^2), weighted roughness/metallic
    means (denominator floor 1e-4), per-pixel L1 to the mean, per-segment
    mean, summed. Pixels are sorted by segment id (stable; invalid pixels
    get a sentinel id and sort last), so a pixel's segment is the run
    [searchsorted-left, searchsorted-right) of the sorted keys and a
    partner is start + floor(u * count). `u` (B, n_pairs) overrides the
    draws."""
    b = seg.shape[0]
    sort_key = torch.where(valid, seg, cfg.max_segments)
    order = torch.argsort(sort_key, stable=True)
    sorted_key = sort_key[order].contiguous()
    start = torch.searchsorted(sorted_key, sort_key, right=False)
    count = torch.searchsorted(sorted_key, sort_key, right=True) - start

    if u is None:
        u = draw_uniform(gen, (b, cfg.n_pairs), seg.device)
    j_sorted = start[:, None] + torch.minimum(
        (u * count[:, None]).to(torch.int64),
        torch.clamp(count[:, None] - 1, min=0))
    jf = order[j_sorted.reshape(-1)]                     # (B*P,) originals

    d2a = torch.sum((albedo_d[jf].reshape(b, -1, 3)
                     - albedo_d[:, None]) ** 2, -1)
    d2p = torch.sum((pos_n[jf].reshape(b, -1, 3) - pos_n[:, None]) ** 2, -1)
    wij = torch.exp(-d2a / cfg.sigma_albedo ** 2 / 2.0) \
        * torch.exp(-d2p / cfg.sigma_pos ** 2 / 2.0)
    denom = torch.sum(wij, -1) + 1e-4
    # partner roughness/metallic carry gradients (reference scatter_add
    # over roughness[jj])
    r_j = _gather1d(roughness, jf).reshape(b, -1)
    m_j = _gather1d(metallic, jf).reshape(b, -1)
    mean_r = torch.sum(wij * r_j, -1) / denom
    mean_m = torch.sum(wij * m_j, -1) / denom
    per_pix = torch.abs(mean_r - roughness) + torch.abs(mean_m - metallic)
    seg_loss, _ = segment_mean(per_pix, _seg_ids(seg, cfg.max_segments),
                               cfg.max_segments, valid.to(torch.float32))
    return torch.sum(seg_loss)


def detach_material(ngp: NGPBRDF) -> NGPBRDF:
    """The same field with no gradient path into its table and MLP."""
    return dc_replace(
        ngp, table=ngp.table.detach(),
        mlp={k: [t.detach() for t in v] for k, v in ngp.mlp.items()})


def _split_rays(rays):
    return (rays[..., 0:3], normalize(rays[..., 3:6]), rays[..., 6:9],
            rays[..., 9:12])


def _render_rounds(gen, tracer, em, mat_fn, rays, cfg, samples):
    xs, ds, dxdu, dydv = _split_rays(rays)
    l = torch.zeros_like(xs)
    for r in range(cfg.n_spp_rounds):
        l = l + path_tracing_single(
            gen, tracer, em, mat_fn, xs, ds, dxdu, dydv, cfg.spp,
            samples=None if samples is None else samples["render"][r])
    return l / cfg.n_spp_rounds


def make_initialize_loss(tracer, em_template, crf: EmorCRF, cfg: LossConfig):
    """params = {"material": NGPBRDF, "radiance": (K,3)}. batch keys:
    rays (B,12), rgbs (B,3), exposure (B,1)|None, segmentation (B,),
    int_albedo (B,3).

    Reference initialize.py:150-202, with the JAX package's documented
    deviation: the albedo anchor is masked to valid first hits. The render
    runs with the material detached, so only the emitter takes render
    gradients (initialize.py:170-186); the material's gradient is the
    anchor's alone."""

    def loss_fn(params, batch, gen, samples=None):
        rays, rgbs_gt = batch["rays"], batch["rgbs"]
        xs, ds, dxdu, dydv = _split_rays(rays)
        em = dc_replace(em_template, radiance=param_to_radiance(
            params["radiance"], cfg.radiance_log_space))
        mat_fn_frozen = functools.partial(
            ngp_brdf_apply, detach_material(params["material"]))
        l = _render_rounds(gen, tracer, em, mat_fn_frozen, rays, cfg,
                           samples)
        ldr = crf_forward(crf, l, batch.get("exposure"))
        loss_c = mse(ldr, rgbs_gt)

        # albedo anchor against segment-mean pseudo albedo, live material
        dudv = (draw_uniform(gen, (2, xs.shape[0], 1), xs.device, -0.5, 0.5)
                if samples is None else samples["dudv"])
        wi = normalize(ds + dxdu * dudv[0] + dydv * dudv[1])
        positions, _, _, _, valid = ray_intersect(tracer, xs, wi)
        # stochastic-corner hash-grid gradients (the hot path)
        mat = ngp_brdf_apply(params["material"], positions, gen,
                             None if samples is None else samples["mat"])
        seg = _seg_ids(batch["segmentation"], cfg.max_segments)
        w = valid.to(torch.float32)
        _, mean_albedo = segment_mean(batch["int_albedo"], seg,
                                      cfg.max_segments, weights=w)
        diff = (mat["albedo"] - mean_albedo) ** 2
        loss_a = torch.sum(diff * w[:, None]) / torch.clamp(
            torch.sum(w) * 3, min=1.0)

        loss = loss_c + loss_a
        return loss, {"loss_c": loss_c, "loss_a": loss_a}

    return loss_fn


def make_train_emitter_loss(tracer, em_template, material_params,
                            crf: EmorCRF, cfg: LossConfig):
    """params = {"radiance": (K,3)}; rendered MSE only
    (train_emitter.py)."""
    mat_fn = functools.partial(ngp_brdf_apply,
                               detach_material(material_params))

    def loss_fn(params, batch, gen, samples=None):
        em = dc_replace(em_template, radiance=param_to_radiance(
            params["radiance"], cfg.radiance_log_space))
        l = _render_rounds(gen, tracer, em, mat_fn, batch["rays"], cfg,
                           samples)
        ldr = crf_forward(crf, l, batch.get("exposure"))
        loss_c = mse(ldr, batch["rgbs"])
        return loss_c, {"loss_c": loss_c}

    return loss_fn


def make_brdf_crf_loss(tracer, crf_template: EmorCRF, cfg: LossConfig,
                       voxel_min, voxel_max, mat_fn=None):
    """params = {"material": NGPBRDF, "crf_weight": (3,dim)}.

    batch keys: rays (B,12), rgbs, exposure, diffuse (B,3),
    specular0/1 (B,R,3), segmentation (B,), int_albedo (B,3).
    Reference train_brdf_crf.py:163-314.

    mat_fn(params, positions, gen, samples) overrides the NGP material
    query (an analytic material pins the loss semantics in tests)."""

    def loss_fn(params, batch, gen, samples=None):
        rays, rgbs_gt = batch["rays"], batch["rgbs"]
        xs, ds = rays[..., 0:3], normalize(rays[..., 3:6])
        positions, _, _, _, valid = ray_intersect(tracer, xs, ds)
        w = valid.to(torch.float32)

        s_mat = None if samples is None else samples["mat"]
        mat = (ngp_brdf_apply(params["material"], positions, gen, s_mat)
               if mat_fn is None
               else mat_fn(params, positions, gen, s_mat))
        albedo, metallic, roughness = (mat["albedo"], mat["metallic"],
                                       mat["roughness"])
        kd = albedo * (1.0 - metallic)
        ks = 0.04 * (1.0 - metallic) + albedo * metallic

        ld_shade = kd * batch["diffuse"]
        ls_shade = ks * lerp_specular(batch["specular0"], roughness) \
            + lerp_specular(batch["specular1"], roughness)
        l = ld_shade + ls_shade

        crf = dc_replace(crf_template, weight=params["crf_weight"])
        ldr = crf_forward(crf, l, batch.get("exposure"))
        loss_c = torch.sum(((ldr - rgbs_gt) ** 2) * w[:, None]) \
            / torch.clamp(torch.sum(w) * 3, min=1.0)

        # diffuse prior (reference :210)
        loss_d = cfg.ld * (
            _wmean(torch.abs(roughness - 1.0), w) + _wmean(metallic, w))

        seg = _seg_ids(batch["segmentation"], cfg.max_segments)
        if cfg.has_part:
            # weighted per-part means, weight = (1-roughness) detached (:223)
            ws = ((1.0 - roughness[:, 0]).detach() + 1e-4) * w
            _, mean_m = segment_mean(metallic[:, 0], seg, cfg.max_segments,
                                     ws)
            _, mean_r = segment_mean(roughness[:, 0], seg, cfg.max_segments,
                                     ws)
            loss_seg = cfg.lp * (
                _wmean(torch.abs(metallic[:, 0] - mean_m), w)
                + _wmean(torch.abs(roughness[:, 0] - mean_r), w))
        else:
            # semantic propagation: bilateral-weighted within-segment means
            # by segment-sorted partner sampling (reference :240-290)
            pos_n = (positions - voxel_min) / (voxel_max - voxel_min) * 2 - 1
            loss_seg = cfg.ls * propagation_loss(
                gen, seg, valid, pos_n, albedo.detach(), roughness[:, 0],
                metallic[:, 0], cfg,
                None if samples is None else samples["pairs_u"])

        # albedo anchor (:292-306)
        if cfg.la > 0:
            _, mean_tgt = segment_mean(batch["int_albedo"], seg,
                                       cfg.max_segments, w)
            loss_a = cfg.la * scale_invariant_mse(mean_tgt, albedo)
        else:
            loss_a = 0.0

        reg_crf = cfg.l_crf_increasing * reg_monotonically_increasing(crf) \
            + cfg.l_crf_weight * reg_weight(crf)

        loss = loss_c + loss_d + loss_seg + loss_a + reg_crf
        return loss, {"loss_c": loss_c, "loss_d": loss_d,
                      "loss_seg": loss_seg, "reg_crf": reg_crf}

    return loss_fn


def _wmean(x, w):
    wb = (w[:, None] if x.dim() > 1 else w).expand(x.shape)
    return torch.sum(x * wb) / torch.clamp(torch.sum(wb), min=1.0)
