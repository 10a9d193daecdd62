"""Inline validation hooks for the trainers (counterpart of
iris_tpu/train/validation.py: ScalarLogger :31, make_material_diag_hook
:48, make_validation_hook :112; reference train_brdf_crf.py:331-453).

The hooks are run_training hooks, h(step, params, loss, aux). The scalar
log and the diag records are the JAX package's JSONL records, field for
field. The validation frame renders in chunks of at most 8,192 pixels,
each with its own generator (val_generator(step, c), the counterpart of
fold_in(PRNGKey(step), c)); the last chunk is the frame's remainder, so no
filler ray is traced and none can reach an image. On the card a chunk is
one CUDA graph replay (the JAX package's jitted render_chunk,
validation.py:144), one capture for the full chunks and one for the
remainder.
"""

from __future__ import annotations

import functools
import json
import os
import time
from dataclasses import replace as dc_replace

import numpy as np
import torch

from iris_tpu_torch.core.vecmath import normalize
from iris_tpu_torch.geometry.intersect import ray_intersect
from iris_tpu_torch.models.brdf import ngp_brdf_apply
from iris_tpu_torch.models.crf import crf_forward, get_crf
from iris_tpu_torch.render.denoise import denoise_hdr
from iris_tpu_torch.render.integrator import path_tracing, path_tracing_single
from iris_tpu_torch.train.optim import named_leaves
from iris_tpu_torch.utils.graphs import GraphContext, GraphedUnit
from iris_tpu_torch.utils.image import save_image
from iris_tpu_torch.utils.metric_crf import plot_crfs

VAL_CHUNK = 8192


class ScalarLogger:
    """Append-only JSONL scalar log (role of Lightning self.log)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self.t0 = time.time()

    def __call__(self, step: int, params, loss, aux):
        rec = {"step": int(step), "loss": float(loss),
               "wall_s": round(time.time() - self.t0, 2)}
        for k, v in (aux or {}).items():
            rec[k] = float(v)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def make_material_diag_hook(tracer, val_batch, jsonl_path: str,
                            val_step: int = 250, max_points: int = 16384):
    """Roughness-saturation diagnostic: every val_step, the material at
    fixed first-hit points of the validation frame (at most max_points,
    drawn by np.random.default_rng(0) as in the JAX package, so both pick
    the same points) gives {rough_mean, rough_ceiling_frac,
    rough_floor_frac}, appended to the trainer's JSONL; a ceiling fraction
    over 0.5 adds a warning naming the counter-lever, the diffuse-prior
    weight ld."""
    dev = tracer.nodes.device
    rays = np.asarray(val_batch["rays"], np.float32)
    pts = []
    for c in range(0, rays.shape[0], VAL_CHUNK):
        rc = torch.from_numpy(rays[c:c + VAL_CHUNK]).to(dev)
        pos, _, _, _, valid = ray_intersect(tracer, rc[:, :3],
                                            normalize(rc[:, 3:6]))
        pts.append(pos[valid].cpu().numpy())
    pts = np.concatenate(pts, 0)
    if len(pts) == 0:
        # no first hit: the means would be NaN, and a NaN ceiling share
        # would switch the warning off in silence
        print("[diag] material diag hook disabled: val rays hit nothing")
        return lambda step, params, loss, aux: None
    if len(pts) > max_points:
        pts = pts[np.random.default_rng(0).choice(len(pts), max_points,
                                                  replace=False)]
    pts = torch.from_numpy(pts).to(dev)

    @torch.no_grad()
    def rough_stats(material):
        r = ngp_brdf_apply(material, pts)["roughness"][:, 0]
        return torch.stack([torch.mean(r), torch.mean((r > 0.98).float()),
                            torch.mean((r < 0.04).float())]).tolist()

    def hook(step, params, loss, aux):
        if step % val_step != 0 or "material" not in params:
            return
        mean, ceil_f, floor_f = rough_stats(params["material"])
        rec = {"step": int(step), "rough_mean": round(mean, 4),
               "rough_ceiling_frac": round(ceil_f, 4),
               "rough_floor_frac": round(floor_f, 4)}
        if ceil_f > 0.5:
            rec["warning"] = (
                "roughness saturated at the sigmoid ceiling for "
                f"{ceil_f:.0%} of surface points - specular signal likely "
                "below the MC floor; counter-lever: raise the diffuse "
                "prior weight ld (LossConfig.ld)")
            print(f"[diag] {rec['warning']}")
        with open(jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    return hook


def val_seed(step: int, chunk: int) -> int:
    """The seed of one validation chunk's stream, from (step, chunk)."""
    return (int(step) << 16) + int(chunk)


def val_generator(step: int, chunk: int, device) -> torch.Generator:
    """The generator of one validation chunk: a stream from (step, chunk),
    the counterpart of fold_in(PRNGKey(step), chunk). path_tracing_single
    draws from it first, then path_tracing."""
    gen = torch.Generator(device=device)
    gen.manual_seed(val_seed(step, chunk))
    return gen


def make_validation_hook(
    tracer, em_template, crf_template, val_batch, img_hw,
    out_dir: str, val_step: int = 250, spp: int = 8, indir_depth: int = 5,
    crf_gt=None, frozen: dict | None = None, param_tx=None,
    graphs: GraphContext | None = None,
):
    """Hook(step, params, loss, aux): every val_step, render the validation
    frame with both integrators from the CURRENT params, denoise, tone-map
    through the CRF and write {step:05d}_L_train.png, _L_full.png, _L_gt.png
    and _crfs.png. params may hold any of material / radiance / crf_weight;
    `frozen` supplies the leaves not trained (the fixed material and CRF of
    train_emitter), `param_tx` maps the trained leaves to model space (exp
    for --radiance_log_space). hook.render(params, step) returns
    (L_train, L_full, CRF curves) as numpy.

    On the card a chunk is one CUDA graph replay (utils.graphs.
    GraphedUnit, its generator reseeded val_seed(step, c)), which reads
    the parameter tensors in place: param_tx and the emitter's radiance
    are applied inside it. A hook's graphs stay bound to the parameter
    tensors of its first render (the trainers update them in place);
    other ones raise. `graphs` is the GraphContext to capture in (the
    trainer's, whose pool the chunks of run_training share; every output
    is copied out before the next replay); None makes one."""
    frozen = frozen or {}
    param_tx = param_tx or (lambda p: p)
    os.makedirs(out_dir, exist_ok=True)
    dev = tracer.nodes.device
    rays = torch.from_numpy(np.asarray(val_batch["rays"], np.float32)).to(dev)
    h, w = img_hw
    ray_chunks = torch.split(rays, VAL_CHUNK)
    live = {"params": None, "bound": None}
    exposure = val_batch.get("exposure")
    exposure = 1.0 if exposure is None else float(exposure)

    def model(params):
        params = param_tx({**frozen, **params})
        em = em_template
        if "radiance" in params:
            em = dc_replace(em, radiance=params["radiance"])
        crf = crf_template
        if "crf_weight" in params:
            crf = dc_replace(crf, weight=params["crf_weight"])
        return params, em, crf

    @torch.no_grad()
    def render_chunk(gen, rc):
        params, em, _ = model(live["params"])
        mat_fn = functools.partial(ngp_brdf_apply, params["material"])
        xs, ds = rc[:, :3], normalize(rc[:, 3:6])
        dxdu, dydv = rc[:, 6:9], rc[:, 9:12]
        return (path_tracing_single(gen, tracer, em, mat_fn, xs, ds, dxdu,
                                    dydv, spp),
                path_tracing(gen, tracer, em, mat_fn, xs, ds, dxdu, dydv,
                             spp, indir_depth))

    unit = GraphedUnit(render_chunk, dev, graphs, "validation_chunk")

    @torch.no_grad()
    def render(params, step):
        leaves = [t for _, t in named_leaves(params)]
        if unit.ctx is not None:
            bound = live["bound"] = live["bound"] or leaves
            if len(leaves) != len(bound) or any(
                    a is not b for a, b in zip(leaves, bound)):
                raise ValueError(
                    "a validation hook's graphs read the parameter tensors "
                    "of its first render; make a new hook for other ones")
        live["params"] = params
        lt = torch.empty((rays.shape[0], 3), device=dev)
        lf = torch.empty((rays.shape[0], 3), device=dev)
        off = 0
        for c, rc in enumerate(ray_chunks):
            got_t, got_f = unit(rc, seed=val_seed(step, c))
            lt[off:off + rc.shape[0]].copy_(got_t)
            lf[off:off + rc.shape[0]].copy_(got_f)
            off += rc.shape[0]
        _, _, crf = model(params)
        return (lt.cpu().numpy(), lf.cpu().numpy(),
                get_crf(crf).cpu().numpy())

    def hook(step, params, loss, aux):
        if step % val_step != 0:
            return
        l_train, l_full, crf_curves = render(params, step)
        _, _, crf = model(params)
        for name, img in [("L_train", l_train), ("L_full", l_full)]:
            hdr = denoise_hdr(img.reshape(h, w, 3), device=dev)
            with torch.no_grad():
                ldr = crf_forward(crf, torch.from_numpy(
                    hdr.reshape(-1, 3)).to(dev), exposure)
            save_image(ldr.cpu().numpy().reshape(h, w, 3),
                       os.path.join(out_dir, f"{step:05d}_{name}.png"))
        save_image(np.asarray(val_batch["rgbs"]).reshape(h, w, 3),
                   os.path.join(out_dir, f"{step:05d}_L_gt.png"))
        plot_crfs(crf_curves, crf_gt,
                  os.path.join(out_dir, f"{step:05d}_crfs.png"))

    hook.render = render
    return hook
