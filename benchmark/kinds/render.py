"""The final render: frames rendered back to back through `render_frame`
over the render CLI's round (`make_render_round` of `make_render_fns`),
each then denoised and mapped through the camera response, as the render
CLI does before it writes files (nothing is written here).

Set-up makes the round warm (one eager round, then one capture). The
window renders frames until `seconds` have passed; a round counts when it
ends within the window. The check takes one of the window's frames, drawn
from the seed, and a seeded sample of its pixels: the reference renders
those pixels' 64 rounds from the same draws (radiance and the six AOVs),
then denoises the program's own radiance and maps the program's own
denoised image, so that each stage is judged on its own input."""

from __future__ import annotations

import functools
import sys
import time

import numpy as np
import torch

from benchmark import compare, gen
from benchmark import reference as R
from benchmark.kinds import common


def frame_seed(seed: int, k: int) -> int:
    return (int(seed) * 1000003 + k) % (1 << 62)


def run(h):
    from iris_tpu_torch.models.brdf import ngp_brdf_apply
    from iris_tpu_torch.models.crf import crf_forward
    from iris_tpu_torch.pipeline.render import (
        make_render_fns, make_render_round, render_frame,
    )
    from iris_tpu_torch.render.denoise import denoise_hdr

    from benchmark.timer import WindowTimer, sync

    tr, cfg, dev = h.traffic, h.config, h.device
    inp = common.Inputs(cfg, tr, h.seed, dev)
    w_ref = gen.clone(inp.weights)
    tracer, em, crf, field = common.program_scene(inp)
    mat_fn = functools.partial(ngp_brdf_apply, field)
    rnd = h.patch("round", make_render_round(*make_render_fns(
        tracer, em, mat_fn, tr["spp"], tr["indir_depth"]), dev))
    hh, ww = inp.hw
    n_pix = hh * ww
    n_rounds = tr["SPP"] // tr["spp"]
    views = torch.from_numpy(np.ascontiguousarray(inp.views)).to(dev)
    rnd(views[0], seed=1)                # eager warm-up
    rnd(views[0], seed=2)                # capture, then replay
    sync(dev)
    h.setup_done()

    timer = WindowTimer(h.seconds, dev)
    samples = n_pix * tr["spp"]

    def unit(rays, seed=None):
        out = rnd(rays, seed=seed)
        timer.mark(samples)
        return out

    frames = []
    timer.start()
    k = 0
    while not timer.expired():
        view = k % len(inp.views)
        l_full, aovs = render_frame(unit, views[view], n_rounds,
                                    frame_seed(h.seed, k))
        img = denoise_hdr(l_full.reshape(hh, ww, 3),
                          albedo=aovs[0].reshape(hh, ww, 3), device=dev)
        with torch.no_grad():
            ldr = crf_forward(crf, torch.from_numpy(img.reshape(-1, 3))
                              .to(dev), 1.0).cpu().numpy()
        frames.append({"k": k, "view": view, "l": l_full, "aovs": aovs,
                       "img": img, "ldr": ldr})
        k += 1
    units, work, window_s = timer.finish()
    bad = sum(n_rounds for f in frames
              if not all(np.isfinite(a).all() for a in [f["l"], f["img"],
                                                         f["ldr"]]
                         + f["aovs"]))
    h.result.window(attempted=units, failed=min(bad, units),
                    metrics={"render_samples_per_s": work / window_s},
                    work={"rounds": units, "window_s": window_s})
    rng = np.random.default_rng([h.seed, 3])
    f = frames[int(rng.integers(len(frames)))]
    pix = np.sort(rng.choice(n_pix, tr["check_pixels"], replace=False))
    unit_counts = None
    if h.trace:
        from iris_tpu_torch.geometry.cuda_intersect import kernel_counts

        # the checked frame's view, whose sampled paths the roofline counts
        n = tr["traced_units"]
        c0 = kernel_counts(dev)
        prof = h.start_profiler()
        with torch.profiler.record_function("bench_unit"):
            render_frame(rnd, views[f["view"]], n, frame_seed(h.seed, k))
        prof.stop()
        c1 = kernel_counts(dev)
        rays = sum(c1[x][1] - c0[x][1] for x in c1) / n
        calls = sum(c1[x][0] - c0[x][0] for x in c1) / n
        h.result.traced(prof, n)
        unit_counts = {"rays": rays, "calls": calls}
    h.result.memory(dev)
    del rnd, tracer, em, field, mat_fn, views
    common.free_cuda()

    counts: dict = {}
    t0 = time.perf_counter()
    ref = render_pixels(inp, w_ref, f["view"], frame_seed(h.seed, f["k"]),
                        pix, tr, torch.float32, counts)
    nums = numbers(inp, w_ref, f, pix, ref, dev, torch.float32)
    print(f"[bench] reference {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    if unit_counts:
        scale = n_pix / len(pix) / n_rounds
        unit_counts.update(faces=len(inp.tris), slab=counts["slab"] * scale,
                           tri=counts["tri"] * scale)
        h.result.roofline(unit_counts)
    h.result.numbers(nums)


def numbers(inp, w, f, pix, ref, dev, dt) -> dict:
    """radiance_p50 / radiance_p99: quantiles of the sampled pixels'
    relative radiance gaps; aov_p99: the worst AOV's 99th percentile;
    denoise_max and crf_max: the largest relative gap of the whole
    denoised image and LDR frame against the reference's stage run on the
    program's own input."""
    hh, ww = inp.hw
    g_l = compare.value_gaps(f["l"][pix], ref["l"], 1e-3)
    aov = max(compare.quantile(compare.value_gaps(a[pix], r, 1e-3), 0.99)
              for a, r in zip(f["aovs"], ref["aovs"]))
    img_ref = R.denoise(f["l"].reshape(hh, ww, 3),
                        f["aovs"][0].reshape(hh, ww, 3), dev, dt)
    f0, basis = R.emor(inp.cfg["crf"]["dim"])
    ldr_ref = R.crf(torch.as_tensor(f0, device=dev).to(dt),
                    torch.as_tensor(basis, device=dev).to(dt),
                    w["crf_weight"].to(dt),
                    torch.as_tensor(f["img"].reshape(-1, 3), device=dev)
                    .to(dt), 1.0).float().cpu().numpy()
    return {
        "radiance_p50": compare.quantile(g_l, 0.5),
        "radiance_p99": compare.quantile(g_l, 0.99),
        "aov_p99": aov,
        "denoise_max": float(np.max(compare.value_gaps(
            f["img"], img_ref, 1e-3))),
        "crf_max": float(np.max(compare.value_gaps(f["ldr"], ldr_ref,
                                                   1e-3))),
    }


@torch.no_grad()
def render_pixels(inp, w, view, seed, pix, tr, dt, counts=None,
                  alter: float = 0.0) -> dict:
    """The reference's frame at pixels `pix`: every round's draws made as
    the program makes them (render_chunk's, then aov_chunk's), the lanes
    of `pix` kept, all rounds computed in one batch, each round's
    per-pixel mean added round after round and divided by the round
    count. {"l": (P, 3), "aovs": [kd, a', roughness, metallic, emission,
    slf]}. alter plants a fault: the first round's radiance scaled by
    1 + alter."""
    dev = inp.device
    scene, field, _ = common.reference_scene(inp, w, dt)
    spp, depth = tr["spp"], tr["indir_depth"]
    n_rounds = tr["SPP"] // spp
    rays_all = torch.from_numpy(np.ascontiguousarray(
        inp.views[view])).to(dev)
    b = rays_all.shape[0]
    n = b * spp
    p = torch.as_tensor(pix, device=dev)
    lanes = (p[:, None] * spp + torch.arange(spp, device=dev)).reshape(-1)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, dtype=torch.float32,
                          device=dev)

    def bounce():
        return (rand(n)[lanes], rand(n, 2)[lanes], rand(n)[lanes],
                rand(n, 2)[lanes])

    jit, first, indirect, aj, as2 = [], [], [], [], []
    for _ in range(n_rounds):
        dudv = (rand(2, b, spp, 1) * 1.0 + (-0.5))[:, p]
        jit.append(dudv)
        first.append(bounce())
        indirect.append([bounce() for _ in range(depth)])
        aj.append(rand(2, b, spp, 1)[:, p])
        as2.append(rand(n, 2)[lanes])

    def cat(xs):
        return torch.cat(xs).to(dt)

    rays = torch.repeat_interleave(rays_all[p], spp, dim=0).repeat(
        n_rounds, 1).to(dt)
    du = cat([d[0].reshape(-1, 1) for d in jit])
    dv = cat([d[1].reshape(-1, 1) for d in jit])
    dr = tuple(cat([x[i] for x in first]) for i in range(4))
    dri = [tuple(cat([x[j][i] for x in indirect]) for i in range(4))
           for j in range(depth)]
    l = R.path_full(scene, field, rays, du, dv, dr, dri, counts)
    out = R.aovs(scene, field, rays, cat([d[0].reshape(-1, 1) for d in aj]),
                 cat([d[1].reshape(-1, 1) for d in aj]), cat(as2), counts)

    def frame_mean(x, scale0=1.0):
        per = x.reshape(n_rounds, len(pix), spp, -1).mean(2)
        acc = per[0] * scale0
        for r in range(1, n_rounds):
            acc = acc + per[r]
        return (acc / n_rounds).float().cpu().numpy()

    return {"l": frame_mean(l, 1.0 + alter),
            "aovs": [frame_mean(a) for a in out]}


def control(h) -> dict:
    """Readings of the check's numbers on the cell's own inputs, each
    against the float32 reference: the reference in bfloat16 (the
    control) and the reference with an answer altered where it is made
    (the first round of the frame 1% brighter). The denoise and CRF stages
    read a frame of 8 rounds that the program renders."""
    from iris_tpu_torch.models.brdf import ngp_brdf_apply
    from iris_tpu_torch.pipeline.render import (
        make_render_fns, make_render_round, render_frame,
    )

    tr, dev = h.traffic, h.device
    inp = common.Inputs(h.config, tr, h.seed, dev)
    w = gen.clone(inp.weights)
    tracer, em, crf, field = common.program_scene(inp)
    rnd = make_render_round(*make_render_fns(
        tracer, em, functools.partial(ngp_brdf_apply, field), tr["spp"],
        tr["indir_depth"]), dev)
    views = torch.from_numpy(np.ascontiguousarray(inp.views[:1])).to(dev)
    l_full, aovs = render_frame(rnd, views[0], 8, frame_seed(h.seed, 0))
    del rnd, tracer, em, field, views
    common.free_cuda()
    hh, ww = inp.hw
    n_pix = hh * ww
    rng = np.random.default_rng([h.seed, 3])
    pix = np.sort(rng.choice(n_pix, tr["check_pixels"], replace=False))
    fs = frame_seed(h.seed, 0)
    ref = render_pixels(inp, w, 0, fs, pix, tr, torch.float32)
    img = R.denoise(l_full.reshape(hh, ww, 3), aovs[0].reshape(hh, ww, 3),
                    dev)
    f0, basis = R.emor(inp.cfg["crf"]["dim"])
    ldr = R.crf(torch.as_tensor(f0, device=dev),
                torch.as_tensor(basis, device=dev), w["crf_weight"],
                torch.as_tensor(img.reshape(-1, 3), device=dev), 1.0
                ).cpu().numpy()
    out = {}
    for name, dt, alter in (("bfloat16", torch.bfloat16, 0.0),
                            ("altered_round", torch.float32, 0.01)):
        got = render_pixels(inp, w, 0, fs, pix, tr, dt, alter=alter)
        full_l = l_full.copy()
        full_l[pix] = got["l"]
        aov_full = [a.copy() for a in aovs]
        for a, g in zip(aov_full, got["aovs"]):
            a[pix] = g
        if dt == torch.float32:
            img_c, ldr_c = img, ldr
        else:
            img_c = R.denoise(l_full.reshape(hh, ww, 3),
                              aovs[0].reshape(hh, ww, 3), dev, dt)
            ldr_c = R.crf(torch.as_tensor(f0, device=dev).to(dt),
                          torch.as_tensor(basis, device=dev).to(dt),
                          w["crf_weight"].to(dt),
                          torch.as_tensor(img_c.reshape(-1, 3),
                                          device=dev).to(dt), 1.0
                          ).float().cpu().numpy()
        f = {"l": full_l, "aovs": aov_full, "img": img_c, "ldr": ldr_c}
        # the stages judged on the program frame's own input
        f_stage = {"l": l_full, "aovs": aovs, "img": img_c, "ldr": ldr_c}
        nums = numbers(inp, w, f, pix, ref, dev, torch.float32)
        stage = numbers(inp, w, f_stage, pix, ref, dev, torch.float32)
        nums.update(denoise_max=stage["denoise_max"],
                    crf_max=stage["crf_max"])
        out[name] = nums
    return out
