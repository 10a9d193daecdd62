"""The `train_brdf_crf` stage's training job: the stage's loss through
`run_training` at `chunk_steps`, fed by `RayBatcher` over a seeded pixel
bank with the columns the stage reads (rays, targets, exposure, segments,
the albedo pseudo target, and the baked diffuse and specular0/1 shadings)
held on the card by `place_bank`, with `make_optimizer`'s Adam, as the
stage's CLI runs it. The traffic's
`loss` holds the stage's settings: `has_part` 1 takes the per-part
weighted means, 0 the semantic propagation loss.

The run and its check are the `initialize` kind's (kinds/initialize.py):
set-up drives one state from the seed through step 0 (a plain step) and
steps 1-2 (the eager warm-up chunk); the window's chunks are replays of
the graph the next run_training call captures; the chunk after the window
is the checked chunk. The reference (benchmark/reference_brdf.py) takes
its batches by the trainer's rule (gen.batches) and follows steps 0-2 from
the seed's weights and the checked chunk from the program's state before
it. initialize's five gaps decide `correct`, with a sixth: the stage's
segment term (the per-part means or the propagation loss) is a small part
of the loss, so its own value at steps 0-2 is compared too
(seg_loss_gap)."""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from benchmark import gen, gen_brdf
from benchmark import reference_brdf as RB
from benchmark.kinds import common
from benchmark.kinds import initialize as I
from benchmark.timer import WindowTimer

START = I.START


def loss_settings(tr: dict) -> dict:
    return dict(tr["loss"], max_segments=tr["max_segments"])


def _drive(h):
    """The program's run (initialize's _drive with the stage's loss and
    leaves). Returns (inputs, bank, p0, the program's readings, the
    checked chunk's state before it, on the device)."""
    from iris_tpu_torch.data.datasets import RayBatcher, place_bank
    from iris_tpu_torch.train.loop import make_run_graphs, run_training
    from iris_tpu_torch.train.optim import make_optimizer, named_leaves
    from iris_tpu_torch.train.steps import LossConfig, make_brdf_crf_loss

    tr, cfg, dev = h.traffic, h.config, h.device
    inp = common.Inputs(cfg, tr, h.seed, dev)
    bank = gen_brdf.pixel_bank(inp.views, inp.hw, tr, h.seed)
    p0 = gen.clone(inp.weights)             # the reference's copy
    tracer, _, crf, field = common.program_scene(inp)
    params = {"material": field, "crf_weight": inp.weights["crf_weight"]}
    opt = make_optimizer(tr["learning_rate"], 0.0, tuple(tr["milestones"]),
                         tr["milestone_rate"], "Adam")
    ls = loss_settings(tr)
    lcfg = h.patch("loss_config", LossConfig(
        ld=ls["ld"], lp=ls["lp"], ls=ls["ls"], la=ls["la"],
        sigma_albedo=ls["sigma_albedo"], sigma_pos=ls["sigma_pos"],
        l_crf_increasing=ls["l_crf_increasing"],
        l_crf_weight=ls["l_crf_weight"], max_segments=ls["max_segments"],
        has_part=bool(ls["has_part"]), n_pairs=ls["n_pairs"]))
    lo, hi = inp.bounds
    loss_fn = h.patch("loss", make_brdf_crf_loss(tracer, crf, lcfg, lo, hi))
    opt = h.patch("optimizer", opt)
    batcher = RayBatcher(place_bank(bank, dev), tr["batch_size"],
                         seed=h.seed)
    graphs = make_run_graphs(dev)
    opt_state = opt.init(params)
    run_seed = h.seed % (1 << 62)
    chunk = tr["chunk_steps"]

    losses, segs, bad = {}, {}, [0]

    def hook(step, p, loss, aux):
        losses[step] = float(loss)
        segs[step] = float(aux["loss_seg"])
        if rn.stage == "window":
            bad[0] += not math.isfinite(losses[step])
            if (step - START) % chunk == chunk - 1:
                rn.timer.mark(chunk)

    rn = I._Run(h, WindowTimer, I.Check(params, opt_state, dev))
    feed = I.Feed(batcher.iter_from(0), chunk, rn)
    rn.feed = feed
    kw = dict(log_fn=None, hooks=[hook], opt_state=opt_state,
              return_state=True, chunk_steps=chunk, graphs=graphs)
    run_training(loss_fn, params, feed, opt, 1, run_seed, start_step=0, **kw)
    g1 = I._leaf_norms((k, opt_state["opt"].state[t].get(
        "exp_avg", torch.zeros(())) / (1 - I.B1))
        for k, t in named_leaves(params))
    run_training(loss_fn, params, feed, opt, START, run_seed, start_step=1,
                 **kw)
    change = I._leaf_norms((k, t - p) for (k, t), p in zip(
        named_leaves(params), RB.leaves_of(p0)))
    feed.n, feed.step0 = 0, START    # the chunk count of the last call
    try:
        run_training(loss_fn, params, feed, opt, 1 << 40, run_seed,
                     start_step=START, **kw)
    except I.WindowClosed:
        pass
    _, steps, window_s = rn.timer.finish()
    h.result.window(
        attempted=steps, failed=bad[0],
        metrics={"train_step_ms": 1e3 * window_s / max(steps, 1)},
        work={"steps": steps, "window_s": window_s})
    if h.trace:
        h.result.traced(rn.prof, tr["traced_units"] * chunk, extra={
            "batcher_ms": 1e3 * float(np.mean(
                feed.batcher_s[rn.window_batch:rn.window_end_batch]))})
    h.result.memory(dev)
    check = rn.check
    checked = list(range(check.step, check.step + chunk))
    prog = {"loss": [losses[s] for s in range(START)], "grad": g1,
            "change": change, "seg": [segs[s] for s in range(START)],
            "chunk_loss": [losses[s] for s in checked],
            "chunk_seg": [segs[s] for s in checked],
            "chunk_change": check.change}
    print(f"[bench] checked chunk: steps {check.step}-"
          f"{check.step + chunk - 1}", file=sys.stderr)
    state = _state(check, p0, dev)
    check.params = check.opt_state = None
    del params, opt_state, graphs, loss_fn, field, tracer, crf
    inp.weights = p0                 # the trained leaves go with the state
    common.free_cuda()
    return inp, bank, p0, prog, state


def _state(check, p0: dict, device) -> dict:
    """{"w", "m", "v", "step"} before the checked chunk, on `device`: the
    program's leaves in a weights tree of p0's form, the moments in the
    tree's leaf order."""
    w = gen.clone(p0)
    m, v = [], []
    for name, leaf in zip(RB.leaf_names(w), RB.leaves_of(w)):
        t, mi, vi = check.before[name]
        leaf.copy_(t.to(device))
        m.append(mi.to(device))
        v.append(vi.to(device))
    return {"w": w, "m": m, "v": v, "step": check.step}


def reference(inp, bank: dict, p0: dict, state: dict, seed: int, tr: dict,
              dt, faults: dict | None = None) -> dict:
    """The reference's readings in `dt`, on its own batches: steps 0-2 from
    p0 ("loss", "grad", "change") and the checked chunk's steps from
    `state` ("chunk_loss", "chunk_grad", "chunk_change"). faults: see
    reference_brdf.step_loss."""
    run_seed = seed % (1 << 62)
    first = state["step"]
    chunk = list(range(first, first + tr["chunk_steps"]))
    rows = gen.batches(bank, tr["batch_size"], seed,
                       list(range(START)) + chunk)
    scene, field, crf = common.reference_scene(inp, p0, dt)
    ls = loss_settings(tr)

    def lr_at(step):
        return I.learning_rate(tr, step)

    a = RB.follow(scene, field, crf, {"w": p0}, list(range(START)), rows,
                  run_seed, ls, lr_at, inp.device, faults)
    b = RB.follow(scene, field, crf, state, chunk, rows, run_seed, ls,
                  lr_at, inp.device, faults)
    return dict(a, chunk_loss=b["loss"], chunk_grad=b["grad"],
                chunk_change=b["change"], chunk_seg=b["seg"])


def run(h):
    tr = h.traffic
    inp, bank, p0, prog, state = _drive(h)
    t0 = time.perf_counter()
    ref = reference(inp, bank, p0, state, h.seed, tr, torch.float32)
    print(f"[bench] reference {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    for key, label in (("grad", "steps 0-2"), ("chunk_grad", "checked chunk")):
        keep = I.kept_leaves(ref[key])
        print(f"[bench] first-gradient norms by leaf, {label} (reference; * "
              "left out of the change's gap): " + ", ".join(
                  f"{k} {v:.3e}{'' if k in keep else ' *'}"
                  for k, v in ref[key].items()), file=sys.stderr)
    print("[bench] checked chunk's change by leaf (program / reference): "
          + ", ".join(f"{k} {prog['chunk_change'][k]:.6e} / {v:.6e}"
                      for k, v in ref["chunk_change"].items()),
          file=sys.stderr)
    print("[bench] segment term by step (program / reference): " + ", ".join(
        f"{a:.6e} / {b:.6e}" for a, b in zip(prog["seg"] + prog["chunk_seg"],
                                             ref["seg"] + ref["chunk_seg"])),
          file=sys.stderr)
    h.result.numbers(numbers(prog, ref))


def numbers(prog: dict, ref: dict) -> dict:
    """initialize's five gaps, and seg_loss_gap: the worst of steps 0-2's
    relative gaps of the stage's segment term (loss_seg). The checked
    chunk's segment term is left out: from the program's own state, ten
    Adam steps carry a rounding's difference far in so steep a term (its
    bilateral weights fall by e over an albedo distance of 0.024)."""
    return dict(I.numbers(prog, ref),
                seg_loss_gap=I._loss_gap(prog["seg"], ref["seg"]))


def control(h) -> dict:
    """Readings of the check's numbers from one run of the program with a
    window of h.seconds: the program's against the float32 reference
    ("sound"), and, each against the same reference, the reference in
    bfloat16 in the program's place (the control) and the reference with a
    planted fault: half of each batch left out; in the semantic traffic
    also partners drawn across segments, and 512 partners a pixel. A step
    that leaves the state unchanged reads 1 by construction and is not
    run."""
    tr = h.traffic
    inp, bank, p0, prog, state = _drive(h)
    ref = reference(inp, bank, p0, state, h.seed, tr, torch.float32)
    out = {"sound": numbers(prog, ref)}
    runs = [("bfloat16", dict(dt=torch.bfloat16)),
            ("half_batch", dict(dt=torch.float32, faults={"half": True}))]
    if not tr["loss"]["has_part"]:
        runs += [("across_segments", dict(dt=torch.float32,
                                          faults={"across": True})),
                 ("n_pairs_512", dict(dt=torch.float32,
                                      faults={"n_pairs": 512}))]
    for name, kw in runs:
        got = reference(inp, bank, p0, state, h.seed, tr, **kw)
        out[name] = numbers(got, ref)
    return out
