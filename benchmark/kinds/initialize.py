"""The `initialize` stage's training job: the stage's loss through
`run_training` at `chunk_steps`, fed by `RayBatcher` over a seeded pixel
bank, as the stage's CLI runs it.

Set-up builds one training state (field, radiance, Adam), drives it from
the seed through step 0 (one plain step, after which Adam's first moment
holds the first gradient) and steps 1-2 (one eager chunk on the graphs'
stream, the warm-up), then hands the same state to one run_training call:
its first chunk captures the graph, and each later chunk is one replay.
The window starts when that call asks for its second chunk, and ends at
the first chunk boundary past `seconds`. The chunk after the window, a
replay like the window's, is the checked chunk: the program's state before
it (leaves and Adam's moments) is copied to the host, and each leaf's
change over it is taken after it. Traced runs then profile a few more
chunks.

The reference takes its batches from the bank by the trainer's batching
rule (gen.batches) and follows two stretches: steps 0-2 from the seed's
weights (each step's loss, the first gradient by leaf, each leaf's change
after the three), and the checked chunk's steps from the program's state
before it (each step's loss, each leaf's change after the chunk)."""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from benchmark import compare, gen
from benchmark import reference as R
from benchmark.kinds import common
from benchmark.timer import sync

B1, B2, EPS = 0.9, 0.999, 1e-8
START = 3                  # steps 0-2 run in set-up


class WindowClosed(Exception):
    pass


class Feed:
    """The batch stream of the run's run_training calls, stepping the
    stages of the run at the chunk boundaries of the last call: the first
    chunk (capture), the window, the checked chunk and, in a traced run,
    the profiled chunks. It times each call into the batcher."""

    def __init__(self, it, chunk, run):
        self.it, self.chunk, self.run = it, chunk, run
        self.n = 0
        self.step0 = 0
        self.batcher_s: list = []

    def __iter__(self):
        return self

    def __next__(self):
        if self.n % self.chunk == 0:
            self.run.boundary(self.n // self.chunk, self.step0 + self.n)
        t = time.perf_counter()
        with torch.profiler.record_function("RayBatcher.next"):
            b = next(self.it)
        self.batcher_s.append(time.perf_counter() - t)
        self.n += 1
        return b


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


class Check:
    """The checked chunk: the program's leaves and Adam moments before it,
    on the host (so that they take nothing from the card's peak), its
    first step, and each leaf's change norm over it."""

    def __init__(self, params, opt_state, device):
        self.params, self.opt_state, self.device = params, opt_state, device
        self.step = None
        self.before: dict = {}
        self.change: dict = {}

    def begin(self, step: int) -> None:
        from iris_tpu_torch.train.optim import named_leaves

        sync(self.device)
        st = self.opt_state["opt"].state
        self.step = step
        for k, t in named_leaves(self.params):
            s = st[t]
            self.before[k] = tuple(
                _host(x) if x is not None else torch.zeros(t.shape)
                for x in (t, s.get("exp_avg"), s.get("exp_avg_sq")))

    def end(self) -> None:
        from iris_tpu_torch.train.optim import named_leaves

        sync(self.device)
        self.change = {k: float(torch.linalg.vector_norm(
            (_host(t) - self.before[k][0]).float()))
            for k, t in named_leaves(self.params)}

    def state(self, p0: dict, device) -> dict:
        """{"w", "m", "v", "step"} before the chunk, on `device`: the
        weights tree of p0 with the program's leaves in place, the moments
        in the tree's leaf order, and the chunk's first step."""
        w = gen.clone(p0)
        m, v = [], []
        for name, leaf in zip(leaf_names(w), _leaves_of(w)):
            t, mi, vi = self.before[name]
            leaf.copy_(t.to(device))
            m.append(mi.to(device))
            v.append(vi.to(device))
        return {"w": w, "m": m, "v": v, "step": self.step}


class _Run:
    def __init__(self, h, timer_cls, check):
        self.h = h
        self.timer = timer_cls(h.seconds, h.device)
        self.check = check
        self.stage = "capture"
        self.prof = self.rf = None
        self.traced = 0
        self.window_batch = self.window_end_batch = None

    def boundary(self, k, step):
        h = self.h
        if k == 0:
            return
        if self.stage == "capture":
            h.setup_done()
            self.timer.start()
            self.stage = "window"
            self.window_batch = len(self.feed.batcher_s)
            return
        if self.stage == "window":
            if not self.timer.expired():
                return
            self.window_end_batch = len(self.feed.batcher_s)
            self.check.begin(step)
            self.stage = "check"
            return
        if self.stage == "check":
            self.check.end()
            if not h.trace:
                raise WindowClosed
            self.stage = "traced"
            self.prof = h.start_profiler()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.traced += 1
        if self.traced == self.h.traffic["traced_units"]:
            self.prof.stop()
            raise WindowClosed
        self.rf = torch.profiler.record_function("bench_unit")
        self.rf.__enter__()


def _leaf_norms(named):
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in named}


def _drive(h):
    """The program's run: set-up, window, checked chunk and traced chunks,
    with the window's metrics, trace and peak memory given to h.result.
    Returns (inputs, bank, p0, the program's readings, the checked
    chunk's state before it, on the device)."""
    from iris_tpu_torch.data.datasets import RayBatcher
    from iris_tpu_torch.train.loop import make_run_graphs, run_training
    from iris_tpu_torch.train.optim import make_optimizer, named_leaves
    from iris_tpu_torch.train.steps import LossConfig, make_initialize_loss

    from benchmark.timer import WindowTimer

    tr, cfg, dev = h.traffic, h.config, h.device
    inp = common.Inputs(cfg, tr, h.seed, dev)
    bank = gen.pixel_bank(inp.views, inp.hw, tr["max_segments"], h.seed)
    p0 = gen.clone(inp.weights)             # the reference's copy
    tracer, em, crf, field = common.program_scene(inp)
    params = {"material": field, "radiance": inp.weights["radiance"]}
    opt = make_optimizer(tr["learning_rate"], 0.0, tuple(tr["milestones"]),
                         tr["milestone_rate"], "Adam")
    lcfg = LossConfig(spp=tr["spp"], n_spp_rounds=tr["SPP"] // tr["spp"],
                      max_segments=tr["max_segments"], has_part=True)
    loss_fn = h.patch("loss", make_initialize_loss(tracer, em, crf, lcfg))
    opt = h.patch("optimizer", opt)
    batcher = RayBatcher(bank, tr["batch_size"], seed=h.seed)
    graphs = make_run_graphs(dev)
    opt_state = opt.init(params)
    run_seed = h.seed % (1 << 62)
    chunk = tr["chunk_steps"]

    losses, bad = {}, [0]

    def hook(step, p, loss, aux):
        losses[step] = float(loss)
        if rn.stage == "window":
            bad[0] += not math.isfinite(losses[step])
            if (step - START) % chunk == chunk - 1:
                rn.timer.mark(chunk)

    rn = _Run(h, WindowTimer, Check(params, opt_state, dev))
    feed = Feed(batcher.iter_from(0), chunk, rn)
    rn.feed = feed
    kw = dict(log_fn=None, hooks=[hook], opt_state=opt_state,
              return_state=True, chunk_steps=chunk, graphs=graphs)
    # step 0: Adam's first moment is then (1 - b1) times the gradient
    run_training(loss_fn, params, feed, opt, 1, run_seed, start_step=0, **kw)
    # a leaf the optimizer has no state for got no gradient
    g1 = _leaf_norms((k, opt_state["opt"].state[t].get(
        "exp_avg", torch.zeros(())) / (1 - B1))
        for k, t in named_leaves(params))
    run_training(loss_fn, params, feed, opt, START, run_seed, start_step=1,
                 **kw)
    change = _leaf_norms((k, t - p) for (k, t), p in zip(
        named_leaves(params), _leaves_of(p0)))
    feed.n, feed.step0 = 0, START    # the chunk count of the last call
    try:
        run_training(loss_fn, params, feed, opt, 1 << 40, run_seed,
                     start_step=START, **kw)
    except WindowClosed:
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
    prog = {"loss": [losses[s] for s in range(START)], "grad": g1,
            "change": change,
            "chunk_loss": [losses[s] for s in range(check.step,
                                                    check.step + chunk)],
            "chunk_change": check.change}
    print(f"[bench] checked chunk: steps {check.step}-"
          f"{check.step + chunk - 1}", file=sys.stderr)
    check.params = check.opt_state = None
    del params, opt_state, graphs, loss_fn, field, tracer, em, crf
    inp.weights = p0                 # the trained leaves go with the state
    common.free_cuda()
    return inp, bank, p0, prog, check.state(p0, dev)


def run(h):
    tr = h.traffic
    inp, bank, p0, prog, state = _drive(h)
    counts: dict = {}
    t0 = time.perf_counter()
    ref = reference(inp, bank, p0, state, h.seed, tr, torch.float32, counts)
    print(f"[bench] reference {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    h.result.roofline({"rays": counts["rays"], "calls": counts["calls"],
                       "faces": len(inp.tris), "slab": counts["slab"],
                       "tri": counts["tri"]})
    for key, label in (("grad", "steps 0-2"), ("chunk_grad", "checked chunk")):
        keep = kept_leaves(ref[key])
        print(f"[bench] first-gradient norms by leaf, {label} (reference; * "
              "left out of the change's gap): " + ", ".join(
                  f"{k} {v:.3e}{'' if k in keep else ' *'}"
                  for k, v in ref[key].items()), file=sys.stderr)
    print("[bench] checked chunk's change by leaf (program / reference): "
          + ", ".join(f"{k} {prog['chunk_change'][k]:.6e} / {v:.6e}"
                      for k, v in ref["chunk_change"].items()),
          file=sys.stderr)
    h.result.numbers(numbers(prog, ref))


def leaf_names(w: dict) -> list:
    return (["material.table"]
            + [f"material.mlp.w.{i}" for i in range(len(w["mlp"]["w"]))]
            + [f"material.mlp.b.{i}" for i in range(len(w["mlp"]["b"]))]
            + ["radiance"])


def _leaves_of(w):
    """The weights in the program's leaf order: material.table, the MLP's
    weights then biases, radiance."""
    return [w["table"]] + list(w["mlp"]["w"]) + list(w["mlp"]["b"]) \
        + [w["radiance"]]


def kept_leaves(ref_grad: dict) -> list:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    med = float(np.median(list(ref_grad.values())))
    return [k for k, v in ref_grad.items() if v >= 1e-3 * med]


def _loss_gap(prog: list, ref: list) -> float:
    """The worst step's |prog - ref| / |ref|; a non-finite loss reads
    infinite."""
    return max((abs(a - b) / abs(b) if math.isfinite(a) else math.inf)
               for a, b in zip(prog, ref))


def numbers(prog: dict, ref: dict) -> dict:
    return {
        "loss_gap": _loss_gap(prog["loss"], ref["loss"]),
        "grad_gap": compare.norm_gaps(prog["grad"], ref["grad"]),
        "change_gap": compare.norm_gaps(prog["change"], ref["change"],
                                        kept_leaves(ref["grad"])),
        "chunk_loss_gap": _loss_gap(prog["chunk_loss"], ref["chunk_loss"]),
        "chunk_change_gap": compare.norm_gaps(
            prog["chunk_change"], ref["chunk_change"],
            kept_leaves(ref["chunk_grad"]))}


def reference(inp, bank: dict, p0: dict, state: dict, seed: int, tr: dict,
              dt, counts: dict | None = None, half_batch: bool = False
              ) -> dict:
    """The reference's readings in `dt`, on its own batches: steps 0-2 from
    the weights p0 with Adam's moments at zero ("loss", "grad", "change"),
    and the checked chunk's steps from `state` ("chunk_loss", "chunk_grad",
    "chunk_change"). counts gains step 0's traversal work. half_batch
    plants a fault: each step's loss is taken over the first half of the
    batch."""
    run_seed = seed % (1 << 62)
    first = state["step"]
    chunk = list(range(first, first + tr["chunk_steps"]))
    rows = gen.batches(bank, tr["batch_size"], seed,
                       list(range(START)) + chunk)
    ref = common.reference_scene(inp, p0, dt)
    a = follow(ref, {"w": p0}, list(range(START)), rows, run_seed, tr,
               inp.device, counts, half_batch)
    b = follow(ref, state, chunk, rows, run_seed, tr, inp.device, None,
               half_batch)
    return dict(a, chunk_loss=b["loss"], chunk_grad=b["grad"],
                chunk_change=b["change"])


def learning_rate(tr: dict, step: int) -> float:
    """The schedule's rate at `step`: the base rate times milestone_rate
    once for every milestone at or before it."""
    passed = sum(int(m) <= step for m in tr["milestones"])
    return tr["learning_rate"] * tr["milestone_rate"] ** passed


def follow(ref, start: dict, steps: list, rows: dict, run_seed: int,
           tr: dict, dev, counts: dict | None = None,
           half_batch: bool = False) -> dict:
    """The reference's Adam steps `steps` (consecutive) from start["w"],
    with the moments start["m"], start["v"] (zero where absent):
    {"loss": each step's, "grad": the first step's gradient norms by leaf,
    "change": each leaf's change norm after the last step}."""
    scene, field, (f0, basis) = ref
    dt = field.dt
    w = gen.clone(start["w"])
    leaves = _leaves_of(w)
    base = [t.clone() for t in leaves]
    for t in leaves:
        t.requires_grad_(True)
    names = leaf_names(w)
    m = [x.clone() for x in start["m"]] if "m" in start else \
        [torch.zeros_like(t) for t in leaves]
    v = [x.clone() for x in start["v"]] if "v" in start else \
        [torch.zeros_like(t) for t in leaves]
    field.mlp = w["mlp"]
    crf_w = w["crf_weight"].to(dt)
    out = {"loss": [], "grad": None, "change": None}
    for i, step in enumerate(steps):
        scene.radiance = w["radiance"].to(dt)
        field.table = w["table"]
        loss, c = _step_loss(scene, field, (f0, basis, crf_w), rows[step],
                             R.step_seed(run_seed, step), tr, dt, dev,
                             half_batch)
        if i == 0 and counts is not None:
            counts.update(c)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out["loss"].append(float(loss.detach()))
        if i == 0:
            out["grad"] = {n: float(torch.linalg.vector_norm(g.float()))
                           for n, g in zip(names, grads)}
        with torch.no_grad():
            t = step + 1
            lr = learning_rate(tr, step)
            for p, g, mi, vi in zip(leaves, grads, m, v):
                mi.mul_(B1).add_(g, alpha=1 - B1)
                vi.mul_(B2).addcmul_(g, g, value=1 - B2)
                p.sub_(lr / (1 - B1 ** t) * mi
                       / (torch.sqrt(vi / (1 - B2 ** t)) + EPS))
    out["change"] = {n: float(torch.linalg.vector_norm(
        (p.detach() - q).float()))
                     for n, p, q in zip(names, leaves, base)}
    return out


def _step_loss(scene, field, crf, batch, seed, tr, dt, dev, half_batch):
    """The initialize loss of one step, drawing what the program draws."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    b = batch["rays"].shape[0]
    spp, rounds = tr["spp"], tr["SPP"] // tr["spp"]
    n = b * spp

    def rand(*shape):
        return torch.rand(shape, generator=g, dtype=torch.float32,
                          device=dev)

    draws = []
    for _ in range(rounds):
        dudv = rand(2, b, spp, 1) * 1.0 + (-0.5)
        draws.append((dudv, rand(n), rand(n, 2), rand(n), rand(n, 2)))
    dudv_a = rand(2, b, 1) * 1.0 + (-0.5)
    levels = field.grid["n_levels"]
    bk = field.grid["bwd_level_sample"]
    stride = levels // bk if 0 < bk < levels else 1
    phase = torch.randint(0, stride, (1,), generator=g, device=dev) \
        if stride > 1 else torch.zeros(1, dtype=torch.int64, device=dev)
    u3 = rand(3, b * levels)

    bt = common.as_device(batch, dev, dt)
    rays = bt["rays"]
    lanes = torch.repeat_interleave(rays, spp, dim=0).repeat(rounds, 1)
    du = torch.cat([d[0][0].reshape(-1, 1) for d in draws]).to(dt)
    dv = torch.cat([d[0][1].reshape(-1, 1) for d in draws]).to(dt)
    dr = tuple(torch.cat([d[i] for d in draws]).to(dt) for i in range(1, 5))
    counts: dict = {}
    frozen = field.detached()
    l_lanes = R.path_single(scene, frozen, lanes, du, dv, dr, counts)
    per_round = l_lanes.reshape(rounds, b, spp, 3).mean(2)
    l = torch.zeros_like(per_round[0])
    for r in range(rounds):
        l = l + per_round[r]
    l = l / rounds
    f0, basis, crf_w = crf
    ldr = R.crf(f0, basis, crf_w, l, bt["exposure"])
    wi = R.jitter(rays, dudv_a[0].to(dt), dudv_a[1].to(dt))
    c1: dict = {}
    pos, _, _, valid = scene.intersect(rays[:, 0:3], wi, c1)
    mat = field(pos, stochastic=(phase, u3.to(dt)))
    rows = slice(0, b // 2) if half_batch else slice(0, b)
    loss_c = torch.mean((ldr[rows] - bt["rgbs"][rows]) ** 2)
    seg = torch.clamp(bt["segmentation"].to(torch.int64), 0,
                      tr["max_segments"] - 1)[rows]
    wv = valid.to(dt)[rows]
    s = torch.zeros((tr["max_segments"], 4), dtype=dt, device=dev)
    s.index_add_(0, seg, torch.cat([bt["int_albedo"][rows] * wv[:, None],
                                    wv[:, None]], 1))
    mean = s[:, :3] / torch.clamp(s[:, 3:], min=1e-8)
    diff = (mat["albedo"][rows] - mean[seg]) ** 2
    loss_a = torch.sum(diff * wv[:, None]) / torch.clamp(torch.sum(wv) * 3,
                                                         min=1.0)
    for k in ("rays", "slab", "tri"):
        counts[k] = counts.get(k, 0) + c1.get(k, 0)
    counts["calls"] = 2 * rounds + 1
    return loss_c + loss_a, counts


def control(h) -> dict:
    """Readings of the check's numbers from one run of the program with a
    window of h.seconds: the program's against the float32 reference
    ("sound"), and, each against the same reference, the reference in
    bfloat16 in the program's place (the control) and the reference with
    half of each batch left out, the mean over the rest (a planted fault).
    A step that leaves the state unchanged reads 1 by construction and is
    not run."""
    tr = h.traffic
    inp, bank, p0, prog, state = _drive(h)
    ref = reference(inp, bank, p0, state, h.seed, tr, torch.float32)
    out = {"sound": numbers(prog, ref)}
    for name, kw in (("bfloat16", dict(dt=torch.bfloat16)),
                     ("half_batch", dict(dt=torch.float32,
                                         half_batch=True))):
        got = reference(inp, bank, p0, state, h.seed, tr, **kw)
        out[name] = numbers(got, ref)
    return out
