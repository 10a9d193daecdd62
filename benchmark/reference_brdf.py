"""The plain reference of the `train_brdf_crf` stage (facebookresearch/iris
train_brdf_crf.py:163-314): the packed hash grid's one-corner training
encode, the shading of the baked caches, the EMoR camera response, the
stage's regularizers (diffuse prior, per-part weighted means or the
semantic propagation loss, albedo anchor, CRF terms) and Adam, in plain
PyTorch. It imports nothing of the program; the scene, its BVH, the hash
grid's cells and indices, the MLP and the CRF curves are benchmark/
reference.py's.

The draws. A step draws from a card generator seeded as the program seeds
the step (reference.step_seed), with the program's calls, shapes and
order: the hash grid's level-block phase (randint over the stride), its
corner uniforms (3, B * L), then, in the semantic branch, the partner
uniforms (B, n_pairs).

`dt` is the floating-point type the reference computes in: float32, or a
lower one for the control run. Matrix products never run in TF32.

Departures from the reference repository's train_brdf_crf.py, all the
program's own (iris_tpu_torch/train/steps.py), each kept here so that the
comparison is of the same mathematics:
- the hash grid is read as the configuration reads it: one corner a point
  and level drawn by a per-axis Bernoulli of the cell fraction, the packed
  bfloat16 features of that corner, and the gradient sent to that corner
  at one level block of the stride (times the stride), summed in float32;
  tiny-cuda-nn reads all eight corners;
- the semantic propagation loss draws n_pairs partners a pixel, with
  replacement, among the valid pixels of its segment, where the reference
  repository takes every pair of a segment's sampled pixels;
- the MSE, the diffuse prior and the per-part means are masked to pixels
  whose camera ray hits the mesh;
- segment ids past max_segments - 1 are clamped into the last segment.
"""

from __future__ import annotations

import torch

from benchmark import reference as R
from benchmark.kinds.common import as_device

B1, B2, EPS = 0.9, 0.999, 1e-8


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------- hash grid

class _PackedOneCorner(torch.autograd.Function):
    """The packed one-corner estimator: the forward reads each feature of
    the sampled corner as bfloat16 (the packed words), feature-major; the
    backward sends each query's cotangent, times the level stride, to its
    sampled corner at the kept level block, summed in float32."""

    @staticmethod
    def forward(ctx, table, idx, keep, stride, n_features, dt):
        ctx.save_for_backward(idx, keep)
        ctx.args = (stride, n_features, table.shape[0])
        block = table.shape[0] // n_features
        b_l = idx.shape[0]
        feats = [table[j * block + idx].to(torch.bfloat16).to(dt)
                 for j in range(n_features)]
        # (F, B*L) -> (B, F*L): feature j's levels at [j*L, (j+1)*L)
        n_l = keep.shape[1]
        return torch.stack(feats, 0).reshape(n_features, b_l // n_l, n_l) \
            .permute(1, 0, 2).reshape(b_l // n_l, n_features * n_l)

    @staticmethod
    def backward(ctx, g):
        idx, keep = ctx.saved_tensors
        stride, nf, size = ctx.args
        block = size // nf
        n_l = keep.shape[1]
        b = g.shape[0]
        gf = g.float().reshape(b, nf, n_l).permute(1, 0, 2).reshape(nf, -1)
        k = keep.reshape(-1)
        out = torch.zeros(size, dtype=torch.float32, device=g.device)
        for j in range(nf):
            out.index_add_(0, j * block + idx[k], gf[j][k] * float(stride))
        return out, None, None, None, None, None


def encode_packed(grid: dict, table, x, phase, u3, dt):
    """(B, F*L) features of points x in [0, 1]^3: the packed mode's
    training encode with the draws (phase, u3)."""
    dev = x.device
    cell, frac, res_u, dense, off = R._cells(grid, x, dev)
    n_l = grid["n_levels"]
    bits = [(u3[c] < frac[c]).to(torch.int64) for c in range(3)]
    idx = R._index(grid, cell[0] + bits[0], cell[1] + bits[1],
                   cell[2] + bits[2], res_u, dense, off)
    bk = grid["bwd_level_sample"]
    stride = n_l // bk if 0 < bk < n_l else 1
    lv = torch.arange(n_l, device=dev)
    keep = ((lv % stride) == phase if stride > 1
            else torch.ones(n_l, dtype=torch.bool, device=dev))
    keep = keep.expand(x.shape[0], n_l).contiguous()
    return _PackedOneCorner.apply(table, idx, keep, stride,
                                  grid["n_features"], dt)


def material(field: R.Field, pos, phase, u3) -> dict:
    """albedo, roughness and metallic of the field at pos, trained."""
    dt = field.dt
    x = (pos - field.lo) / (field.hi - field.lo)
    feat = encode_packed(field.grid, field.table, x, phase, u3, dt)
    out = torch.sigmoid(R.mlp(field.mlp, feat, dt))
    return {"albedo": out[:, 0:3], "roughness": out[:, 3:4] * 0.98 + 0.02,
            "metallic": out[:, 4:5]}


# --------------------------------------------------------------- shading

def lerp_specular(spec, r):
    """The (B, R, 3) cached specular shadings at roughness r (B, 1), the
    roughness [0.02, 1] spread over the R levels."""
    n = spec.shape[1]
    t = torch.clamp((r - 0.02) / (1.0 - 0.02) * (n - 1), 0.0, float(n - 1))
    i0 = torch.floor(t).to(torch.int64)[:, 0]
    i1 = torch.ceil(t).to(torch.int64)[:, 0]
    rows = torch.arange(spec.shape[0], device=spec.device)
    f = t - torch.floor(t)
    return spec[rows, i0] * (1.0 - f) + spec[rows, i1] * f


def shade(mat: dict, batch: dict):
    """kd * diffuse + (ks * specular0(r) + specular1(r))."""
    a, r, m = mat["albedo"], mat["roughness"], mat["metallic"]
    kd = a * (1.0 - m)
    ks = 0.04 * (1.0 - m) + a * m
    return kd * batch["diffuse"] + (ks * lerp_specular(batch["specular0"], r)
                                    + lerp_specular(batch["specular1"], r))


# ---------------------------------------------------------------- losses

def wmean(x, w):
    wb = (w[:, None] if x.dim() > 1 else w).expand(x.shape)
    return torch.sum(x * wb) / torch.clamp(torch.sum(wb), min=1.0)


def segment_mean(values, seg, n: int, weights):
    """Each element's weighted mean over its segment: values (B,) or
    (B, C), seg (B,) in [0, n)."""
    v = values if values.dim() > 1 else values[:, None]
    sums = torch.zeros((n, v.shape[1]), dtype=v.dtype, device=v.device)
    sums = sums.index_add(0, seg, v * weights[:, None])
    wsum = torch.zeros(n, dtype=v.dtype, device=v.device).index_add(
        0, seg, weights)
    mean = sums / torch.clamp(wsum, min=1e-8)[:, None]
    return mean[seg] if values.dim() > 1 else mean[seg, 0], mean


def propagation(seg, valid, pos_n, albedo, rough, metal, u, n_segments,
                sigma_albedo, sigma_pos, across: bool = False):
    """The semantic propagation loss: for each pixel, the n_pairs partners
    of u (B, n_pairs) among the valid pixels of its segment in their batch
    order (partner k = floor(u * count) of the segment's members), the
    bilateral weights of albedo and position, the weighted roughness and
    metallic means, the L1 to them, each segment's mean over its valid
    pixels, summed. across=True (a planted fault) draws the partners among
    all valid pixels."""
    key = torch.where(valid, torch.zeros_like(seg) if across else seg,
                      n_segments)
    order = torch.sort(key, stable=True).indices
    size = torch.bincount(key, minlength=n_segments + 1)
    first = torch.cumsum(size, 0) - size
    n = size[key]
    k = torch.minimum((u * n[:, None].to(u.dtype)).to(torch.int64),
                      torch.clamp(n - 1, min=0)[:, None])
    partner = order[first[key][:, None] + k]                  # (B, P)
    d2a = torch.sum((albedo[partner] - albedo[:, None]) ** 2, -1)
    d2p = torch.sum((pos_n[partner] - pos_n[:, None]) ** 2, -1)
    w = torch.exp(-d2a / sigma_albedo ** 2 / 2.0) \
        * torch.exp(-d2p / sigma_pos ** 2 / 2.0)
    den = torch.sum(w, -1) + 1e-4
    mean_r = torch.sum(w * rough[partner], -1) / den
    mean_m = torch.sum(w * metal[partner], -1) / den
    per = torch.abs(mean_r - rough) + torch.abs(mean_m - metal)
    _, seg_mean = segment_mean(per, seg, n_segments, valid.to(per.dtype))
    return torch.sum(seg_mean)


def crf_curves(crf):
    f0, basis, weight = crf
    return f0[None] + weight @ basis


def step_loss(scene, field, crf, batch, seed: int, lc: dict, dt, dev,
              faults: dict | None = None):
    """(loss, loss_seg) of one step on `batch` (host arrays), drawing what
    the program draws. lc: the traffic's loss settings. faults: "half"
    (the loss over the first half of the batch), "across" (partners
    across segments), "n_pairs" (another partner count)."""
    _no_tf32()
    faults = faults or {}
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    bt = as_device(batch, dev, dt)
    b = bt["rays"].shape[0]
    grid = field.grid
    n_l = grid["n_levels"]
    bk = grid["bwd_level_sample"]
    stride = n_l // bk if 0 < bk < n_l else 1
    phase = (torch.randint(0, stride, (1,), generator=g, device=dev)
             if stride > 1 else torch.zeros(1, dtype=torch.int64, device=dev))
    u3 = torch.rand((3, b * n_l), generator=g, dtype=torch.float32,
                    device=dev)
    rays = bt["rays"]
    pos, _, _, valid = scene.intersect(rays[:, 0:3], R.normalize(
        rays[:, 3:6]))
    mat = material(field, pos, phase, u3.to(dt))
    ldr = R.crf(crf[0], crf[1], crf[2], shade(mat, bt), bt["exposure"])

    rows = slice(0, b // 2) if faults.get("half") else slice(0, b)
    a, r, m = (mat[k][rows] for k in ("albedo", "roughness", "metallic"))
    w = valid[rows].to(dt)
    seg = torch.clamp(bt["segmentation"][rows].to(torch.int64), 0,
                      lc["max_segments"] - 1)
    n_s = lc["max_segments"]
    loss_c = torch.sum((ldr[rows] - bt["rgbs"][rows]) ** 2 * w[:, None]) \
        / torch.clamp(torch.sum(w) * 3, min=1.0)
    loss_d = lc["ld"] * (wmean(torch.abs(r - 1.0), w) + wmean(m, w))
    if lc["has_part"]:
        ws = ((1.0 - r[:, 0]).detach() + 1e-4) * w
        mean_m, _ = segment_mean(m[:, 0], seg, n_s, ws)
        mean_r, _ = segment_mean(r[:, 0], seg, n_s, ws)
        loss_seg = lc["lp"] * (wmean(torch.abs(m[:, 0] - mean_m), w)
                               + wmean(torch.abs(r[:, 0] - mean_r), w))
    else:
        u = torch.rand((b, faults.get("n_pairs", lc["n_pairs"])),
                       generator=g, dtype=torch.float32, device=dev)
        lo, hi = field.lo, field.hi
        pos_n = (pos[rows] - lo) / (hi - lo) * 2 - 1
        loss_seg = lc["ls"] * propagation(
            seg, valid[rows], pos_n, a.detach(), r[:, 0], m[:, 0],
            u[rows], n_s, lc["sigma_albedo"], lc["sigma_pos"],
            faults.get("across", False))
    if lc["la"] > 0:
        tgt, _ = segment_mean(bt["int_albedo"][rows], seg, n_s, w)
        scale = (torch.sum(tgt * a) / torch.clamp(torch.sum(tgt * tgt),
                                                  min=1e-12)).detach()
        loss_a = lc["la"] * torch.mean((tgt * scale - a) ** 2)
    else:
        loss_a = 0.0
    curves = crf_curves(crf)
    reg = lc["l_crf_increasing"] * torch.sum(torch.relu(
        -(curves[:, 1:] - curves[:, :-1]))) \
        + lc["l_crf_weight"] * torch.mean(crf[2] ** 2)
    return loss_c + loss_d + loss_seg + loss_a + reg, loss_seg


# ------------------------------------------------------------------ Adam

def leaves_of(w: dict) -> list:
    """The weights in the program's leaf order: material.table, the MLP's
    weights then biases, crf_weight."""
    return ([w["table"]] + list(w["mlp"]["w"]) + list(w["mlp"]["b"])
            + [w["crf_weight"]])


def leaf_names(w: dict) -> list:
    return (["material.table"]
            + [f"material.mlp.w.{i}" for i in range(len(w["mlp"]["w"]))]
            + [f"material.mlp.b.{i}" for i in range(len(w["mlp"]["b"]))]
            + ["crf_weight"])


def follow(scene, field, f0_basis, start: dict, steps: list, rows: dict,
           run_seed: int, lc: dict, lr_at, dev, faults=None) -> dict:
    """Adam steps `steps` (consecutive) from start["w"] with the moments
    start["m"], start["v"] (zero where absent), the rate lr_at(step):
    {"loss": each step's, "grad": the first step's gradient norm by leaf,
    "change": each leaf's change norm after the last step}."""
    dt = field.dt
    w = {"table": start["w"]["table"].detach().clone(),
         "mlp": {k: [t.detach().clone() for t in v]
                 for k, v in start["w"]["mlp"].items()},
         "crf_weight": start["w"]["crf_weight"].detach().clone()}
    leaves = leaves_of(w)
    base = [t.clone() for t in leaves]
    for t in leaves:
        t.requires_grad_(True)
    m = [x.clone() for x in start["m"]] if "m" in start else \
        [torch.zeros_like(t) for t in leaves]
    v = [x.clone() for x in start["v"]] if "v" in start else \
        [torch.zeros_like(t) for t in leaves]
    field.table = w["table"]
    field.mlp = w["mlp"]
    f0, basis = f0_basis
    out = {"loss": [], "seg": [], "grad": None, "change": None}
    for i, step in enumerate(steps):
        crf = (f0, basis, w["crf_weight"].to(dt))
        loss, seg = step_loss(scene, field, crf, rows[step],
                            R.step_seed(run_seed, step), lc, dt, dev, faults)
        grads = torch.autograd.grad(loss, leaves)
        out["loss"].append(float(loss.detach()))
        out["seg"].append(float(seg.detach()))
        if i == 0:
            out["grad"] = {n: float(torch.linalg.vector_norm(gr))
                           for n, gr in zip(leaf_names(w), grads)}
            out["grad_vec"] = [gr.detach().clone() for gr in grads]
        with torch.no_grad():
            t = step + 1
            lr = lr_at(step)
            for p, gr, mi, vi in zip(leaves, grads, m, v):
                mi.mul_(B1).add_(gr, alpha=1 - B1)
                vi.mul_(B2).addcmul_(gr, gr, value=1 - B2)
                p.sub_(lr / (1 - B1 ** t) * mi
                       / (torch.sqrt(vi / (1 - B2 ** t)) + EPS))
    out["change"] = {n: float(torch.linalg.vector_norm(
        (p.detach() - q).float()))
        for n, p, q in zip(leaf_names(w), leaves, base)}
    return out
