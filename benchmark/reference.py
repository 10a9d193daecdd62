"""The plain reference: the IRIS path tracer, the hash-grid field, the EMoR
camera response, the initialize stage's loss and Adam, and the a-trous
denoiser, in plain PyTorch and NumPy. It imports nothing of the program,
and works out again everything the program derives from the benchmark's
inputs: its own BVH (benchmark/bvh.py), the emitter tables, the hash
grid's indices and bfloat16 reads, and the program's random draws.

The draws. The program draws every sample from a torch.Generator on the
card, in an order its integrator fixes: a training step from a generator
seeded (seed * 0x9E3779B97F4A7C15 + step) mod 2^63, a rendered frame from
one seeded with the frame's seed, round after round. The reference makes
the same calls, at the same shapes and in the same order, on a generator of
its own, and keeps the lanes it computes. Every lane of a fixed-shape batch
is computed, as in the program: dead lanes are parked above the scene.

`dt` is the floating-point type the reference computes in: float32, or a
lower one for the control run (benchmark/compare.py).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from benchmark import bvh as B

PI = math.pi
RAY_EPS = 1.788139e-4          # mitsuba's RayEpsilon, 1500 * 2^-23
STEP_SEED_MIX = 0x9E3779B97F4A7C15
PRIMES = (1, 2654435761, 805459861)


def step_seed(seed: int, step: int) -> int:
    return (int(seed) * STEP_SEED_MIX + int(step)) % (1 << 63)


# ------------------------------------------------------------ vector math

def normalize(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def dot(a, b, keep=True):
    return torch.sum(a * b, dim=-1, keepdim=keep)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def frame(n):
    x = torch.zeros_like(n)
    x[..., 0] = 1.0
    y = torch.zeros_like(n)
    y[..., 1] = 1.0
    t = normalize(torch.where(torch.abs(n[..., 0:1]) <= 1e-1, cross(x, n),
                              cross(y, n)))
    return t, cross(n, t)


def to_world(n, v):
    t, b = frame(n)
    return t * v[..., 0:1] + b * v[..., 1:2] + n * v[..., 2:3]


def angle2xyz(theta, phi):
    s = torch.sin(theta)
    return normalize(torch.stack([s * torch.cos(phi), s * torch.sin(phi),
                                  torch.cos(theta)], -1))


# ------------------------------------------------------------------ BRDF

def d_ggx(noh, r):
    a = r * r
    a2 = a * a
    den = noh * noh * (a2 - 1.0) + 1.0
    return a2 / (PI * den * den)


def g1(nov, r):
    k = r + 1.0
    k = k * k / 8.0
    return 1.0 / (nov * (1.0 - k) + k)


def half(wi, wo, n):
    h = normalize(wi + wo)
    return (torch.relu(dot(wi, n)), torch.relu(dot(wo, n)),
            torch.relu(dot(wo, h)), torch.relu(dot(n, h)))


def eval_brdf(wi, wo, n, mat):
    albedo, r, m = mat["albedo"], mat["roughness"], mat["metallic"]
    nol, nov, voh, noh = half(wi, wo, n)
    d = d_ggx(noh, r)
    pdf = 0.5 * (d / (4.0 * torch.clamp(voh, min=1e-4)) * noh) \
        + 0.5 * (nol / PI)
    kd = albedo * (1.0 - m)
    ks = 0.04 * (1.0 - m) + albedo * m
    g = g1(nol, r) * g1(nov, r)
    f = ks + (1.0 - ks) * (1.0 - voh) ** 5
    return kd / PI * nol + d * g * f / 4.0 * nol, pdf


def diffuse_dir(s2, n):
    return to_world(n, angle2xyz(torch.arcsin(torch.sqrt(s2[..., 0])),
                                 2.0 * PI * s2[..., 1]))


def specular_dir(s2, r, wo, n):
    a = (r * r).reshape(r.shape[0])
    c2 = (1.0 - s2[..., 0]) / (s2[..., 0] * (a * a - 1.0) + 1.0)
    wh = to_world(n, angle2xyz(torch.arccos(torch.sqrt(
        torch.clamp(c2, 0.0, 1.0))), 2.0 * PI * s2[..., 1]))
    return normalize(2.0 * dot(wo, wh) * wh - wo)


def sample_brdf(s1, s2, wo, n, mat):
    wi = torch.where((s1 > 0.5)[..., None], diffuse_dir(s2, n),
                     specular_dir(s2, mat["roughness"], wo, n))
    brdf, pdf = eval_brdf(wi, wo, n, mat)
    pos = pdf > 0
    w = torch.where(pos, brdf / torch.where(pos, pdf, 1.0), 0.0)
    return wi, pdf, torch.where(torch.isnan(w), 0.0, w)


def specular_weights(s2, wo, n, r):
    """The two Fresnel-split weights of a GGX sample (the AOV's a')."""
    wi = specular_dir(s2, r, wo, n)
    nol, nov, voh, noh = half(wi, wo, n)
    g = g1(nol, r) * g1(nov, r)
    x = (1.0 - voh) ** 5
    fac = g * voh * nol / torch.clamp(noh, min=1e-4)
    return (1.0 - x) * fac, x * fac


# ----------------------------------------------------------------- scene

class Scene:
    """The reference's scene: its BVH, face normals, emitter tables and
    radiance-cache grid, worked out from the benchmark's raw inputs."""

    def __init__(self, triangles, is_emitter, radiance, slf_radiance,
                 slf_res, slf_bounds, device, dt=torch.float32):
        tris = np.asarray(triangles, np.float32)
        self.dt = dt
        self.bvh = B.build(tris, device)
        if dt != torch.float32:
            for k in ("lo", "hi", "v0", "e1", "e2"):
                setattr(self.bvh, k, getattr(self.bvh, k).to(dt))
        cr = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
        nrm = cr / np.maximum(np.linalg.norm(cr, axis=-1, keepdims=True),
                              1e-20)
        self.normals = torch.as_tensor(nrm.astype(np.float32),
                                       device=device).to(dt)
        em = np.flatnonzero(is_emitter)
        k = len(em)
        eidx = np.full(len(tris), -1, np.int64)
        eidx[em] = np.arange(k)
        verts = tris[em]
        area = np.linalg.norm(np.cross(verts[:, 1] - verts[:, 0],
                                       verts[:, 2] - verts[:, 0]), axis=-1) / 2
        pdf = np.full(k, 1.0 / k, np.float32)
        self.emitter_idx = torch.as_tensor(eidx, device=device)
        self.emitter_tri = torch.as_tensor(em, device=device)
        self.emitter_verts = torch.as_tensor(verts, device=device).to(dt)
        self.pdf_over_area = (torch.as_tensor(pdf, device=device)
                              / torch.clamp(torch.as_tensor(
                                  area.astype(np.float32), device=device),
                                  min=1e-12)).to(dt)
        self.cdf = torch.as_tensor(np.cumsum(pdf), device=device).to(dt)
        self.radiance = radiance
        self.slf = slf_radiance.to(dt)
        self.slf_res = int(slf_res)
        self.slf_lo, self.slf_hi = slf_bounds

    def intersect(self, o, d, counts=None):
        """positions, viewer-facing unit normals, face ids (-1: miss) and
        validity of the closest hits."""
        t, face = B.closest_hit(self.bvh, o, d, counts)
        valid = face >= 0
        n = self.normals[torch.clamp(face, min=0)]
        n = torch.where(dot(n, -d) < 0, -n, n)
        vm = valid[:, None]
        t = t.to(o.dtype)
        return (torch.where(vm, o + t[:, None] * d, 0.0),
                torch.where(vm, n, 0.0), torch.where(valid, face, -1), valid)

    def slf_query(self, x):
        h = self.slf_res
        xn = (x - self.slf_lo) / (self.slf_hi - self.slf_lo)
        xi = torch.clamp(torch.clamp(xn * h, -1.0, float(h)).to(torch.int64),
                         0, h - 1)
        return self.slf[xi[..., 0] + xi[..., 1] * h + xi[..., 2] * h * h]

    def eval_emitter(self, pos, wi, tri, roughness=None, trace_r=0.6):
        vis = tri != -1
        eid = self.emitter_idx[torch.clamp(tri, min=0)]
        is_area = (eid >= 0) & vis
        e = torch.clamp(eid, min=0)
        emit_pdf = torch.where(is_area, self.pdf_over_area[e], 0.0)
        le = torch.where(is_area[:, None], self.radiance[e], 0.0)
        le = le * vis[:, None]
        valid_next = (~is_area) & vis
        if roughness is not None:
            diffuse = (~is_area) & vis & (roughness[..., 0] > trace_r)
            cache = self.slf_query(pos)
            le = le + torch.where(diffuse[:, None], cache, 0.0)
            valid_next = valid_next & ~(diffuse & (torch.sum(cache, -1) > 0))
        return le, emit_pdf[:, None], valid_next

    def sample_emitter(self, s1, s2, pos):
        k = self.cdf.shape[0]
        e = torch.clamp(torch.searchsorted(
            self.cdf, torch.clamp(s1, min=1e-12).contiguous(), right=False),
            0, k - 1)
        xi1 = torch.sqrt(s2[..., 0])
        u = (1.0 - xi1)[:, None]
        v = (xi1 * s2[..., 1])[:, None]
        w = 1.0 - u - v
        p = self.emitter_verts[e]
        point = p[:, 0] * u + p[:, 1] * v + p[:, 2] * w
        return (normalize(point - pos), self.pdf_over_area[e][:, None],
                self.emitter_tri[e])


# ------------------------------------------------------------- hash grid

def grid_levels(grid, device):
    res = np.floor(grid["base_resolution"] * grid["per_level_scale"]
                   ** np.arange(grid["n_levels"])).astype(np.int64)
    t = 1 << grid["log2_table_size"]
    return (torch.as_tensor(res, dtype=torch.float32, device=device),
            torch.as_tensor(res + 1, device=device),
            torch.as_tensor((res + 1) ** 3 <= t, device=device))


def _cells(grid, x, device):
    """Per (query, level), query-major: integer cell, fraction, the
    level's (resolution + 1, dense flag, table offset)."""
    res, res_u, dense = grid_levels(grid, device)
    n_l = grid["n_levels"]
    t = 1 << grid["log2_table_size"]
    b = x.shape[0]
    x = torch.clamp(x, 0.0, 1.0)
    cell, frac = [], []
    for c in range(3):
        p = (x[:, c:c + 1] * res.to(x.dtype)[None, :]).reshape(-1)
        c0 = torch.floor(p)
        cell.append(c0.to(torch.int64))
        frac.append(p - c0)
    lv = torch.arange(n_l, device=device).expand(b, n_l).reshape(-1)
    return cell, frac, res_u[lv], dense[lv], lv * t


def _index(grid, cx, cy, cz, res_u, dense, off):
    t = 1 << grid["log2_table_size"]
    dense_i = cx + res_u * (cy + res_u * cz)
    hashed = (cx * PRIMES[0] ^ cy * PRIMES[1] ^ cz * PRIMES[2]) & (t - 1)
    return torch.clamp(torch.where(dense, dense_i, hashed) + off, 0,
                       grid["n_levels"] * t - 1)


def encode_exact(grid, table, x):
    """The trilinear 8-corner encode: (B, L*F) level-major in row mode,
    (B, F*L) feature-major in the flat modes, whose packed form reads each
    feature as bfloat16."""
    dev = x.device
    cell, frac, res_u, dense, off = _cells(grid, x, dev)
    n_l, nf = grid["n_levels"], grid["n_features"]
    b = x.shape[0]
    block = n_l * (1 << grid["log2_table_size"])
    if grid["row_gather"]:
        src = table
    else:
        flat = table.reshape(nf, block)
        if grid.get("packed_gather") and nf == 2:
            flat = flat.to(torch.bfloat16).to(torch.float32)
        src = flat.t()
    src = src.to(x.dtype)
    acc = torch.zeros((b * n_l, nf), dtype=x.dtype, device=dev)
    for k in range(8):
        kx, ky, kz = (k >> 2) & 1, (k >> 1) & 1, k & 1
        idx = _index(grid, cell[0] + kx, cell[1] + ky, cell[2] + kz, res_u,
                     dense, off)
        w = ((frac[0] if kx else 1.0 - frac[0])
             * (frac[1] if ky else 1.0 - frac[1])
             * (frac[2] if kz else 1.0 - frac[2]))
        acc = acc + src[idx] * w[:, None]
    if grid["row_gather"]:
        return acc.reshape(b, n_l * nf)
    return acc.reshape(b, n_l, nf).permute(0, 2, 1).reshape(b, nf * n_l)


class _OneCorner(torch.autograd.Function):
    """Row-mode one-corner estimator: the forward reads the sampled corner's
    row; the backward sends each query's cotangent, times the level stride,
    to its sampled corner at the one sampled level block, summed in float32
    from bfloat16 cotangents and rounded once to bfloat16 (the
    configuration's scatter type)."""

    @staticmethod
    def forward(ctx, rows, idx, keep, stride):
        ctx.save_for_backward(idx, keep)
        ctx.stride, ctx.shape = stride, rows.shape
        return rows[idx]

    @staticmethod
    def backward(ctx, g):
        idx, keep = ctx.saved_tensors
        gk = (g[keep] * float(ctx.stride)).to(torch.bfloat16).to(g.dtype)
        out = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device)
        out.index_add_(0, idx[keep], gk.float())
        return out.to(torch.bfloat16).to(g.dtype), None, None, None


def encode_stochastic(grid, rows, x, phase, u3):
    """The training encode of row mode: one corner a level, drawn by a
    per-axis Bernoulli of the cell fraction (u3 (3, B*L) the draws), the
    gradient at the level block `phase` of stride L / bwd_level_sample."""
    dev = x.device
    cell, frac, res_u, dense, off = _cells(grid, x, dev)
    n_l = grid["n_levels"]
    b = x.shape[0]
    bits = [(u3[c] < frac[c]).to(torch.int64) for c in range(3)]
    idx = _index(grid, cell[0] + bits[0], cell[1] + bits[1],
                 cell[2] + bits[2], res_u, dense, off)
    bk = grid["bwd_level_sample"]
    stride = n_l // bk if 0 < bk < n_l else 1
    lv = torch.arange(n_l, device=dev).expand(b, n_l).reshape(-1)
    keep = (lv % stride) == phase if stride > 1 else torch.ones_like(
        lv, dtype=torch.bool)
    return _OneCorner.apply(rows, idx, keep, stride).reshape(
        b, n_l * grid["n_features"])


def mlp(params, h, dt):
    """bfloat16 operands and `dt` sums: the configuration's MLP."""
    n = len(params["w"])
    for i in range(n):
        w = params["w"][i]
        h = h.to(torch.bfloat16).to(dt) @ w.to(torch.bfloat16).to(dt) \
            + params["b"][i].to(dt)
        if i < n - 1:
            h = torch.relu(h)
    return h


class Field:
    """The NGP material: hash grid and MLP on positions in the field's box.
    `stochastic` (phase, u3) switches on the training encode."""

    def __init__(self, grid, table, mlp_params, lo, hi, dt):
        self.grid, self.table, self.mlp = grid, table, mlp_params
        self.lo, self.hi, self.dt = lo, hi, dt

    def __call__(self, pos, stochastic=None):
        x = (pos - self.lo) / (self.hi - self.lo)
        if stochastic is None:
            feat = encode_exact(self.grid, self.table, x)
        else:
            feat = encode_stochastic(self.grid, self.table.to(self.dt), x,
                                     *stochastic)
        out = torch.sigmoid(mlp(self.mlp, feat.to(self.dt), self.dt))
        return {"albedo": out[..., 0:3],
                "roughness": out[..., 3:4] * 0.98 + 0.02,
                "metallic": out[..., 4:5]}

    def detached(self):
        return Field(self.grid, self.table.detach(),
                     {k: [t.detach() for t in v] for k, v in self.mlp.items()},
                     self.lo, self.hi, self.dt)


# ------------------------------------------------------------ integrator

def mis(a, b, clamp):
    den = a * a + b * b
    if clamp > 0:
        den = torch.clamp(den, min=clamp)
    w = torch.where((a > 0) & ~torch.isinf(b), a * a / den, 0.0)
    return torch.where(torch.isinf(a) | (b == 0), 1.0, w)


def nee_and_bounce(sc, field, dr, pos, wo, n, mat, active, g_clamp,
                   mis_clamp, trace_r, counts=None):
    """One bounce: the emitter sample and the BRDF sample, traced as one
    2N-ray batch. dr = (s1, s2, s1b, s2b)."""
    s1, s2, s1b, s2b = dr
    m = pos.shape[0]
    wi_e, emit_pdf, emit_tri = sc.sample_emitter(s1, s2, pos)
    wi_b, pdf_b, brdf_w = sample_brdf(s1b, s2b, wo, n, mat)
    o2 = torch.cat([pos + RAY_EPS * wi_e, pos + RAY_EPS * wi_b], 0)
    d2 = torch.cat([wi_e, wi_b], 0)
    act2 = torch.cat([active, active], 0)[:, None]
    o2 = torch.where(act2, o2, 1e7)
    park = torch.zeros(3, dtype=pos.dtype, device=pos.device)
    park[2] = 1.0
    d2 = torch.where(act2, d2, park)
    p2, n2, f2, v2 = sc.intersect(o2, d2, counts)
    e_pos, p_next = p2[:m], p2[m:]
    e_nrm, n_next = n2[:m], n2[m:]
    tri_e, tri_b = f2[:m], f2[m:]
    e_valid = v2[:m]
    vis = (~e_valid) | (emit_tri == tri_e)
    e_w, _, _ = sc.eval_emitter(e_pos, wi_e, tri_e)
    g = torch.abs(dot(-wi_e, e_nrm, False)) / torch.clamp(
        torch.sum((e_pos - pos) ** 2, -1), min=g_clamp)
    g = torch.where(e_valid, g, 1.0)[:, None]
    e_w = e_w * vis[:, None] * g / torch.clamp(emit_pdf, min=g_clamp)
    e_brdf, nee_pdf = eval_brdf(wi_e, wo, n, mat)
    nee = torch.where(active[:, None],
                      e_brdf * e_w * mis(emit_pdf, nee_pdf * g, mis_clamp),
                      0.0)
    if trace_r == 0.0:
        mat_next = None
        le, pdf2, v_next = sc.eval_emitter(
            p_next, wi_b, tri_b,
            torch.ones((m, 1), dtype=pos.dtype, device=pos.device), 0.0)
    else:
        mat_next = field(p_next)
        le, pdf2, v_next = sc.eval_emitter(p_next, wi_b, tri_b,
                                           mat_next["roughness"])
    g2 = torch.abs(dot(-n_next, wi_b, False)) / torch.clamp(
        torch.sum((pos - p_next) ** 2, -1), min=g_clamp)
    g2 = torch.where(v_next, g2, 1.0)
    bounce = torch.where(active[:, None],
                         brdf_w * le * mis(pdf_b * g2[:, None], pdf2, 0.0),
                         0.0)
    return (nee, bounce, p_next, n_next, -wi_b, mat_next, active & v_next,
            brdf_w)


def jitter(rays, du, dv):
    """Jittered camera directions of lanes: rays (N, 12), du/dv (N, 1)."""
    d = normalize(rays[:, 3:6])
    return normalize(d + rays[:, 6:9] * du + rays[:, 9:12] * dv)


def first_hit(sc, field, rays, du, dv, counts=None):
    wi = jitter(rays, du, dv)
    pos, n, tri, _ = sc.intersect(rays[:, 0:3], wi, counts)
    l, _, active = sc.eval_emitter(pos, wi, tri)
    return pos, n, -wi, field(pos), l, active


def path_single(sc, field, rays, du, dv, dr, counts=None):
    """The training forward's lane radiance: emission, one MIS bounce
    ending in the radiance cache."""
    pos, n, wo, mat, l, active = first_hit(sc, field, rays, du, dv, counts)
    nee, bounce, *_ = nee_and_bounce(sc, field, dr, pos, wo, n, mat, active,
                                     1e-6, 1e-6, 0.0, counts)
    return l + nee + bounce


@torch.no_grad()
def path_full(sc, field, rays, du, dv, dr, dr_indirect, counts=None):
    """The render's lane radiance: the first bounce and the indirect tail
    (radiance cache at roughness > 0.6)."""
    pos, n, wo, mat, l, active = first_hit(sc, field, rays, du, dv, counts)
    nee, bounce, pos, n, wo, mat, active, brdf_w = nee_and_bounce(
        sc, field, dr, pos, wo, n, mat, active, 1e-6, 0.0, None, counts)
    l = l + nee + bounce
    tp = torch.ones_like(pos)
    li = torch.zeros_like(pos)
    act = active
    for d in dr_indirect:
        nee_i, bounce_i, pos, n, wo, mat, act, bw = nee_and_bounce(
            sc, field, d, pos, wo, n, mat, act, 1e-12, 0.0, None, counts)
        dl = tp * nee_i
        li = li + torch.where(torch.isnan(dl), 0.0, dl)
        dl = tp * bounce_i
        li = li + torch.where(torch.isnan(dl), 0.0, dl)
        tp = tp * bw
    return l + torch.where(active[:, None], brdf_w * li, 0.0)


@torch.no_grad()
def aovs(sc, field, rays, du, dv, s2, counts=None):
    """kd, a', roughness, metallic, emission and the radiance cache at the
    jittered first hits of lanes."""
    wi = jitter(rays, du, dv)
    pos, n, tri, valid = sc.intersect(rays[:, 0:3], wi, counts)
    mat = field(pos)
    a, m, r = mat["albedo"], mat["metallic"], mat["roughness"]
    kd = a * (1 - m)
    ks = 0.04 * (1 - m) + a * m
    g0, g1_ = specular_weights(s2, -wi, n, r)
    a_prime = g0 * ks + g1_ + kd
    emission = sc.eval_emitter(pos, wi, tri)[0]
    slf = sc.slf_query(pos)
    ok = (valid & (torch.sum(emission, -1) == 0))[:, None]
    return [torch.where(ok, kd, 1.0), torch.where(ok, a_prime, 1.0),
            torch.where(ok, r, 1.0), torch.where(ok, m, 0.0), emission, slf]


# ------------------------------------------------------------------ CRF

def emor(dim: int, root: str = "."):
    """(f0 (1024,), basis (dim, 1024)) of the public EMoR model (Grossberg
    and Nayar 2004): each record of the raw file is a name line and 256
    lines of 4 samples; record 1 is the mean curve, 2.. the basis."""
    path = os.path.join(root, "iris_tpu_torch", "data_files", "emor.txt")
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    vecs = []
    for i in range(2 + dim):
        vecs.append(np.asarray(" ".join(lines[i * 257 + 1:(i + 1) * 257])
                               .split(), dtype=np.float32))
    return vecs[1], np.stack(vecs[2:2 + dim])


def crf(f0, basis, weight, hdr, exposure):
    curves = f0[None] + weight @ basis
    n = curves.shape[-1]
    h = torch.clamp(hdr * exposure, 0.0, 1.0)
    xi = h * (n - 1)
    i0 = torch.clamp(torch.floor(xi).to(torch.int64), 0, n - 2)
    frac = xi - i0.to(xi.dtype)
    out = [curves[c][i0[:, c]] * (1.0 - frac[:, c])
           + curves[c][i0[:, c] + 1] * frac[:, c] for c in range(3)]
    return torch.stack(out, -1)


# ----------------------------------------------------------- denoising

_OFFSETS = [(-2, -2), (-2, 0), (-2, 2), (0, -2), (0, 0), (0, 2), (2, -2),
            (2, 0), (2, 2), (-1, -1), (-1, 1), (1, -1), (1, 1), (-1, 0),
            (1, 0), (0, -1), (0, 1)]


def noise_sigma(img: np.ndarray) -> float:
    """95th percentile of |luminance - its 3x3 median|."""
    from scipy.ndimage import median_filter

    lum = np.asarray(img, np.float32).mean(-1)
    return float(np.quantile(np.abs(lum - median_filter(lum, size=3)), 0.95))


def denoise(img: np.ndarray, albedo: np.ndarray, device, dt=torch.float32,
            passes: int = 3, sigma_albedo: float = 0.15) -> np.ndarray:
    """The a-trous filter with colour and albedo edge stops (wrapping at the
    borders), the colour sigma twice the spike noise, floored at 0.05."""
    sig = max(2.0 * noise_sigma(img), 0.05)
    x = torch.as_tensor(np.asarray(img, np.float32), device=device).to(dt)
    alb = torch.as_tensor(np.asarray(albedo, np.float32),
                          device=device).to(dt)
    den_c = 2.0 * torch.tensor(sig, dtype=dt, device=device) ** 2
    den_a = 2.0 * torch.tensor(sigma_albedo, dtype=dt, device=device) ** 2
    for p in range(passes):
        step = 1 << p
        acc = torch.zeros_like(x)
        wacc = torch.zeros(x.shape[:2] + (1,), dtype=dt, device=device)
        for dy, dx in _OFFSETS:
            k = {0: 3.0 / 8.0, 1: 1.0 / 4.0, 2: 1.0 / 16.0}[max(abs(dy),
                                                              abs(dx))]
            sh = (dy * step, dx * step)
            s = torch.roll(x, sh, dims=(0, 1))
            w = k * torch.exp(-torch.sum((s - x) ** 2, -1, keepdim=True)
                              / den_c)
            w = w * torch.exp(-torch.sum((torch.roll(alb, sh, dims=(0, 1))
                                          - alb) ** 2, -1, keepdim=True)
                              / den_a)
            acc = acc + s * w
            wacc = wacc + w
        x = acc / torch.clamp(wacc, min=1e-8)
    return x.float().cpu().numpy()
