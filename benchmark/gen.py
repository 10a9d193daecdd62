"""Inputs of a run, made from the seed by the benchmark itself and handed to
both the program and the reference: the procedural scene, the views, the
pixel bank with its targets, and the weights.

The scene is the box room with clutter boxes and an emissive ceiling quad
(a frozen copy of the procedural generator both packages ship), fixed for
a configuration: every seed renders and trains on the same geometry. The
views are a fixed set drawn from the traffic's `view_seed`; the run's seed
orders them and draws the weights, the targets and the program's random
streams, so that every seed gives the same work in another order.
"""

from __future__ import annotations

import math

import numpy as np
import torch


# ------------------------------------------------------------------ scene

def _quad(p0, p1, p2, p3):
    return [[p0, p1, p2], [p0, p2, p3]]


def _box(lo, hi):
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    return np.asarray(
        _quad((x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0))
        + _quad((x0, y0, z1), (x0, y1, z1), (x1, y1, z1), (x1, y0, z1))
        + _quad((x0, y0, z0), (x0, y1, z0), (x0, y1, z1), (x0, y0, z1))
        + _quad((x1, y0, z0), (x1, y0, z1), (x1, y1, z1), (x1, y1, z0))
        + _quad((x0, y0, z0), (x0, y0, z1), (x1, y0, z1), (x1, y0, z0))
        + _quad((x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1)),
        dtype=np.float32)


def box_scene(n_clutter: int, seed: int = 0, light_size: float = 0.4):
    """(triangles (F, 3, 3) float32, emitter face mask (F,)): the room
    [0,2]^2 x [0,1], n_clutter boxes, and a two-face emissive quad just
    below the ceiling (the last two faces). 12 + 12 n_clutter + 2 faces."""
    rng = np.random.default_rng(seed)
    tris = [_box((0, 0, 0), (2, 2, 1))]
    for _ in range(n_clutter):
        c = rng.uniform([0.2, 0.2, 0.0], [1.8, 1.8, 0.3])
        s = rng.uniform(0.05, 0.25, size=3)
        tris.append(_box(c, c + s))
    h = light_size / 2
    tris.append(np.asarray(_quad(
        [1.0 - h, 1.0 - h, 0.98], [1.0 - h, 1.0 + h, 0.98],
        [1.0 + h, 1.0 + h, 0.98], [1.0 + h, 1.0 - h, 0.98]), np.float32))
    tris = np.concatenate(tris, 0)
    is_emitter = np.zeros(len(tris), bool)
    is_emitter[-2:] = True
    return tris, is_emitter


# ------------------------------------------------------------------ views

def view_rays(origin, target, hw, fov_deg: float) -> np.ndarray:
    """(H*W, 12) float32 pinhole rays [o, d, dxdu, dydv] through pixel
    centres, row-major; d is not normalised (the integrator normalises)."""
    h, w = hw
    look = np.asarray(target, np.float64) - np.asarray(origin, np.float64)
    look /= np.linalg.norm(look)
    right = np.cross(look, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, look)
    f = 0.5 * w / math.tan(math.radians(fov_deg) / 2)
    i, j = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
    d = ((i - w / 2)[..., None] / f * right + (h / 2 - j)[..., None] / f * up
         + look).reshape(-1, 3)
    n = d.shape[0]
    o = np.broadcast_to(np.asarray(origin, np.float64), (n, 3))
    return np.concatenate(
        [o, d, np.broadcast_to(right / f, (n, 3)),
         np.broadcast_to(up / f, (n, 3))], 1).astype(np.float32)


def views(n_views: int, view_seed: int, hw, fov_deg: float) -> np.ndarray:
    """(n_views, H*W, 12): cameras inside the room above the clutter (which
    reaches z 0.55), each looking at a point in the room's lower half."""
    rng = np.random.default_rng(view_seed)
    out = []
    for _ in range(n_views):
        o = rng.uniform([0.25, 0.25, 0.6], [1.75, 1.75, 0.9])
        t = rng.uniform([0.1, 0.1, 0.0], [1.9, 1.9, 0.6])
        out.append(view_rays(o, t, hw, fov_deg))
    return np.stack(out, 0)


def view_order(n_views: int, seed: int) -> np.ndarray:
    return np.random.default_rng([seed, 1]).permutation(n_views)


def pixel_bank(rays: np.ndarray, hw, max_segments: int, seed: int) -> dict:
    """The training bank over the views (V, H*W, 12), as a capture's
    dataset would hold it: rays, LDR targets, an intrinsic-albedo pseudo
    target, one exposure a view, and segment ids in [0, max_segments) from
    a grid of image blocks."""
    v, n, _ = rays.shape
    h, w = hw
    rng = np.random.default_rng([seed, 2])
    side = int(math.isqrt(max_segments))
    rows, cols = side, max_segments // side
    r, c = np.divmod(np.arange(n), w)
    seg = (r * rows // h) * cols + (c * cols // w)
    exposure = rng.uniform(0.5, 2.0, (v, 1, 1)).astype(np.float32)
    return {
        "rays": rays.reshape(-1, 12),
        "rgbs": rng.uniform(0.0, 1.0, (v * n, 3)).astype(np.float32),
        "int_albedo": rng.uniform(0.05, 0.95, (v * n, 3)).astype(np.float32),
        "exposure": np.broadcast_to(exposure, (v, n, 1)).reshape(-1, 1)
        .astype(np.float32),
        "segmentation": np.tile(seg, v).astype(np.float32),
    }


# ---------------------------------------------------------------- batches

def _spread_bits(x: np.ndarray) -> np.ndarray:
    """21 bits of x moved to every third bit."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    for shift, mask in ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF),
                        (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
                        (2, 0x1249249249249249)):
        x = (x | (x << np.uint64(shift))) & np.uint64(mask)
    return x


def spatial_order(rays: np.ndarray) -> np.ndarray:
    """The order a trainer gives a batch's rows: by the direction's octant,
    then by the origin's Morton code (63 bits over the batch's box, the
    low 15 dropped), stable."""
    o, d = rays[:, 0:3], rays[:, 3:6]
    octant = ((d[:, 0] > 0).astype(np.int64) * 4
              + (d[:, 1] > 0).astype(np.int64) * 2
              + (d[:, 2] > 0).astype(np.int64))
    lo, hi = o.min(0), o.max(0)
    q = np.clip((o - lo) / np.maximum(hi - lo, 1e-9) * (1 << 21), 0,
                (1 << 21) - 1).astype(np.uint64)
    m = (_spread_bits(q[:, 0]) | (_spread_bits(q[:, 1]) << np.uint64(1))
         | (_spread_bits(q[:, 2]) << np.uint64(2))).astype(np.int64)
    return np.argsort(octant * (1 << 48) + (m >> np.int64(15)),
                      kind="stable")


def batches(bank: dict, batch_size: int, seed: int, steps) -> dict:
    """{step: rows} for each of `steps`, by the trainer's batching rule: an
    epoch is one permutation of the bank from numpy's default_rng(seed),
    drawn anew every epoch; a step takes its slice of batch_size rows
    (wrapping to the epoch's start at its tail), ordered by
    spatial_order."""
    n = len(bank["rays"])
    per_epoch = math.ceil(n / batch_size)
    rng = np.random.default_rng(seed)
    idxs, epoch = rng.permutation(n), 0
    out = {}
    for s in sorted(steps):
        while s // per_epoch > epoch:
            idxs, epoch = rng.permutation(n), epoch + 1
        b0 = (s % per_epoch) * batch_size
        sel = idxs[b0:b0 + batch_size]
        if len(sel) < batch_size:
            sel = np.concatenate([sel, idxs[:batch_size - len(sel)]])
        sel = sel[spatial_order(bank["rays"][sel])]
        out[s] = {k: v[sel] for k, v in bank.items()}
    return out


# ---------------------------------------------------------------- weights

def weights(cfg: dict, traffic: dict, n_emitters: int, seed: int, device
            ) -> dict:
    """Every trained or read weight, on `device`, from one card generator
    in a few large calls: the hash table (row mode: (L*T, F); flat: the
    feature-major (F*L*T,)), the MLP, the emitter radiance, the SLF's
    radiance grid and the CRF weights."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    grid = cfg["hash_grid"]
    n = grid["n_levels"] * (1 << grid["log2_table_size"])
    shape = ((n, grid["n_features"]) if grid["row_gather"]
             else (n * grid["n_features"],))
    a = float(traffic["table_range"])
    table = torch.empty(shape, dtype=torch.float32, device=device)
    table.uniform_(-a, a, generator=g)
    sizes = ([grid["n_levels"] * grid["n_features"]]
             + [cfg["mlp"]["width"]] * cfg["mlp"]["hidden_layers"]
             + [cfg["mlp"]["outputs"]])
    mlp = {"w": [], "b": []}
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        bound = (6.0 / fan_in) ** 0.5
        w = torch.empty((fan_in, fan_out), dtype=torch.float32,
                        device=device)
        mlp["w"].append(w.uniform_(-bound, bound, generator=g))
        b = torch.empty(fan_out, dtype=torch.float32, device=device)
        mlp["b"].append(b.uniform_(-0.1, 0.1, generator=g))
    lo, hi = cfg["emitter_radiance"]
    radiance = torch.empty((n_emitters, 3), dtype=torch.float32,
                           device=device).uniform_(lo, hi, generator=g)
    h = cfg["slf"]["resolution"]
    slo, shi = cfg["slf"]["radiance"]
    slf = torch.empty((h ** 3, 3), dtype=torch.float32,
                      device=device).uniform_(slo, shi, generator=g)
    crf = torch.empty((3, cfg["crf"]["dim"]), dtype=torch.float32,
                      device=device).uniform_(-0.05, 0.05, generator=g)
    return {"table": table, "mlp": mlp, "radiance": radiance,
            "slf_radiance": slf, "crf_weight": crf}


def clone(tree):
    """A detached copy of a weights tree (the reference's own)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v) for v in tree]
    return tree
