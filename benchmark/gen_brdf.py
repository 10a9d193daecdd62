"""The `train_brdf_crf` stage's inputs beyond gen.py's, made from the seed
by the benchmark itself: the baked shading columns a pixel carries
(diffuse, and specular0/1 at R roughness levels) and, for the semantic
traffic, a room's semantic labels.

The labels are a function of the point where a pixel's ray leaves the
room's box: the ceiling and each wall one label, the floor cut into the
other labels by a treemap whose areas fall off as a power of their rank.
So a label is one region of the room, the same in every view, and a few
labels (the largest floor region, the walls) cover most of a frame, as
the walls, floor and ceiling of a captured room's semantic map do. The
treemap and the ids' order are fixed by the traffic's `label_seed`, so
every seed of a cell trains on the same segments.
"""

from __future__ import annotations

import numpy as np

from benchmark import gen

ROOM = (np.zeros(3), np.array([2.0, 2.0, 1.0]))   # gen.box_scene's room
RASTER = 1024                                     # floor cells a side


def _uniform(rng, lo, hi, shape) -> np.ndarray:
    return rng.random(shape, dtype=np.float32) * np.float32(hi - lo) \
        + np.float32(lo)


def shading_columns(n: int, levels: int, ranges: dict, seed: int) -> dict:
    """(n, 3) diffuse and (n, levels, 3) specular0/1 shadings, each uniform
    in its range of `ranges`."""
    rng = np.random.default_rng([seed, 3])
    return {"diffuse": _uniform(rng, *ranges["diffuse"], (n, 3)),
            "specular0": _uniform(rng, *ranges["specular0"], (n, levels, 3)),
            "specular1": _uniform(rng, *ranges["specular1"], (n, levels, 3))}


def _treemap(shares, x0, y0, x1, y1, out: list) -> None:
    """Cut the rectangle into one rectangle a share, in proportion: the
    shares split into two runs of near-equal sums, the rectangle along its
    longer side."""
    if len(shares) == 1:
        out.append((shares[0][0], x0, y0, x1, y1))
        return
    total = sum(s for _, s in shares)
    acc, k = 0.0, 0
    while k < len(shares) - 1 and acc + shares[k][1] <= total / 2:
        acc += shares[k][1]
        k += 1
    k = max(k, 1)
    f = sum(s for _, s in shares[:k]) / total
    if x1 - x0 >= y1 - y0:
        xm = x0 + (x1 - x0) * f
        _treemap(shares[:k], x0, y0, xm, y1, out)
        _treemap(shares[k:], xm, y0, x1, y1, out)
    else:
        ym = y0 + (y1 - y0) * f
        _treemap(shares[:k], x0, y0, x1, ym, out)
        _treemap(shares[k:], x0, ym, x1, y1, out)


def floor_raster(n_regions: int, alpha: float) -> np.ndarray:
    """(RASTER, RASTER) region ranks over the floor [0, 2]^2 (row y, column
    x): rank k's area is proportional to (k + 1)^-alpha."""
    shares = [(k, (k + 1.0) ** -alpha) for k in range(n_regions)]
    rects: list = []
    _treemap(shares, 0.0, 0.0, 1.0, 1.0, rects)
    raster = np.zeros((RASTER, RASTER), np.int64)
    for k, x0, y0, x1, y1 in rects:
        c0, c1 = round(x0 * RASTER), round(x1 * RASTER)
        r0, r1 = round(y0 * RASTER), round(y1 * RASTER)
        raster[r0:r1, c0:c1] = k
    return raster


def room_labels(rays: np.ndarray, n_labels: int, alpha: float,
                label_seed: int) -> np.ndarray:
    """(N,) float32 label ids in [0, n_labels) of rays (N, 12) whose origins
    lie inside the room: the ceiling and the four walls take five labels,
    the floor's treemap regions the other n_labels - 5; which id goes to
    which region is a permutation drawn from label_seed."""
    o, d = rays[:, 0:3].astype(np.float64), rays[:, 3:6].astype(np.float64)
    lo, hi = ROOM
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(d > 0, (hi - o) / d, np.where(d < 0, (lo - o) / d,
                                                   np.inf))
    axis = np.argmin(t, 1)
    up = d[np.arange(len(d)), axis] > 0
    p = o + np.min(t, 1)[:, None] * d
    # ranks: floor regions 0.. in area order, then the walls and ceiling
    n_floor = n_labels - 5
    raster = floor_raster(n_floor, alpha)
    q = np.clip((p[:, 0:2] / 2.0 * RASTER).astype(np.int64), 0, RASTER - 1)
    rank = raster[q[:, 1], q[:, 0]]
    rank = np.where(axis == 0, n_floor + up, rank)          # x walls
    rank = np.where(axis == 1, n_floor + 2 + up, rank)      # y walls
    rank = np.where((axis == 2) & up, n_floor + 4, rank)    # ceiling
    ids = np.random.default_rng([label_seed, 5]).permutation(n_labels)
    return ids[rank].astype(np.float32)


def pixel_bank(rays: np.ndarray, hw, traffic: dict, seed: int) -> dict:
    """gen.pixel_bank's columns (its block-grid segments for the part
    traffic, the room's labels for the semantic one) with the shading
    columns the stage reads."""
    bank = gen.pixel_bank(rays, hw, traffic["max_segments"], seed)
    lab = traffic["labels"]
    if lab["kind"] == "room":
        bank["segmentation"] = room_labels(
            bank["rays"], traffic["max_segments"], lab["alpha"],
            lab["label_seed"])
    bank.update(shading_columns(len(bank["rays"]),
                                traffic["specular_levels"],
                                traffic["shading"], seed))
    return bank
