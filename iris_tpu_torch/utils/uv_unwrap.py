"""Seam-aware chart-based UV unwrap (xatlas-role replacement; counterpart
of iris_tpu/utils/uv_unwrap.py, numpy, bit for bit).

The reference exports textures through xatlas (chart segmentation +
packing) and nvdiffrast (atlas rasterization) — utils/export.py in the
reference repo. Neither is a dependency of this package; this module
implements the same pipeline natively:

1. charts: BFS region growing over the face-adjacency graph, gated by
   normal similarity (bounds chart curvature so the planar projection
   stays near-isometric);
2. projection: each chart projects onto its area-weighted mean-normal
   plane; faces whose projected winding flips (occluded folds) are split
   out as single-face charts;
3. packing: charts are scaled to a uniform texel density and shelf-packed
   (height-sorted, gutter spacing) into a square atlas;
4. rasterization: per-texel barycentric coordinates against the owning
   triangle give surface points for texture baking, plus an iterative
   gutter dilation mask so bilinear/mip sampling never reads background.

Everything is numpy; the BRDF queries run in PyTorch on the caller's side
(utils/export.py).
"""

from __future__ import annotations

import numpy as np


# ------------------------------------------------------------- charts

def face_adjacency(faces: np.ndarray) -> list[list[int]]:
    """Adjacent faces per face (shared undirected edge)."""
    edges: dict[tuple[int, int], list[int]] = {}
    for fi, (a, b, c) in enumerate(faces):
        for e in ((a, b), (b, c), (c, a)):
            k = (min(e), max(e))
            edges.setdefault(k, []).append(fi)
    adj: list[list[int]] = [[] for _ in range(len(faces))]
    for fs in edges.values():
        for i in fs:
            for j in fs:
                if i != j:
                    adj[i].append(j)
    return adj


def grow_charts(tri: np.ndarray, faces: np.ndarray,
                normal_cos: float = 0.8, max_faces: int = 4096
                ) -> np.ndarray:
    """Chart id per face via normal-gated BFS region growing."""
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    adj = face_adjacency(faces)
    f = len(faces)
    chart = np.full(f, -1, np.int64)
    cid = 0
    for seed in range(f):
        if chart[seed] != -1:
            continue
        chart[seed] = cid
        ref = n[seed]
        queue = [seed]
        count = 1
        while queue and count < max_faces:
            cur = queue.pop()
            for nb in adj[cur]:
                if chart[nb] == -1 and float(n[nb] @ ref) > normal_cos:
                    chart[nb] = cid
                    queue.append(nb)
                    count += 1
                    if count >= max_faces:
                        break
        cid += 1
    return chart


# --------------------------------------------------------- projection

def project_charts(tri: np.ndarray, chart: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Planar per-corner 2-D coords (F, 3, 2) in chart-local units equal to
    world units (near-isometric for low-curvature charts). Faces whose
    projected winding flips are re-assigned to fresh single-face charts.
    Returns (uv_local, chart)."""
    chart = chart.copy()
    uv = np.zeros((len(tri), 3, 2), np.float64)
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    next_cid = int(chart.max()) + 1
    for cid in range(int(chart.max()) + 1):
        idx = np.flatnonzero(chart == cid)
        if len(idx) == 0:
            continue
        n = fn[idx]
        area2 = np.linalg.norm(n, axis=-1)
        mean_n = (n.sum(0))
        norm = np.linalg.norm(mean_n)
        if norm < 1e-12:
            mean_n = n[np.argmax(area2)]
            norm = np.linalg.norm(mean_n) + 1e-12
        mean_n = mean_n / norm
        helper = np.asarray([1.0, 0.0, 0.0]
                            if abs(mean_n[0]) < 0.9 else [0.0, 1.0, 0.0])
        ax_u = np.cross(helper, mean_n)
        ax_u /= np.linalg.norm(ax_u)
        ax_v = np.cross(mean_n, ax_u)
        p = tri[idx]                              # (k, 3, 3)
        uv[idx, :, 0] = p @ ax_u
        uv[idx, :, 1] = p @ ax_v
        # flipped faces (normal against the chart plane) become their own
        # charts — their projection here would overlap front faces
        signs = np.einsum("kj,j->k", n, mean_n)
        for k in np.flatnonzero(signs <= 0):
            chart[idx[k]] = next_cid
            # re-project on its own plane
            own_n = n[k] / max(np.linalg.norm(n[k]), 1e-12)
            h2 = np.asarray([1.0, 0.0, 0.0]
                            if abs(own_n[0]) < 0.9 else [0.0, 1.0, 0.0])
            u2 = np.cross(h2, own_n)
            u2 /= np.linalg.norm(u2)
            v2 = np.cross(own_n, u2)
            uv[idx[k], :, 0] = p[k] @ u2
            uv[idx[k], :, 1] = p[k] @ v2
            next_cid += 1
    return uv, chart


# ------------------------------------------------------------ packing

def pack_charts(uv: np.ndarray, chart: np.ndarray, res: int = 1024,
                gutter: int = 2):
    """Shelf-pack charts into a res x res atlas at uniform texel density.
    Returns uv_atlas (F, 3, 2) in [0,1] (v up), or None if the charts do
    not fit (caller should retry with a larger res)."""
    cids = np.unique(chart)
    boxes = {}
    total_area = 0.0
    for cid in cids:
        idx = np.flatnonzero(chart == cid)
        lo = uv[idx].reshape(-1, 2).min(0)
        hi = uv[idx].reshape(-1, 2).max(0)
        boxes[cid] = (idx, lo, hi - lo)
        total_area += float(np.prod(np.maximum(hi - lo, 1e-9)))
    # texels per world unit: fill ~70% of the atlas with charts
    density = np.sqrt(0.7 * (res - 2 * gutter) ** 2 / max(total_area, 1e-12))
    for _ in range(24):
        order = sorted(cids, key=lambda c: -boxes[c][2][1])
        x = y = gutter
        shelf_h = 0.0
        ok = True
        place = {}
        for cid in order:
            _, lo, size = boxes[cid]
            w = size[0] * density + 2
            h = size[1] * density + 2
            if x + w + gutter > res:
                x = gutter
                y += shelf_h + gutter
                shelf_h = 0.0
            if y + h + gutter > res or w + 2 * gutter > res:
                ok = False
                break
            place[cid] = (x, y)
            x += w + gutter
            shelf_h = max(shelf_h, h)
        if ok:
            out = np.zeros_like(uv)
            for cid in cids:
                idx, lo, _ = boxes[cid]
                px, py = place[cid]
                out[idx] = (uv[idx] - lo) * density + np.asarray(
                    [px + 1, py + 1])
            return out / res
        density *= 0.92
    return None


# ------------------------------------------------------- rasterization

def rasterize_atlas(tri: np.ndarray, uv01: np.ndarray, res: int):
    """Per-texel surface lookup for texture baking.

    Returns (texel_rows, texel_cols, points (N,3), mask (res,res) bool):
    every atlas texel covered by a triangle maps to its 3-D surface point
    via the texel center's barycentric coordinates."""
    uvp = uv01 * res - 0.5                           # texel centers
    rows, cols, pts = [], [], []
    mask = np.zeros((res, res), bool)
    for fi in range(len(tri)):
        (ax, ay), (bx, by), (cx, cy) = uvp[fi]
        x0 = max(int(np.floor(min(ax, bx, cx))), 0)
        x1 = min(int(np.ceil(max(ax, bx, cx))) + 1, res)
        y0 = max(int(np.floor(min(ay, by, cy))), 0)
        y1 = min(int(np.ceil(max(ay, by, cy))) + 1, res)
        if x0 >= x1 or y0 >= y1:
            continue
        gx, gy = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1),
                             indexing="xy")
        det = (bx - ax) * (cy - ay) - (cx - ax) * (by - ay)
        if abs(det) < 1e-12:
            continue
        w1 = ((gx - ax) * (cy - ay) - (gy - ay) * (cx - ax)) / det
        w2 = ((gy - ay) * (bx - ax) - (gx - ax) * (by - ay)) / det
        w0 = 1.0 - w1 - w2
        inside = (w0 >= -0.02) & (w1 >= -0.02) & (w2 >= -0.02)
        if not inside.any():
            continue
        r = gy[inside]
        c = gx[inside]
        p = (w0[inside, None] * tri[fi, 0] + w1[inside, None] * tri[fi, 1]
             + w2[inside, None] * tri[fi, 2])
        rows.append(r)
        cols.append(c)
        pts.append(p)
        mask[r, c] = True
    if not rows:
        return (np.zeros(0, int), np.zeros(0, int),
                np.zeros((0, 3), np.float32), mask)
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(pts).astype(np.float32), mask)


def dilate_texture(tex: np.ndarray, mask: np.ndarray, iters: int = 4
                   ) -> np.ndarray:
    """Flood valid texels outward (gutter fill) so bilinear/mip sampling
    at chart borders never mixes in background zeros."""
    tex = tex.copy()
    m = mask.copy()
    for _ in range(iters):
        acc = np.zeros_like(tex)
        cnt = np.zeros(m.shape, np.float32)
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            sm = np.roll(m, (dy, dx), (0, 1))
            st = np.roll(tex, (dy, dx), (0, 1))
            acc += st * sm[..., None]
            cnt += sm
        new = (~m) & (cnt > 0)
        tex[new] = acc[new] / cnt[new, None]
        m = m | new
    return tex


def unwrap(mesh, res: int = 1024, normal_cos: float = 0.8,
           max_res: int = 8192):
    """Full pipeline: mesh -> (uv01 (F,3,2), chart (F,), res_used).
    When the charts cannot pack at `res` (gutter-dominated small charts),
    the atlas resolution doubles up to max_res; uv stays in [0,1] for the
    RETURNED resolution."""
    tri = np.asarray(mesh.triangles(), np.float64)
    chart = grow_charts(tri, np.asarray(mesh.faces), normal_cos)
    uv_local, chart = project_charts(tri, chart)
    r = res
    while r <= max_res:
        uv01 = pack_charts(uv_local, chart, r)
        if uv01 is not None:
            return uv01, chart, r
        r *= 2
    raise ValueError(
        f"charts do not fit even a {max_res}x{max_res} atlas")
