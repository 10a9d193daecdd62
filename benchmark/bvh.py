"""The benchmark's own closest-hit: a frozen BVH builder and a frozen
per-ray walk over it, independent of the program's trees, layouts and
kernels.

The reference finds every hit with it, and the traversal roofline counts
its tests: whatever tree or kernel the program uses, the same rays over the
same triangles give the same count here.

- Builder: binned surface-area-heuristic splits (BINS bins of the
  centroid bounds on each axis), level by level, down to leaves of at most
  LEAF_SIZE faces; a node whose faces all fall in one bin is split at the
  centroid median of its longest axis.
- Walk: front to back with a stack a ray; a popped node whose entry
  distance lies beyond the best hit is dropped untested. One slab test
  (SLAB_OPS floating-point operations) for the root and for each child of
  a visited inner node, one Moller-Trumbore test (TRI_OPS) for each face of
  a visited leaf. The triangle test keeps the strict t < best rule, in slot
  order, and the operation order of the usual float32 formulation. Each
  step advances every walking ray by one node under masks, and the rays
  that are done are dropped every few steps, so that the host waits on the
  card only then.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

LEAF_SIZE = 4
BINS = 16
SLAB_OPS = 24
TRI_OPS = 55
T_MISS = 3e37
_DET_EPS = 1e-9
_STACK = 64
_COMPACT = 4


@dataclass
class BVH:
    lo: torch.Tensor       # (N, 3) node boxes
    hi: torch.Tensor
    left: torch.Tensor     # (N,) int64 child ids, -1 at a leaf
    right: torch.Tensor
    start: torch.Tensor    # (N,) first face slot of a leaf
    count: torch.Tensor    # (N,) faces of a leaf, 0 inside
    v0: torch.Tensor       # (F, 3) faces in slot order
    e1: torch.Tensor
    e2: torch.Tensor
    face: torch.Tensor     # (F,) int64 original face id of each slot
    n_faces: int


def _area(lo, hi):
    e = np.maximum(hi - lo, 0.0)
    return 2.0 * (e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2]
                  + e[..., 2] * e[..., 0])


def _split_level(cent, t_lo, t_hi, order, s, k):
    """Reorder each segment [s, s+k) of `order` so that its left child is
    its first part; returns the left sizes."""
    n_seg = len(s)
    seg = np.repeat(np.arange(n_seg), k)
    first = np.cumsum(k) - k
    pos = np.repeat(s, k) + (np.arange(k.sum()) - np.repeat(first, k))
    idx = order[pos]
    c = cent[idx]
    c_lo = np.minimum.reduceat(c, first, axis=0)
    c_hi = np.maximum.reduceat(c, first, axis=0)
    ext = c_hi - c_lo
    b = np.clip(((c - c_lo[seg]) / np.maximum(ext[seg], 1e-30) * BINS)
                .astype(np.int64), 0, BINS - 1)
    best_cost = np.full(n_seg, np.inf)
    best_axis = np.zeros(n_seg, np.int64)
    best_bin = np.zeros(n_seg, np.int64)
    best_left = np.zeros(n_seg, np.int64)
    for ax in range(3):
        key = seg * BINS + b[:, ax]
        o = np.argsort(key, kind="stable")
        ks = key[o]
        cnt = np.bincount(ks, minlength=n_seg * BINS).reshape(n_seg, BINS)
        lo = np.full((n_seg * BINS, 3), np.inf, np.float32)
        hi = np.full((n_seg * BINS, 3), -np.inf, np.float32)
        u, st = np.unique(ks, return_index=True)
        lo[u] = np.minimum.reduceat(t_lo[idx[o]], st, axis=0)
        hi[u] = np.maximum.reduceat(t_hi[idx[o]], st, axis=0)
        lo, hi = lo.reshape(n_seg, BINS, 3), hi.reshape(n_seg, BINS, 3)
        l_lo = np.minimum.accumulate(lo, 1)
        l_hi = np.maximum.accumulate(hi, 1)
        r_lo = np.minimum.accumulate(lo[:, ::-1], 1)[:, ::-1]
        r_hi = np.maximum.accumulate(hi[:, ::-1], 1)[:, ::-1]
        n_l = np.cumsum(cnt, 1)
        n_r = k[:, None] - n_l
        with np.errstate(invalid="ignore"):
            cost = (_area(l_lo[:, :-1], l_hi[:, :-1]) * n_l[:, :-1]
                    + _area(r_lo[:, 1:], r_hi[:, 1:]) * n_r[:, :-1])
        cost = np.where((n_l[:, :-1] > 0) & (n_r[:, :-1] > 0)
                        & (ext[:, ax:ax + 1] > 0), cost, np.inf)
        j = np.argmin(cost, 1)
        cj = cost[np.arange(n_seg), j]
        better = cj < best_cost
        best_cost = np.where(better, cj, best_cost)
        best_axis = np.where(better, ax, best_axis)
        best_bin = np.where(better, j, best_bin)
        best_left = np.where(better, n_l[np.arange(n_seg), j], best_left)
    sah = np.isfinite(best_cost)
    longest = np.argmax(ext, 1)
    axis = np.where(sah, best_axis, longest)
    side = (b[np.arange(len(pos)), axis[seg]] > best_bin[seg]) & sah[seg]
    along = c[np.arange(len(pos)), axis[seg]]
    order[pos] = idx[np.lexsort((along, side, seg))]
    return np.where(sah, best_left, k // 2)


def build(triangles: np.ndarray, device, leaf_size: int = LEAF_SIZE) -> BVH:
    tris = np.asarray(triangles, np.float32)
    n = len(tris)
    cent = tris.mean(1)
    t_lo, t_hi = tris.min(1), tris.max(1)
    order = np.arange(n)
    starts, counts, left, right = [0], [n], [-1], [-1]
    level = [0]
    while level:
        split = [i for i in level if counts[i] > leaf_size]
        if not split:
            break
        s = np.asarray([starts[i] for i in split])
        k = np.asarray([counts[i] for i in split])
        n_left = _split_level(cent, t_lo, t_hi, order, s, k)
        level = []
        for i, a, m, h in zip(split, s, k, n_left):
            for st, ct in ((a, h), (a + h, m - h)):
                starts.append(int(st))
                counts.append(int(ct))
                left.append(-1)
                right.append(-1)
                level.append(len(starts) - 1)
            left[i], right[i] = len(starts) - 2, len(starts) - 1
    starts, counts = np.asarray(starts), np.asarray(counts)
    left, right = np.asarray(left), np.asarray(right)
    depth = np.zeros(len(starts), np.int64)
    for i in range(len(starts)):             # parents come first
        if left[i] >= 0:
            depth[left[i]] = depth[right[i]] = depth[i] + 1
    if depth.max() >= _STACK - 1:
        raise ValueError(f"tree depth {depth.max()} over the walk's stack")
    leaf = left < 0
    s_lo, s_hi = t_lo[order], t_hi[order]
    lo = np.zeros((len(starts), 3), np.float32)
    hi = np.zeros((len(starts), 3), np.float32)
    for i in range(len(starts) - 1, -1, -1):     # children come later
        if leaf[i]:
            sl = slice(starts[i], starts[i] + counts[i])
            lo[i], hi[i] = s_lo[sl].min(0), s_hi[sl].max(0)
        else:
            lo[i] = np.minimum(lo[left[i]], lo[right[i]])
            hi[i] = np.maximum(hi[left[i]], hi[right[i]])
    t = tris[order]

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return BVH(lo=dev(lo), hi=dev(hi), left=dev(left, torch.int64),
               right=dev(right, torch.int64), start=dev(starts, torch.int64),
               count=dev(np.where(leaf, counts, 0), torch.int64),
               v0=dev(t[:, 0]), e1=dev(t[:, 1] - t[:, 0]),
               e2=dev(t[:, 2] - t[:, 0]), face=dev(order, torch.int64),
               n_faces=n)


def _slab(o, inv, lo, hi, t_best):
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tn, tf = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tlo = torch.maximum(torch.maximum(tn[..., 0], tn[..., 1]), tn[..., 2])
    thi = torch.minimum(torch.minimum(tf[..., 0], tf[..., 1]), tf[..., 2])
    return (thi >= torch.clamp(tlo, min=0.0)) & (tlo <= t_best), tlo


def _tri(bvh, slot, o, d, t_best):
    v0, e1, e2 = bvh.v0[slot], bvh.e1[slot], bvh.e2[slot]
    px = d[..., 1] * e2[..., 2] - d[..., 2] * e2[..., 1]
    py = d[..., 2] * e2[..., 0] - d[..., 0] * e2[..., 2]
    pz = d[..., 0] * e2[..., 1] - d[..., 1] * e2[..., 0]
    det = e1[..., 0] * px + e1[..., 1] * py + e1[..., 2] * pz
    ok_det = torch.abs(det) > _DET_EPS
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    tx = o[..., 0] - v0[..., 0]
    ty = o[..., 1] - v0[..., 1]
    tz = o[..., 2] - v0[..., 2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1[..., 2] - tz * e1[..., 1]
    qy = tz * e1[..., 0] - tx * e1[..., 2]
    qz = tx * e1[..., 1] - ty * e1[..., 0]
    v = (d[..., 0] * qx + d[..., 1] * qy + d[..., 2] * qz) * inv_det
    t = (e2[..., 0] * qx + e2[..., 1] * qy + e2[..., 2] * qz) * inv_det
    ok = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
          & (t < t_best))
    return ok, t


def closest_hit(bvh: BVH, o: torch.Tensor, d: torch.Tensor,
                counts: dict | None = None):
    """(t, face) of the closest hit of each ray, face -1 and t T_MISS for a
    miss. counts, when given, gains this call's "rays", "slab" and "tri"
    tests."""
    r_all = o.shape[0]
    dev = o.device
    o = o.float().contiguous()
    d = d.float().contiguous()
    inv = 1.0 / torch.where(torch.abs(d) < 1e-12, 1e-12, d)
    t_best = torch.full((r_all,), T_MISS, dtype=torch.float32, device=dev)
    face = torch.full((r_all,), -1, dtype=torch.int64, device=dev)
    stack = torch.zeros((r_all, _STACK), dtype=torch.int64, device=dev)
    enter = torch.zeros((r_all, _STACK), dtype=torch.float32, device=dev)
    hit, tlo = _slab(o, inv, bvh.lo[0], bvh.hi[0], t_best)
    enter[:, 0] = tlo
    sp = hit.to(torch.int64)
    n_slab = torch.zeros((), dtype=torch.int64, device=dev)
    n_tri = torch.zeros((), dtype=torch.int64, device=dev)
    k4 = torch.arange(LEAF_SIZE, device=dev)
    alive = torch.nonzero(sp > 0)[:, 0]
    step = 0
    while alive.numel():
        a = alive
        spa = sp[a]
        work = spa > 0
        top = torch.clamp(spa - 1, min=0)
        node = stack[a, top]
        tb = t_best[a]
        go = work & (enter[a, top] <= tb)
        sp[a] = top
        inner = bvh.left[node] >= 0
        is_leaf = go & ~inner
        is_in = go & inner
        oa, da = o[a], d[a]
        # leaves: every slot of the popped leaf, in slot order
        slot = torch.clamp(bvh.start[node][:, None] + k4, max=bvh.n_faces - 1)
        used = is_leaf[:, None] & (k4 < bvh.count[node][:, None])
        ok, t = _tri(bvh, slot, oa[:, None], da[:, None], tb[:, None])
        ok = ok & used
        t_min, k_min = torch.where(ok, t, T_MISS).min(1)
        upd = t_min < tb
        tb = torch.where(upd, t_min, tb)
        t_best[a] = tb
        face[a] = torch.where(upd, bvh.face[slot.gather(1, k_min[:, None])
                                            [:, 0]], face[a])
        n_tri += used.sum()
        # inner nodes: both children, the nearer pushed last
        lc = torch.clamp(bvh.left[node], min=0)
        rc = torch.clamp(bvh.right[node], min=0)
        ia = inv[a]
        ha, ta = _slab(oa, ia, bvh.lo[lc], bvh.hi[lc], tb)
        hb, tb2 = _slab(oa, ia, bvh.lo[rc], bvh.hi[rc], tb)
        ha, hb = ha & is_in, hb & is_in
        n_slab += 2 * is_in.sum()
        a_near = ta <= tb2
        for child, h, te in (
                (torch.where(a_near, rc, lc), torch.where(a_near, hb, ha),
                 torch.where(a_near, tb2, ta)),
                (torch.where(a_near, lc, rc), torch.where(a_near, ha, hb),
                 torch.where(a_near, ta, tb2))):
            spa = sp[a]
            at = torch.clamp(spa, max=_STACK - 1)
            stack[a, at] = torch.where(h, child, stack[a, at])
            enter[a, at] = torch.where(h, te, enter[a, at])
            sp[a] = spa + h.to(torch.int64)
        step += 1
        if step % _COMPACT == 0:
            alive = a[sp[a] > 0]
    if counts is not None:
        counts["rays"] = counts.get("rays", 0) + r_all
        counts["slab"] = counts.get("slab", 0) + r_all + int(n_slab)
        counts["tri"] = counts.get("tri", 0) + int(n_tri)
    return t_best, face
