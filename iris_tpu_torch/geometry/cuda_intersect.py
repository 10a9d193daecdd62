"""Closest-hit BVH traversal on Hopper: the four CUDA kernels of
csrc/traverse.cu, their wrappers, and one plain PyTorch version beside each
(counterpart of iris_tpu/geometry/pallas_intersect.py).

Every traversal returns, per ray, the closest hit (t, u, v, face) with
face = -1 for a miss: t/u/v float32, face int32.

Dispatch. On the TPU, ray_intersect (intersect.py:471) picks one of seven
Pallas kernels by tree size, layout and VMEM gates (_pallas_mode :383).
The port's dispatch (geometry/intersect.py) keeps the JAX package's split
points, so each scene runs the counterpart of the kernel it runs there:

==============================  ==========================  =====================
tree (JAX package)              TPU kernel                  this port
==============================  ==========================  =====================
< 5K faces (flagship 398)       #1 pallas_ray_trace         trace_union
heap (Morton) layout            #1 pallas_ray_trace         trace_union
>= 5K faces, paired <= 10 MB    #4 pallas_ray_trace_paired  trace_paired
>= 5K faces, past the gate      #5 ..._paired_streamed      trace_paired_streamed
  (the 102K-face scene)
>= 5K faces, leaf row > 128     #3 ..._ordered              trace_ordered
  floats (leaf_size > 10)       (#2 ..._streamed when big)  trace_ordered
opt-in flags                    #6 ..._dense, #7 ..._dense_streamed
==============================  ==========================  =====================

PAIRED_RESIDENT_BYTES is the one split constant: the JAX package's 10 MB
paired-layout gate (paired_vmem_bytes, pallas_intersect.py:1530-1545). The
card has no such memory gate (a 32 MB paired layout sits in the 50 MB L2),
so the split is kept for parity of paths, not out of need; chip_smoke.py
times both paired kernels on the 102K-face inputs so it can be moved on
evidence. trace_ordered also takes the wide-leaf trees that #2 streams on
the TPU, until #2 is ported; #2, #6 and #7 are still to be ported (see
ROADMAP.md). The n_rays < 8192 XLA escape (intersect.py:395) does not
carry over: on the card every call launches a kernel.

A CUDA tensor launches the kernel, or raises: nothing catches a build or
launch error to fall back, and no environment switch swaps kernels. A CPU
tensor takes the plain version, which walks the same arrays in the same
visiting order. Each wrapper counts its launches in a plain integer
attribute (trace_union.launches, trace_paired.launches,
trace_paired_streamed.launches, trace_ordered.launches).

The kernels are built at first use with nvcc for sm_90a into
iris_tpu_torch/build/ (plain C ABI, loaded with ctypes).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import torch

from iris_tpu_torch.geometry.bvh import Tracer
from iris_tpu_torch.native_build import build_shared

T_MISS = 3e37
_MT_EPS = 1e-9

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "csrc", "traverse.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]

# FP32 operations per test, counted from the arithmetic of _slab/_mt_fold
# (and of slab()/mt_fold() in traverse.cu); used for roofline bounds.
SLAB_FLOPS = 24
MT_FLOPS = 55

# The JAX package keeps the paired layout resident up to this many bytes
# (paired_vmem_bytes <= 10 MB, pallas_intersect.py:1530-1545) and streams it
# above; the port splits trace_paired / trace_paired_streamed at the same
# size.
PAIRED_RESIDENT_BYTES = 10 << 20

# The packet walk: rays per shared cursor (one warp), and the rows per
# shared-memory window (64-byte compact pair rows; whole leaf rows of
# leaf_size x 48 bytes). The kernel's own constants are kPairWin and
# kLeafWin in traverse.cu; these only count reloads in the plain version.
PACKET = 32
PAIR_WIN = 32
LEAF_WIN = 8

_LOCK = threading.Lock()
_LIB = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the traversal kernels cannot "
                           "be built (set CUDA_HOME or put nvcc on PATH)")
    return path


def build() -> tuple[str, str]:
    """Compile csrc/traverse.cu if needed: (library path, nvcc output,
    which holds ptxas' register and spill report)."""
    return build_shared([_nvcc()] + NVCC_FLAGS, SOURCE, "libtraverse.so")


def get_lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build()[0])
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.iris_paired_stack_cap.restype = i32
            lib.iris_paired_stack_cap.argtypes = []
            lib.iris_trace_union.restype = i32
            lib.iris_trace_union.argtypes = [
                vp, i32, vp, i32, i32, vp, vp, i32, vp, vp, vp, vp, vp]
            lib.iris_trace_paired.restype = i32
            lib.iris_trace_paired.argtypes = [
                vp, i32, vp, i32, i32, i32, vp, vp, i32, vp, vp, vp, vp, vp]
            lib.iris_trace_ordered.restype = i32
            lib.iris_trace_ordered.argtypes = [
                vp, i32, vp, i32, i32, i32, vp, vp, i32, vp, vp, vp, vp, vp]
            lib.iris_trace_paired_streamed.restype = i32
            lib.iris_trace_paired_streamed.argtypes = [
                vp, i32, vp, i32, i32, i32, vp, vp, i32, vp, vp, vp, vp, vp]
            _LIB = lib
        return _LIB


# ----------------------------------------------------------- host helpers

def auto_stack_depth(tracer: Tracer) -> int:
    """Stack size of the near-first walk (pallas_intersect.py:554-574).

    Occupancy is bounded by depth + 1 (each pop pushes at most far+near
    and the near entry is popped next), so depth + 4 makes the overflow
    clamp unreachable; depth == 0 (unknown) keeps 64."""
    if not tracer.depth:
        return 64
    d = max(64, tracer.depth + 4)
    if d > 32768:
        raise ValueError(
            f"degenerate BVH (depth {tracer.depth}): traversal stack would "
            f"need {d} entries; rebuild with a saner leaf_size/split")
    return d


def _pair_rows(tracer: Tracer):
    """The 16 useful floats of every pair row, (n_pairs, 16), with
    n_pairs and n_leaf_rows (pallas_intersect.py _pack_paired :621, same
    values bit for bit).

    Row r holds both children of internal node r (its preorder rank among
    internal nodes): lanes 0-5 left min/max, 6 its desc', 8-13 right
    min/max, 14 its desc'. desc' > 0: internal child, pair row desc'-1;
    desc' <= 0: leaf child, leaf row -desc'."""
    if tracer.layout != "preorder":
        raise ValueError("the paired layout needs a preorder (SAH) tree")
    if tracer.leaf_size * 12 > 128:
        raise ValueError("leaf row exceeds one 128-float row")
    if tracer.n_nodes <= 1:
        raise ValueError("the paired layout needs an internal root")
    nodes = tracer.nodes
    n = tracer.n_nodes
    L = tracer.leaf_size
    n_leaf_rows = tracer.tris.shape[0] // L
    n_pairs = n - n_leaf_rows
    desc = nodes[:, 7]
    internal = desc > 0.0
    pair_id = torch.cumsum(internal.to(torch.int64), 0) - 1
    c_l = torch.clamp(desc.to(torch.int32).to(torch.int64) - 1, 0, n - 1)
    # preorder invariant: right sibling = left child's skip pointer
    c_r = torch.clamp(nodes[c_l, 6].to(torch.int32).to(torch.int64) - 1,
                      0, n - 1)

    def child_desc(c):
        dc = desc[c]
        leaf_row = (-dc) / float(L)  # leaf rows are leaf_size-aligned
        return torch.where(dc > 0.0, (pair_id[c] + 1).to(torch.float32),
                           -leaf_row)

    zero = torch.zeros((n, 1), dtype=torch.float32, device=nodes.device)
    row = torch.cat([nodes[c_l, 0:6], child_desc(c_l)[:, None], zero,
                     nodes[c_r, 0:6], child_desc(c_r)[:, None], zero], 1)
    # internal nodes in preorder: row k is the node of pair id k
    return row[internal], n_pairs, n_leaf_rows


def pack_paired(tracer: Tracer):
    """Re-pack a preorder BVH into the padded paired layout of the TPU
    kernels: (pairs (R8, 128), leaves (P/L 8, 128), n_pairs, n_leaf_rows),
    row counts padded to multiples of 8. pairs holds the _pair_rows in its
    first 16 lanes; leaves holds one whole leaf (leaf_size x 12 floats) per
    row. Cached on the tracer."""
    if tracer.paired is not None:
        return tracer.paired
    rows, n_pairs, n_leaf_rows = _pair_rows(tracer)
    L = tracer.leaf_size
    dev = rows.device
    pairs = torch.zeros((n_pairs + (-n_pairs) % 8, 128), dtype=torch.float32,
                        device=dev)
    pairs[:n_pairs, :16] = rows
    leaves = torch.zeros((n_leaf_rows + (-n_leaf_rows) % 8, 128),
                         dtype=torch.float32, device=dev)
    leaves[:n_leaf_rows, :L * 12] = tracer.tris.reshape(n_leaf_rows, L * 12)
    tracer.paired = (pairs, leaves, n_pairs, n_leaf_rows)
    return tracer.paired


def paired_layout_bytes(tracer: Tracer) -> int:
    """Bytes of the paired layout's (R8, 128) + (P/L 8, 128) float32 rows
    (paired_vmem_bytes, pallas_intersect.py:1530-1539), from the tree's
    counts alone."""

    def pad8(n: int) -> int:
        return -(-n // 8) * 8

    n_leaf_rows = tracer.tris.shape[0] // tracer.leaf_size
    n_pairs = tracer.n_nodes - n_leaf_rows
    return (pad8(n_pairs) + pad8(n_leaf_rows)) * 128 * 4


def pack_paired_compact(tracer: Tracer):
    """The paired layout without its padding, as the packet walk reads it:
    (pairs16 (n_pairs, 16), leaf rows (n_leaf_rows, leaf_size * 12),
    n_pairs, n_leaf_rows). pairs16 is the _pair_rows themselves, cached on
    the tracer; the leaf rows are tracer.tris itself, whose leaves are
    leaf_size-aligned runs of 12-float triangle rows."""
    if tracer.pairs16 is None or tracer.pairs16.device != tracer.nodes.device:
        tracer.pairs16 = _pair_rows(tracer)[0].contiguous()
    n_leaf_rows = tracer.tris.shape[0] // tracer.leaf_size
    leaf_rows = tracer.tris[:n_leaf_rows * tracer.leaf_size].reshape(
        n_leaf_rows, tracer.leaf_size * 12)
    return tracer.pairs16, leaf_rows, tracer.pairs16.shape[0], n_leaf_rows


# ------------------------------------------------------- plain versions

def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(d) < 1e-12, 1e-12, d)


def _slab(o, inv, box, t_best):
    """Slab test of rays (n, 3) against boxes (n, 6) [min, max]:
    (hit, tlo), the operations and order of slab() in traverse.cu."""
    tx0 = (box[:, 0] - o[:, 0]) * inv[:, 0]
    tx1 = (box[:, 3] - o[:, 0]) * inv[:, 0]
    ty0 = (box[:, 1] - o[:, 1]) * inv[:, 1]
    ty1 = (box[:, 4] - o[:, 1]) * inv[:, 1]
    tz0 = (box[:, 2] - o[:, 2]) * inv[:, 2]
    tz1 = (box[:, 5] - o[:, 2]) * inv[:, 2]
    tlo = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                      torch.minimum(ty0, ty1)),
                        torch.minimum(tz0, tz1))
    thi = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                      torch.maximum(ty0, ty1)),
                        torch.maximum(tz0, tz1))
    hit = (thi >= torch.clamp(tlo, min=0.0)) & (tlo <= t_best)
    return hit, tlo


def _mt_fold(row, o, d, idx, best):
    """Moller-Trumbore of rays idx (origins o, dirs d) against one triangle
    row each (n, >=10 floats), folded into best = (t, u, v, face) with a
    strict t < t_best; the operations and order of mt_fold()."""
    t_b, u_b, v_b, f_b = best
    v0x, v0y, v0z = row[:, 0], row[:, 1], row[:, 2]
    e1x, e1y, e1z = row[:, 3], row[:, 4], row[:, 5]
    e2x, e2y, e2z = row[:, 6], row[:, 7], row[:, 8]
    fid = row[:, 9]
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok_det = torch.abs(det) > _MT_EPS
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
          & (fid >= 0.0) & (t < t_b[idx]))
    sel = idx[ok]
    t_b[sel] = t[ok]
    u_b[sel] = u[ok]
    v_b[sel] = v[ok]
    f_b[sel] = fid[ok].to(torch.int32)


def _new_best(b: int, dev):
    return (torch.full((b,), T_MISS, dtype=torch.float32, device=dev),
            torch.zeros(b, dtype=torch.float32, device=dev),
            torch.zeros(b, dtype=torch.float32, device=dev),
            torch.full((b,), -1, dtype=torch.int32, device=dev))


def trace_union_plain(tracer: Tracer, origins: torch.Tensor,
                      dirs: torch.Tensor, counts: dict | None = None):
    """Plain PyTorch version of trace_union: the same per-ray skip-pointer
    walk, vectorized over the rays still walking (a cursor per ray).

    counts, when given, receives this run's work: "slab" tests (one per
    node visit) and "mt" triangle tests."""
    nodes, tris = tracer.nodes, tracer.tris
    n, p, L = tracer.n_nodes, tris.shape[0], tracer.leaf_size
    o, d = origins, dirs
    inv = _safe_inv(d)
    best = _new_best(o.shape[0], o.device)
    cur = torch.ones(o.shape[0], dtype=torch.int64, device=o.device)
    alive = torch.arange(o.shape[0], device=o.device)
    n_slab = n_mt = 0
    for _ in range(2 * n + 2):      # a well-formed walk visits <= n nodes
        if alive.numel() == 0:
            break
        nd = nodes[torch.clamp(cur[alive] - 1, 0, n - 1)]
        hit, _ = _slab(o[alive], inv[alive], nd[:, 0:6], best[0][alive])
        desc = nd[:, 7]
        leaf = desc <= 0.0
        do_leaf = hit & leaf
        rows = alive[do_leaf]
        base = (-desc[do_leaf]).to(torch.int64)
        for k in range(L):
            _mt_fold(tris[torch.clamp(base + k, 0, p - 1)], o[rows], d[rows],
                     rows, best)
        nxt = torch.where(hit & ~leaf, desc.to(torch.int64),
                          nd[:, 6].to(torch.int64))
        cur[alive] = nxt
        n_slab += alive.numel()
        n_mt += rows.numel() * L
        alive = alive[nxt > 0]
    if alive.numel():
        raise RuntimeError("BVH walk did not terminate: corrupt tree")
    if counts is not None:
        counts.update(slab=n_slab, mt=n_mt)
    return best


def trace_paired_plain(tracer: Tracer, origins: torch.Tensor,
                       dirs: torch.Tensor, counts: dict | None = None):
    """Plain PyTorch version of trace_paired: the same per-ray near-first
    walk over the paired rows, with a (B, stack_depth) stack tensor and
    stack_depth = auto_stack_depth(tracer) >= depth + 4.

    counts, when given, receives "slab" tests (two per pair row popped)
    and "mt" triangle tests."""
    pairs, leaves, n_pairs, n_leaf_rows = pack_paired(tracer)
    L = tracer.leaf_size
    s = auto_stack_depth(tracer)
    o, d = origins, dirs
    b = o.shape[0]
    dev = o.device
    inv = _safe_inv(d)
    best = _new_best(b, dev)
    stack = torch.zeros((b, s), dtype=torch.int64, device=dev)
    sp = torch.ones(b, dtype=torch.int64, device=dev)
    alive = torch.arange(b, device=dev)
    n_slab = n_mt = 0
    for _ in range(2 * n_pairs + 2):  # each pair row is popped <= once
        if alive.numel() == 0:
            break
        sp1 = sp[alive] - 1
        row = pairs[stack[alive, sp1], :16]
        oa, ia, tb = o[alive], inv[alive], best[0][alive]
        hit_l, tlo_l = _slab(oa, ia, row[:, 0:6], tb)
        hit_r, tlo_r = _slab(oa, ia, row[:, 8:14], tb)
        dl, dr = row[:, 6], row[:, 14]
        l_leaf, r_leaf = dl <= 0.0, dr <= 0.0
        # leaf children first (left, then right): their hits shrink
        # t_best before the pushes
        for hit, dc, is_leaf in ((hit_l, dl, l_leaf), (hit_r, dr, r_leaf)):
            m = hit & is_leaf
            rows = alive[m]
            lrow = torch.clamp((-dc[m]).to(torch.int64), 0, n_leaf_rows - 1)
            lf = leaves[lrow]
            for k in range(L):
                _mt_fold(lf[:, k * 12:k * 12 + 12], o[rows], d[rows], rows,
                         best)
            n_mt += rows.numel() * L
        want_l = hit_l & ~l_leaf
        want_r = hit_r & ~r_leaf
        pid_l = torch.clamp(dl.to(torch.int64) - 1, 0, n_pairs - 1)
        pid_r = torch.clamp(dr.to(torch.int64) - 1, 0, n_pairs - 1)
        l_near = torch.where(want_l & want_r, tlo_l <= tlo_r, want_l)
        far = torch.where(l_near, pid_r, pid_l)
        near = torch.where(l_near, pid_l, pid_r)
        push_far = want_l & want_r
        push_near = want_l | want_r
        stack[alive[push_far], torch.clamp(sp1[push_far], max=s - 1)] = \
            far[push_far]
        sp3 = sp1 + push_far.to(torch.int64)
        stack[alive[push_near], torch.clamp(sp3[push_near], max=s - 1)] = \
            near[push_near]
        sp4 = torch.clamp(sp3 + push_near.to(torch.int64), max=s)
        sp[alive] = sp4
        n_slab += 2 * alive.numel()
        alive = alive[sp4 > 0]
    if alive.numel():
        raise RuntimeError("BVH walk did not terminate: corrupt tree")
    if counts is not None:
        counts.update(slab=n_slab, mt=n_mt)
    return best


def trace_ordered_plain(tracer: Tracer, origins: torch.Tensor,
                        dirs: torch.Tensor, counts: dict | None = None):
    """Plain PyTorch version of trace_ordered: the same per-ray near-first
    walk over nodes (N, 8) and tris (P, 12), with a (B, stack_depth) stack
    tensor.

    counts, when given, receives "slab" tests (one per node popped, two
    more per internal node entered) and "mt" triangle tests."""
    if tracer.layout != "preorder":
        raise ValueError("the ordered walk needs a preorder (SAH) tree")
    nodes, tris = tracer.nodes, tracer.tris
    n, p, L = tracer.n_nodes, tris.shape[0], tracer.leaf_size
    s = auto_stack_depth(tracer)
    o, d = origins, dirs
    b = o.shape[0]
    dev = o.device
    inv = _safe_inv(d)
    best = _new_best(b, dev)
    stack = torch.zeros((b, s), dtype=torch.int64, device=dev)
    sp = torch.ones(b, dtype=torch.int64, device=dev)
    alive = torch.arange(b, device=dev)
    n_slab = n_mt = 0
    for _ in range(2 * n + 2):        # each node is popped <= once
        if alive.numel() == 0:
            break
        sp1 = sp[alive] - 1
        nd = nodes[stack[alive, sp1]]
        oa, ia = o[alive], inv[alive]
        hit, _ = _slab(oa, ia, nd[:, 0:6], best[0][alive])  # pop-time prune
        desc = nd[:, 7]
        leaf = desc <= 0.0
        do_leaf = hit & leaf
        rows = alive[do_leaf]
        base = (-desc[do_leaf]).to(torch.int64)
        for k in range(L):
            _mt_fold(tris[torch.clamp(base + k, 0, p - 1)], o[rows], d[rows],
                     rows, best)
        do_int = hit & ~leaf
        child_l = torch.clamp(desc.to(torch.int64) - 1, 0, n - 1)
        nd_l = nodes[child_l]
        # preorder invariant: right sibling = left child's skip pointer
        child_r = torch.clamp(nd_l[:, 6].to(torch.int64) - 1, 0, n - 1)
        nd_r = nodes[child_r]
        tb = best[0][alive]
        hit_l, tlo_l = _slab(oa, ia, nd_l[:, 0:6], tb)
        hit_r, tlo_r = _slab(oa, ia, nd_r[:, 0:6], tb)
        hit_l = hit_l & do_int
        hit_r = hit_r & do_int
        l_near = torch.where(hit_l & hit_r, tlo_l <= tlo_r, hit_l)
        far = torch.where(l_near, child_r, child_l)
        near = torch.where(l_near, child_l, child_r)
        push_far = hit_l & hit_r
        push_near = hit_l | hit_r
        stack[alive[push_far], torch.clamp(sp1[push_far], max=s - 1)] = \
            far[push_far]
        sp3 = sp1 + push_far.to(torch.int64)
        stack[alive[push_near], torch.clamp(sp3[push_near], max=s - 1)] = \
            near[push_near]
        sp4 = torch.clamp(sp3 + push_near.to(torch.int64), max=s)
        sp[alive] = sp4
        n_slab += alive.numel() + 2 * int(do_int.sum())
        n_mt += rows.numel() * L
        alive = alive[sp4 > 0]
    if alive.numel():
        raise RuntimeError("BVH walk did not terminate: corrupt tree")
    if counts is not None:
        counts.update(slab=n_slab, mt=n_mt)
    return best


def _halving_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of x (n, W), W a power of two, added in halves:
    (x[:W/2] + x[W/2:]) and so on, the order of the kernel's butterfly
    warp_sum, so the plain version rounds the packet means alike."""
    w = x.shape[1]
    while w > 1:
        w //= 2
        x = x[:, :w] + x[:, w:]
    return x[:, 0]


def trace_paired_streamed_plain(tracer: Tracer, origins: torch.Tensor,
                                dirs: torch.Tensor,
                                counts: dict | None = None,
                                width: int = PACKET,
                                pair_win: int = PAIR_WIN,
                                leaf_win: int = LEAF_WIN):
    """Plain PyTorch version of trace_paired_streamed: the same packet
    walk, vectorized over the packets still walking. Each packet of `width`
    consecutive rays (a power of two; the kernel's is PACKET) shares one
    cursor and one (stack_depth,) stack; lanes vote on each child, the
    lanes that entered a leaf child's box fold its triangles, and the far
    and near internal children are ordered by the mean entry distance of
    the lanes that hit them. Rays past the end of the last packet never
    vote.

    The windows change what is read from where, not the result; the plain
    version only counts them. counts, when given, receives "slab" tests
    (two per lane per pair row popped), "mt" triangle tests (lanes that
    entered the leaf), "pops", and "pair_loads"/"leaf_loads": the window
    reloads of aligned pair_win/leaf_win-row windows."""
    if width < 1 or width & (width - 1):
        raise ValueError(f"packet width {width} is not a power of two")
    pairs16, leaf_rows, n_pairs, n_leaf_rows = pack_paired_compact(tracer)
    L = tracer.leaf_size
    s = auto_stack_depth(tracer)
    b = origins.shape[0]
    dev = origins.device
    pad = (-b) % width
    o, d = origins, dirs
    if pad:
        o = torch.cat([o, o[-1:].expand(pad, 3)], 0)
        d = torch.cat([d, d[-1:].expand(pad, 3)], 0)
    live = torch.arange(b + pad, device=dev) < b
    nq = (b + pad) // width
    inv = _safe_inv(d)
    best = _new_best(b + pad, dev)
    stack = torch.zeros((nq, s), dtype=torch.int64, device=dev)
    sp = torch.ones(nq, dtype=torch.int64, device=dev)
    pwin = torch.full((nq,), -1, dtype=torch.int64, device=dev)
    lwin = torch.full((nq,), -1, dtype=torch.int64, device=dev)
    alive = torch.arange(nq, device=dev)
    lane = torch.arange(width, device=dev)
    n_slab = n_mt = n_pops = n_pload = n_lload = 0
    for _ in range(2 * n_pairs + 2):  # each pair row is popped <= once
        na = alive.numel()
        if na == 0:
            break
        sp1 = sp[alive] - 1
        rid = stack[alive, sp1]
        tgt = rid // pair_win
        n_pload += int((tgt != pwin[alive]).sum())
        pwin[alive] = tgt
        row = pairs16[rid]
        ridx = (alive[:, None] * width + lane[None, :]).reshape(-1)
        rowx = row.repeat_interleave(width, 0)
        oa, ia, tb, lv = o[ridx], inv[ridx], best[0][ridx], live[ridx]
        hit_l, tlo_l = _slab(oa, ia, rowx[:, 0:6], tb)
        hit_r, tlo_r = _slab(oa, ia, rowx[:, 8:14], tb)
        hit_l = (hit_l & lv).reshape(na, width)
        hit_r = (hit_r & lv).reshape(na, width)
        any_l, any_r = hit_l.any(1), hit_r.any(1)
        dl, dr = row[:, 6], row[:, 14]
        l_leaf, r_leaf = dl <= 0.0, dr <= 0.0
        # leaf children first (left, then right): their hits shrink
        # t_best before the pushes
        for hit, any_, dc, is_leaf in ((hit_l, any_l, dl, l_leaf),
                                       (hit_r, any_r, dr, r_leaf)):
            do = any_ & is_leaf
            lrow = torch.clamp((-dc).to(torch.int64), 0, n_leaf_rows - 1)
            ltgt = lrow // leaf_win
            cur = lwin[alive]
            n_lload += int((do & (ltgt != cur)).sum())
            lwin[alive] = torch.where(do, ltgt, cur)
            m = (hit & do[:, None]).reshape(-1)
            rays = ridx[m]
            lf = leaf_rows[lrow.repeat_interleave(width)[m]]
            for k in range(L):
                _mt_fold(lf[:, k * 12:k * 12 + 12], o[rays], d[rays], rays,
                         best)
            n_mt += rays.numel() * L
        want_l = any_l & ~l_leaf
        want_r = any_r & ~r_leaf
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        mean_l = _halving_sum(torch.where(hit_l, tlo_l.reshape(na, width),
                                          zero)) \
            / torch.clamp(hit_l.sum(1).to(torch.float32), min=1.0)
        mean_r = _halving_sum(torch.where(hit_r, tlo_r.reshape(na, width),
                                          zero)) \
            / torch.clamp(hit_r.sum(1).to(torch.float32), min=1.0)
        pid_l = torch.clamp(dl.to(torch.int64) - 1, 0, n_pairs - 1)
        pid_r = torch.clamp(dr.to(torch.int64) - 1, 0, n_pairs - 1)
        l_near = torch.where(want_l & want_r, mean_l <= mean_r, want_l)
        far = torch.where(l_near, pid_r, pid_l)
        near = torch.where(l_near, pid_l, pid_r)
        push_far = want_l & want_r
        push_near = want_l | want_r
        stack[alive[push_far], torch.clamp(sp1[push_far], max=s - 1)] = \
            far[push_far]
        sp3 = sp1 + push_far.to(torch.int64)
        stack[alive[push_near], torch.clamp(sp3[push_near], max=s - 1)] = \
            near[push_near]
        sp4 = torch.clamp(sp3 + push_near.to(torch.int64), max=s)
        sp[alive] = sp4
        n_slab += 2 * int(lv.sum())
        n_pops += na
        alive = alive[sp4 > 0]
    if alive.numel():
        raise RuntimeError("BVH walk did not terminate: corrupt tree")
    if counts is not None:
        counts.update(slab=n_slab, mt=n_mt, pops=n_pops, pair_loads=n_pload,
                      leaf_loads=n_lload)
    return tuple(x[:b] for x in best)


# -------------------------------------------------------------- wrappers

def _check_cuda(name, arrays: dict, origins, dirs):
    dev = origins.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: rays on {dev}; the kernel needs CUDA "
                         "tensors (CPU tensors take the plain version)")
    for key, x in [("origins", origins), ("dirs", dirs)]:
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3:
            raise ValueError(f"{name}: {key} must be float32 (B, 3), got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if origins.shape[0] != dirs.shape[0]:
        raise ValueError(f"{name}: {origins.shape[0]} origins vs "
                         f"{dirs.shape[0]} directions")
    if origins.shape[0] >= 2 ** 31:
        raise ValueError(f"{name}: too many rays for one launch")
    for key, x in arrays.items():
        if x.device != dev:
            raise ValueError(f"{name}: {key} on {x.device}, rays on {dev}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous float32")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is not 16-byte aligned")


def _outputs(b: int, dev):
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty(b, **f32), torch.empty(b, **f32),
            torch.empty(b, **f32),
            torch.empty(b, dtype=torch.int32, device=dev))


def trace_union(tracer: Tracer, origins: torch.Tensor, dirs: torch.Tensor):
    """Closest hits by the stackless skip-pointer walk (replaces
    pallas_ray_trace, pallas_intersect.py:240). Any layout.
    Returns (t, u, v, face) per ray."""
    if origins.device.type == "cpu":
        return trace_union_plain(tracer, origins, dirs)
    _check_cuda("trace_union", {"nodes": tracer.nodes, "tris": tracer.tris},
                origins, dirs)
    lib = get_lib()
    b = origins.shape[0]
    t, u, v, face = _outputs(b, origins.device)
    with torch.cuda.device(origins.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.iris_trace_union(
            tracer.nodes.data_ptr(), tracer.n_nodes, tracer.tris.data_ptr(),
            tracer.tris.shape[0], tracer.leaf_size, origins.data_ptr(),
            dirs.data_ptr(), b, t.data_ptr(), u.data_ptr(), v.data_ptr(),
            face.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"trace_union launch failed: CUDA error {rc}")
    trace_union.launches += 1
    return t, u, v, face


trace_union.launches = 0


def trace_paired(tracer: Tracer, origins: torch.Tensor, dirs: torch.Tensor):
    """Closest hits by the near-first walk over the paired layout
    (replaces pallas_ray_trace_paired, pallas_intersect.py:782). Preorder
    trees only. Returns (t, u, v, face) per ray."""
    if origins.device.type == "cpu":
        return trace_paired_plain(tracer, origins, dirs)
    pairs, leaves, n_pairs, n_leaf_rows = pack_paired(tracer)
    _check_cuda("trace_paired", {"pairs": pairs, "leaves": leaves},
                origins, dirs)
    lib = get_lib()
    depth = _stack_entries("trace_paired", tracer, lib)
    b = origins.shape[0]
    t, u, v, face = _outputs(b, origins.device)
    with torch.cuda.device(origins.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.iris_trace_paired(
            pairs.data_ptr(), n_pairs, leaves.data_ptr(), n_leaf_rows,
            tracer.leaf_size, depth, origins.data_ptr(), dirs.data_ptr(), b,
            t.data_ptr(), u.data_ptr(), v.data_ptr(), face.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"trace_paired launch failed: CUDA error {rc}")
    trace_paired.launches += 1
    return t, u, v, face


trace_paired.launches = 0


def _stack_entries(name: str, tracer: Tracer, lib) -> int:
    depth = auto_stack_depth(tracer)
    cap = lib.iris_paired_stack_cap()
    if depth > cap:
        raise ValueError(
            f"{name}: the tree needs a {depth}-entry stack (depth "
            f"{tracer.depth}); the kernel holds {cap}")
    return depth


def trace_paired_streamed(tracer: Tracer, origins: torch.Tensor,
                          dirs: torch.Tensor):
    """Closest hits by the packet walk: one cursor per warp of PACKET
    consecutive rays over the compact paired rows, fetched through
    PAIR_WIN/LEAF_WIN-row shared-memory windows (replaces
    pallas_ray_trace_paired_streamed, pallas_intersect.py:989). Preorder
    trees only. Returns (t, u, v, face) per ray."""
    if origins.device.type == "cpu":
        return trace_paired_streamed_plain(tracer, origins, dirs)
    pairs16, leaf_rows, n_pairs, n_leaf_rows = pack_paired_compact(tracer)
    _check_cuda("trace_paired_streamed",
                {"pairs16": pairs16, "leaf rows": leaf_rows}, origins, dirs)
    lib = get_lib()
    depth = _stack_entries("trace_paired_streamed", tracer, lib)
    b = origins.shape[0]
    t, u, v, face = _outputs(b, origins.device)
    with torch.cuda.device(origins.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.iris_trace_paired_streamed(
            pairs16.data_ptr(), n_pairs, leaf_rows.data_ptr(), n_leaf_rows,
            tracer.leaf_size, depth, origins.data_ptr(), dirs.data_ptr(), b,
            t.data_ptr(), u.data_ptr(), v.data_ptr(), face.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(
            f"trace_paired_streamed launch failed: CUDA error {rc}"
            + (f" (invalid value: an empty tree, or the windows of "
               f"{tracer.leaf_size}-triangle leaf rows do not fit a "
               "block's shared memory)" if rc == 1 else ""))
    trace_paired_streamed.launches += 1
    return t, u, v, face


trace_paired_streamed.launches = 0


def trace_ordered(tracer: Tracer, origins: torch.Tensor, dirs: torch.Tensor):
    """Closest hits by the near-first, pop-time-pruned walk over the
    unpaired nodes (N, 8) and tris (P, 12) (replaces
    pallas_ray_trace_ordered, pallas_intersect.py:579). Preorder trees
    only, any leaf_size. Returns (t, u, v, face) per ray."""
    if origins.device.type == "cpu":
        return trace_ordered_plain(tracer, origins, dirs)
    if tracer.layout != "preorder":
        raise ValueError("the ordered walk needs a preorder (SAH) tree")
    _check_cuda("trace_ordered", {"nodes": tracer.nodes, "tris": tracer.tris},
                origins, dirs)
    lib = get_lib()
    depth = _stack_entries("trace_ordered", tracer, lib)
    b = origins.shape[0]
    t, u, v, face = _outputs(b, origins.device)
    with torch.cuda.device(origins.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.iris_trace_ordered(
            tracer.nodes.data_ptr(), tracer.n_nodes, tracer.tris.data_ptr(),
            tracer.tris.shape[0], tracer.leaf_size, depth,
            origins.data_ptr(), dirs.data_ptr(), b, t.data_ptr(),
            u.data_ptr(), v.data_ptr(), face.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"trace_ordered launch failed: CUDA error {rc}")
    trace_ordered.launches += 1
    return t, u, v, face


trace_ordered.launches = 0
