"""Closest-hit BVH traversal on Hopper: the seven CUDA kernels of
csrc/traverse.cu, their wrappers, and one plain PyTorch version beside each
(counterpart of iris_tpu/geometry/pallas_intersect.py).

Every traversal returns, per ray, the closest hit (t, u, v, face) with
face = -1 for a miss: t/u/v float32, face int32.

Dispatch. On the TPU, ray_intersect (intersect.py:471) picks one of seven
Pallas kernels by tree size, layout, VMEM gates and four environment dials
(_pallas_mode :383). The port's dispatch (geometry/intersect.py kernel_for)
follows the same rule with the dials as the fields of the tracer's
TraversalPolicy, so each scene runs the counterpart of the kernel it runs
there. "Gate" below is one of the three 10 MiB constants of this module.

===  ==========================  ======================  ===========================
 #   TPU kernel                  this port               which trees (policy)
===  ==========================  ======================  ===========================
 1   pallas_ray_trace            trace_union             < 5K faces inside the
                                                         resident gate; any heap
                                                         (Morton) tree (default)
 2   ..._streamed                trace_streamed          preorder, past the resident
                                                         gate, when neither paired
                                                         walk takes it
                                                         (paired_streamed=False and
                                                         dense off or past its gate)
 3   ..._ordered                 trace_ordered           preorder >= 5K faces inside
                                                         the resident gate that the
                                                         paired and dense layouts do
                                                         not take (leaf_size > 10);
                                                         past that gate too, where
                                                         the JAX package asserts
 4   ..._paired                  trace_paired            preorder >= 5K faces (any
                                                         size with paired=True),
                                                         paired layout inside its
                                                         gate (default)
 5   ..._paired_streamed         trace_paired_streamed   preorder, leaf_size <= 10,
                                                         paired layout past its gate
                                                         (default: the 102K scene)
 6   ..._dense                   trace_dense             dense layout inside its
                                                         gate and dense=True; or
                                                         dense="auto" where paired
                                                         and paired_streamed do not
                                                         take the tree
                                                         (paired_streamed=False)
 7   ..._dense_streamed          trace_dense_streamed    dense_streamed=True on a
                                                         preorder tree with
                                                         leaf_size <= 5 past the
                                                         resident gate, after #4, #5
                                                         and #6 passed
===  ==========================  ======================  ===========================

The card has no such memory gates (a 32 MB paired layout sits in the 50 MB
L2), so the splits are kept for parity of paths, not out of need;
chip_smoke.py times the five big-tree kernels on the same rays so they can
be moved on evidence.

The three streamed kernels (#2, #5, #7) are packet walks: `width`
consecutive rays share one cursor. traverse.cu instantiates them at every
width of PACKET_WIDTHS; the dispatch runs the shipped ones (STREAMED_PACKET;
PACKET), and the wrappers' width= argument lets chip_smoke.py and the card
tests hold and time the others. trace_streamed's hits do not depend on the
width; the pair walks
order near and far children by the packet's mean entry distance, so their
equal-t ties do, and each width is held against the plain version at that
width. The n_rays < 8192 XLA escape (intersect.py:395) does
not carry over: on the card every call launches a kernel.

A CUDA tensor launches the kernel, or raises: nothing catches a build or
launch error to fall back, and no environment switch swaps kernels. A CPU
tensor takes the plain version, which walks the same arrays in the same
visiting order. Each kernel counts its own launches and rays on the card
(thread 0 of a launch's first block), so a launch recorded into a CUDA
graph counts at each replay, when it runs, and a capture, which runs
nothing, counts nothing; kernel_counts() and launch_counts() read the
counts by wrapper name (KERNELS), reset_kernel_counts() clears them.

The kernels are built at first use with nvcc for sm_90a into
iris_tpu_torch/build/ (plain C ABI, loaded with ctypes).
"""

from __future__ import annotations

import contextlib
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

# The JAX package's three VMEM gates, 10 MiB each; kernel_for splits at the
# same sizes. PAIRED: the paired layout stays resident up to it and streams
# above (paired_available, pallas_intersect.py:1542). DENSE: the same for
# the dense layout (dense_available :1511). RESIDENT: the (N, 8)/(P, 12)
# rows, each padded to 128 lanes there (pallas_available :1565).
PAIRED_RESIDENT_BYTES = 10 << 20
DENSE_RESIDENT_BYTES = 10 << 20
RESIDENT_BYTES = 10 << 20

# The dense layout (pallas_intersect.py:1055-1056): sibling pairs (16 floats)
# and whole leaves (64-float slots) per 128-float row.
PAIR_PACK = 8
LEAF_PACK = 2

# The packet walks. A packet is `width` consecutive rays behind one cursor:
# 4, 8, 16 or 32 lanes of a warp (traverse.cu instantiates PACKET_WIDTHS).
# STREAMED_PACKET is the width trace_streamed ships, PACKET the width of
# trace_paired_streamed and trace_dense_streamed (one walk); the kernels'
# constants are kStreamedPacket and kPairPacket.
PACKET_WIDTHS = (4, 8, 16, 32)
STREAMED_PACKET = 4
PACKET = 32
# The pair walk's shared-memory windows scale with the packet: per lane
# PAIR_WIN_PER_LANE 64-byte pair records, and one whole leaf (leaf_size x 48
# bytes; a 256-byte slot in the dense layout) per LANES_PER_LEAF lanes
# (kPairWinPerLane, kLanesPerLeaf in traverse.cu). The plain versions only
# count reloads of the same windows. trace_streamed's kernel keeps no
# window (it reads nodes and leaves by broadcast loads); its plain version
# counts what windows of NODE_WIN_PER_LANE 32-byte nodes per lane and the
# same leaf windows would reload, the sizing that dropped them.
NODE_WIN_PER_LANE = 2
PAIR_WIN_PER_LANE = 1
LANES_PER_LEAF = 4


def node_win_for(width: int) -> int:
    """Nodes per window of trace_streamed at this packet width."""
    return width * NODE_WIN_PER_LANE


def pair_win_for(width: int) -> int:
    """Pair records per window of the pair walk at this packet width."""
    return width * PAIR_WIN_PER_LANE


def leaf_win_for(width: int) -> int:
    """Whole leaves per window of a packet walk at this packet width."""
    return max(width // LANES_PER_LEAF, 1)


# The windows at the shipped widths.
NODE_WIN = node_win_for(STREAMED_PACKET)
PAIR_WIN = pair_win_for(PACKET)
LEAF_WIN = leaf_win_for(PACKET)

KERNELS = ("trace_union", "trace_streamed", "trace_ordered", "trace_paired",
           "trace_paired_streamed", "trace_dense", "trace_dense_streamed")

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
    which holds ptxas' register and spill report; "" when the library was
    already up to date)."""
    return build_shared([_nvcc()] + NVCC_FLAGS, SOURCE, "libtraverse.so")


def get_lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build()[0])
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.iris_paired_stack_cap.restype = i32
            lib.iris_paired_stack_cap.argtypes = []
            walk = [vp, i32, vp, i32, i32]          # two arrays, leaf_size
            tail = [vp, vp, i32, vp, vp, vp, vp, vp]  # rays, hits, stream
            for name, stack in (("union", False), ("streamed", False),
                                ("paired", True), ("paired_streamed", True),
                                ("dense", True), ("dense_streamed", True)):
                fn = getattr(lib, "iris_trace_" + name)
                fn.restype = i32
                # the packet walks also take the packet width
                fn.argtypes = (walk + ([i32] if stack else []) + tail
                               + ([i32] if "streamed" in name else []))
            # the root's node row before the two arrays
            lib.iris_trace_ordered.restype = i32
            lib.iris_trace_ordered.argtypes = [vp] + walk + [i32] + tail
            lib.iris_packet_config.restype = i32
            lib.iris_packet_config.argtypes = [i32, i32, i32,
                                               ctypes.POINTER(i32)]
            lib.iris_walk_config.restype = i32
            lib.iris_walk_config.argtypes = [i32, i32, ctypes.POINTER(i32)]
            lib.iris_read_counts.restype = i32
            lib.iris_read_counts.argtypes = [
                ctypes.POINTER(ctypes.c_ulonglong)]
            lib.iris_reset_counts.restype = i32
            lib.iris_reset_counts.argtypes = []
            lib.iris_count_slots.restype = i32
            lib.iris_count_slots.argtypes = []
            if lib.iris_count_slots() != len(KERNELS):
                raise RuntimeError(f"{SOURCE} counts "
                                   f"{lib.iris_count_slots()} kernels, "
                                   f"KERNELS names {len(KERNELS)}")
            _LIB = lib
        return _LIB


_PACKET_KERNELS = ("trace_streamed", "trace_paired_streamed",
                   "trace_dense_streamed")


def packet_config(name: str, leaf_size: int,
                  width: int | None = None) -> dict:
    """What one instantiation of a packet walk takes on the current card:
    its packet width (the kernel's shipped one by default), dynamic shared
    memory per block, resident blocks per SM (0 when a block does not fit
    the shared memory a block of this card may opt into), threads per
    block, that limit, registers per thread and local memory per thread.
    Needs the card."""
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(torch.cuda.current_device()):
        rc = get_lib().iris_packet_config(_PACKET_KERNELS.index(name),
                                          _packet_width(name, width),
                                          leaf_size, out)
    if rc != 0:
        raise RuntimeError(f"{name}: packet_config failed: CUDA error {rc}")
    keys = ("packet_width", "smem_bytes_per_block", "blocks_per_sm",
            "threads_per_block", "smem_limit_bytes", "registers",
            "local_bytes_per_thread")
    return dict(zip(keys, out))


_WALK_KERNELS = ("trace_ordered", "trace_paired", "trace_dense",
                 "trace_union")
# the pair walk's instantiated leaf sizes (paired_kernel_of, dense_kernel_of);
# trace_ordered and trace_union take any
_WALK_LEAVES = {"trace_paired": range(1, 11), "trace_dense": range(1, 6)}


def walk_config(name: str, leaf_size: int) -> dict:
    """What the per-ray walk a launch at this leaf size runs takes on the
    current card, as the CUDA runtime reports it for that instantiation:
    threads per block, registers per thread, local memory per thread (the
    stack and any spills), static shared memory per block and resident
    blocks per SM. Needs the card."""
    if name not in _WALK_KERNELS:
        raise ValueError(f"{name}: not one of {_WALK_KERNELS}")
    if leaf_size < 1 or leaf_size not in _WALK_LEAVES.get(name, (leaf_size,)):
        raise ValueError(f"{name}: no kernel for leaf size {leaf_size}")
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(torch.cuda.current_device()):
        rc = get_lib().iris_walk_config(_WALK_KERNELS.index(name), leaf_size,
                                        out)
    if rc != 0:
        raise RuntimeError(f"{name}: walk_config failed: CUDA error {rc}")
    keys = ("threads_per_block", "registers", "local_bytes_per_thread",
            "smem_bytes_per_block", "blocks_per_sm")
    return dict(zip(keys, out))


def _packet_width(name: str, width: int | None) -> int:
    """The width argument of a packet walk's C entry: 0 asks for the width
    the kernel ships, anything else must be instantiated."""
    if width is None:
        return 0
    if width not in PACKET_WIDTHS:
        raise ValueError(f"{name}: packet width {width} is not one of "
                         f"{PACKET_WIDTHS}")
    return width


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
    desc' <= 0: leaf child, leaf row -desc' (its triangles are tris rows
    leaf_size * row ...). Exact for any leaf_size: the paired layout's
    limit on the leaf row is its callers' (pack_paired_compact,
    _pairable)."""
    if tracer.layout != "preorder":
        raise ValueError("the paired layout needs a preorder (SAH) tree")
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
    if (tracer.paired is not None
            and tracer.paired[0].device == tracer.nodes.device):
        return tracer.paired
    rows, _, n_pairs, n_leaf_rows = pack_paired_compact(tracer)
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


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _pair_leaf_counts(tracer: Tracer) -> tuple[int, int]:
    n_leaf_rows = tracer.tris.shape[0] // tracer.leaf_size
    return tracer.n_nodes - n_leaf_rows, n_leaf_rows


def paired_layout_bytes(tracer: Tracer) -> int:
    """Bytes of the paired layout's (R8, 128) + (P/L 8, 128) float32 rows
    (paired_vmem_bytes, pallas_intersect.py:1530-1539), from the tree's
    counts alone."""
    n_pairs, n_leaf_rows = _pair_leaf_counts(tracer)
    return (_pad8(n_pairs) + _pad8(n_leaf_rows)) * 128 * 4


def dense_layout_bytes(tracer: Tracer) -> int:
    """Bytes of the dense layout's 128-float rows, PAIR_PACK pairs or
    LEAF_PACK leaves each (dense_vmem_bytes, pallas_intersect.py:1498),
    from the tree's counts alone."""
    n_pairs, n_leaf_rows = _pair_leaf_counts(tracer)
    return (_pad8(-(-n_pairs // PAIR_PACK))
            + _pad8(-(-n_leaf_rows // LEAF_PACK))) * 128 * 4


def resident_layout_bytes(tracer: Tracer) -> int:
    """Bytes of the (N, 8) node and (P, 12) triangle rows once each is
    padded to 128 lanes, as the TPU stages them (vmem_bytes,
    pallas_intersect.py:1548)."""
    return (_pad8(tracer.nodes.shape[0])
            + _pad8(tracer.tris.shape[0])) * 128 * 4


# Which layouts take a tree (pallas_intersect.py:1511-1589). The byte gates
# are read when called, so a caller may move them.

def _pairable(tracer: Tracer, leaf_floats: int) -> bool:
    return (tracer.layout == "preorder" and tracer.n_nodes > 1
            and tracer.leaf_size * 12 <= leaf_floats)


def paired_available(tracer: Tracer) -> bool:
    return (_pairable(tracer, 128)
            and paired_layout_bytes(tracer) <= PAIRED_RESIDENT_BYTES)


def dense_available(tracer: Tracer) -> bool:
    return (_pairable(tracer, 64)
            and dense_layout_bytes(tracer) <= DENSE_RESIDENT_BYTES)


def resident_available(tracer: Tracer) -> bool:
    """pallas_available (:1565)."""
    return resident_layout_bytes(tracer) <= RESIDENT_BYTES


def streamable(tracer: Tracer) -> bool:
    """pallas_streamable (:1571)."""
    return tracer.layout == "preorder"


def paired_streamed_available(tracer: Tracer) -> bool:
    return _pairable(tracer, 128)


def dense_streamed_available(tracer: Tracer) -> bool:
    return _pairable(tracer, 64)


def _leaf_rows(tracer: Tracer):
    """tracer.tris as whole leaves: (n_leaf_rows, leaf_size * 12), a view
    (its leaves are leaf_size-aligned runs of 12-float triangle rows)."""
    n_leaf_rows = tracer.tris.shape[0] // tracer.leaf_size
    return tracer.tris[:n_leaf_rows * tracer.leaf_size].reshape(
        n_leaf_rows, tracer.leaf_size * 12)


def pair_records(tracer: Tracer) -> torch.Tensor:
    """The _pair_rows records, (n_pairs, 16), cached on the tracer
    (pairs16): what trace_ordered walks for any leaf_size, and the compact
    paired layout of the packet walks."""
    if tracer.pairs16 is None or tracer.pairs16.device != tracer.nodes.device:
        tracer.pairs16 = _pair_rows(tracer)[0].contiguous()
    return tracer.pairs16


def pack_paired_compact(tracer: Tracer):
    """The paired layout without its padding, as the packet walk reads it:
    (pairs16 (n_pairs, 16), leaf rows (n_leaf_rows, leaf_size * 12),
    n_pairs, n_leaf_rows). pairs16 is pair_records(tracer); the leaf rows
    are tracer.tris itself."""
    if tracer.leaf_size * 12 > 128:
        raise ValueError("leaf row exceeds one 128-float row")
    pairs16 = pair_records(tracer)
    leaf_rows = _leaf_rows(tracer)
    return pairs16, leaf_rows, pairs16.shape[0], leaf_rows.shape[0]


def pack_dense(tracer: Tracer):
    """Re-pack a preorder BVH into the dense layout of the TPU kernels
    (_pack_dense, pallas_intersect.py:1059): (pairs (R8, 128), leaves
    (R8, 128), n_pairs, n_leaf_rows), the same values bit for bit. A pair
    row holds PAIR_PACK pair records of 16 floats: the array is pairs16
    itself, padded with zero records to whole rows and to a multiple of 8
    rows. A leaf row holds LEAF_PACK slots of 64 floats, leaf_size * 12 of
    them used. Cached on the tracer."""
    if (tracer.dense is not None
            and tracer.dense[0].device == tracer.nodes.device):
        return tracer.dense
    if tracer.leaf_size * 12 > 64:
        raise ValueError("leaf exceeds its 64-float slot of the dense "
                         "layout")
    rows, leaf_rows, n_pairs, n_leaf_rows = pack_paired_compact(tracer)
    dev = rows.device
    pair_rows = _pad8(-(-n_pairs // PAIR_PACK))
    pairs = torch.zeros((pair_rows * PAIR_PACK, 16), dtype=torch.float32,
                        device=dev)
    pairs[:n_pairs] = rows
    slot_rows = _pad8(-(-n_leaf_rows // LEAF_PACK))
    slots = torch.zeros((slot_rows * LEAF_PACK, 64), dtype=torch.float32,
                        device=dev)
    slots[:n_leaf_rows, :tracer.leaf_size * 12] = leaf_rows
    tracer.dense = (pairs.view(pair_rows, 128), slots.view(slot_rows, 128),
                    n_pairs, n_leaf_rows)
    return tracer.dense


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
    node visit) and "mt" triangle tests, and the nodes visited with what
    they make of a warp's steps: "pops", "warp_steps", "lane_busy"
    (warp_counts)."""
    nodes, tris = tracer.nodes, tracer.tris
    n, p, L = tracer.n_nodes, tris.shape[0], tracer.leaf_size
    o, d = origins, dirs
    inv = _safe_inv(d)
    best = _new_best(o.shape[0], o.device)
    cur = torch.ones(o.shape[0], dtype=torch.int64, device=o.device)
    alive = torch.arange(o.shape[0], device=o.device)
    pops = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    n_slab = n_mt = 0
    for _ in range(2 * n + 2):      # a well-formed walk visits <= n nodes
        if alive.numel() == 0:
            break
        pops[alive] += 1
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
        counts.update(slab=n_slab, mt=n_mt, **warp_counts(pops))
    return best


def warp_counts(pops: torch.Tensor) -> dict:
    """What per-ray pop counts, in launch order, make of a warp's steps:
    one ray per thread, a warp of 32 consecutive rays steps until its
    longest walk is done. "pops" (the sum), "warp_steps" (over the aligned
    runs of 32 rays, the most pops of any ray of the run, summed; a ragged
    last run counts as a whole warp) and "lane_busy" = pops / (32 x
    warp_steps), the share of lane steps that walk."""
    runs = torch.nn.functional.pad(pops, (0, (-pops.numel()) % 32))
    steps = int(runs.view(-1, 32).amax(1).sum()) if pops.numel() else 0
    total = int(pops.sum())
    return {"pops": total, "warp_steps": steps,
            "lane_busy": total / (32 * steps) if steps else 0.0}


def _pair_walk_plain(rows16, leaf_rows, n_pairs, n_leaf_rows, L, s, origins,
                     dirs, counts):
    """The per-ray near-first walk over pair records rows16 (>= n_pairs,
    16) and whole leaves leaf_rows (>= n_leaf_rows, >= L * 12), with a
    (B, s) stack tensor: what trace_paired and trace_dense compute, each
    over its own layout's views."""
    o, d = origins, dirs
    b = o.shape[0]
    dev = o.device
    inv = _safe_inv(d)
    best = _new_best(b, dev)
    stack = torch.zeros((b, s), dtype=torch.int64, device=dev)
    sp = torch.ones(b, dtype=torch.int64, device=dev)
    alive = torch.arange(b, device=dev)
    pops = torch.zeros(b, dtype=torch.int64, device=dev)
    n_slab = n_mt = 0
    for _ in range(2 * n_pairs + 2):  # each pair row is popped <= once
        if alive.numel() == 0:
            break
        pops[alive] += 1
        sp1 = sp[alive] - 1
        row = rows16[stack[alive, sp1]]
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
            lf = leaf_rows[lrow]
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
        counts.update(slab=n_slab, mt=n_mt, **warp_counts(pops))
    return best


def trace_paired_plain(tracer: Tracer, origins: torch.Tensor,
                       dirs: torch.Tensor, counts: dict | None = None):
    """Plain PyTorch version of trace_paired: the same per-ray near-first
    walk over the paired rows, with a (B, stack_depth) stack tensor and
    stack_depth = auto_stack_depth(tracer) >= depth + 4.

    counts, when given, receives "slab" tests (two per pair row popped),
    "mt" triangle tests, and the pair rows popped with what they make of
    a warp's steps: "pops", "warp_steps", "lane_busy" (warp_counts)."""
    pairs, leaves, n_pairs, n_leaf_rows = pack_paired(tracer)
    return _pair_walk_plain(pairs[:, :16], leaves, n_pairs, n_leaf_rows,
                            tracer.leaf_size, auto_stack_depth(tracer),
                            origins, dirs, counts)


def trace_dense_plain(tracer: Tracer, origins: torch.Tensor,
                      dirs: torch.Tensor, counts: dict | None = None):
    """Plain PyTorch version of trace_dense: trace_paired_plain's walk with
    every record taken from its slot of the dense layout (pair p at row
    p // 8, lanes 16 * (p % 8) + ...; leaf l at row l // 2, lanes
    64 * (l % 2) + ...), which the (R * 8, 16) and (R * 2, 64) views index
    directly. Same counts as trace_paired_plain."""
    pairs, leaves, n_pairs, n_leaf_rows = pack_dense(tracer)
    return _pair_walk_plain(pairs.view(-1, 16), leaves.view(-1, 64), n_pairs,
                            n_leaf_rows, tracer.leaf_size,
                            auto_stack_depth(tracer), origins, dirs, counts)


def trace_ordered_plain(tracer: Tracer, origins: torch.Tensor,
                        dirs: torch.Tensor, counts: dict | None = None):
    """Plain PyTorch version of trace_ordered: the same per-ray near-first
    walk over nodes (N, 8) and tris (P, 12), with a (B, stack_depth) stack
    tensor. It slab-tests each popped node against the current t_best; the
    kernel compares the entry distance the node was pushed with instead,
    which gives the same bit (the pushed test held thi >= max(tlo, 0)).

    counts, when given, receives "slab": the slab tests the kernel's walk
    makes (one at the root per ray, two per internal node entered), "mt"
    triangle tests, and the nodes popped with what they make of a warp's
    steps: "pops", "warp_steps", "lane_busy" (warp_counts)."""
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
    pops = torch.zeros(b, dtype=torch.int64, device=dev)
    n_slab, n_mt = b, 0
    for _ in range(2 * n + 2):        # each node is popped <= once
        if alive.numel() == 0:
            break
        pops[alive] += 1
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
        n_slab += 2 * int(do_int.sum())
        n_mt += rows.numel() * L
        alive = alive[sp4 > 0]
    if alive.numel():
        raise RuntimeError("BVH walk did not terminate: corrupt tree")
    if counts is not None:
        counts.update(slab=n_slab, mt=n_mt, **warp_counts(pops))
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


def _check_width(width: int) -> None:
    if width < 1 or width & (width - 1):
        raise ValueError(f"packet width {width} is not a power of two")


def _pad_packets(origins, dirs, width):
    """Rays padded to whole packets (the last ray repeated): (o, d, live
    mask, packets). Rays past the end never vote."""
    b = origins.shape[0]
    pad = (-b) % width
    o, d = origins, dirs
    if pad:
        o = torch.cat([o, o[-1:].expand(pad, 3)], 0)
        d = torch.cat([d, d[-1:].expand(pad, 3)], 0)
    live = torch.arange(b + pad, device=o.device) < b
    return o, d, live, (b + pad) // width


def _packet_walk_plain(rows16, leaf_rows, n_pairs, n_leaf_rows, L, s, origins,
                       dirs, counts, width, pair_win, leaf_win):
    """The near-first packet walk over pair records rows16 and whole leaves
    leaf_rows, vectorized over the packets still walking: what
    trace_paired_streamed and trace_dense_streamed compute. pair_win and
    leaf_win are window sizes in pair records and leaves; they change what
    is read from where, not the result, and are only counted."""
    _check_width(width)
    b = origins.shape[0]
    dev = origins.device
    o, d, live, nq = _pad_packets(origins, dirs, width)
    inv = _safe_inv(d)
    best = _new_best(o.shape[0], dev)
    stack = torch.zeros((nq, s), dtype=torch.int64, device=dev)
    # how each entry came onto the stack, for the counts only
    kind = torch.zeros((nq, s), dtype=torch.int64, device=dev)
    k_root, k_far, k_next, k_near = 0, 1, 2, 3
    sp = torch.ones(nq, dtype=torch.int64, device=dev)
    pwin = torch.full((nq,), -1, dtype=torch.int64, device=dev)
    lwin = torch.full((nq,), -1, dtype=torch.int64, device=dev)
    alive = torch.arange(nq, device=dev)
    lane = torch.arange(width, device=dev)
    n_slab = n_mt = n_pops = n_pload = n_lload = 0
    n_pnext = n_lnext = n_far = n_nextpop = max_stack = 0
    for _ in range(2 * n_pairs + 2):  # each pair row is popped <= once
        na = alive.numel()
        if na == 0:
            break
        max_stack = max(max_stack, int(sp[alive].max()))
        sp1 = sp[alive] - 1
        rid = stack[alive, sp1]
        how = kind[alive, sp1]
        n_far += int((how == k_far).sum())
        n_nextpop += int((how == k_next).sum())
        tgt = rid // pair_win  # window of this pair record
        held = pwin[alive]
        n_pload += int((tgt != held).sum())
        n_pnext += int(((tgt == held + 1) & (held >= 0)).sum())
        pwin[alive] = tgt
        row = rows16[rid]
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
            n_lnext += int((do & (ltgt == cur + 1) & (cur >= 0)).sum())
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
        pos_far = torch.clamp(sp1[push_far], max=s - 1)
        stack[alive[push_far], pos_far] = far[push_far]
        kind[alive[push_far], pos_far] = k_far
        sp3 = sp1 + push_far.to(torch.int64)
        pos_near = torch.clamp(sp3[push_near], max=s - 1)
        stack[alive[push_near], pos_near] = near[push_near]
        kind[alive[push_near], pos_near] = torch.where(
            near == rid + 1, k_next, k_near)[push_near]
        sp4 = torch.clamp(sp3 + push_near.to(torch.int64), max=s)
        sp[alive] = sp4
        n_slab += 2 * int(lv.sum())
        n_pops += na
        alive = alive[sp4 > 0]
    if alive.numel():
        raise RuntimeError("BVH walk did not terminate: corrupt tree")
    if counts is not None:
        counts.update(slab=n_slab, mt=n_mt, pops=n_pops, pair_loads=n_pload,
                      leaf_loads=n_lload, pair_loads_next=n_pnext,
                      leaf_loads_next=n_lnext, far_pops=n_far,
                      next_pops=n_nextpop, max_stack=max_stack)
    return tuple(x[:b] for x in best)


def trace_paired_streamed_plain(tracer: Tracer, origins: torch.Tensor,
                                dirs: torch.Tensor,
                                counts: dict | None = None,
                                width: int = PACKET,
                                pair_win: int | None = None,
                                leaf_win: int | None = None):
    """Plain PyTorch version of trace_paired_streamed: the same packet
    walk, vectorized over the packets still walking. Each packet of `width`
    consecutive rays (a power of two; the kernel ships PACKET) shares one
    cursor and one (stack_depth,) stack; lanes vote on each child, the
    lanes that entered a leaf child's box fold its triangles, and the far
    and near internal children are ordered by the mean entry distance of
    the lanes that hit them, summed in the kernel's butterfly order. Rays
    past the end of the last packet never vote.

    The windows change what is read from where, not the result; the plain
    version only counts them (defaults: the kernel's windows at this
    width). counts, when given, receives "slab" tests (two per lane per
    pair row popped), "mt" triangle tests (lanes that entered the leaf),
    "pops", "pair_loads"/"leaf_loads": the reloads of aligned
    pair_win/leaf_win-row windows, "pair_loads_next"/"leaf_loads_next":
    those of them whose target is the window right after the one held
    (all a prefetch of the following window could serve), "far_pops":
    pops of an entry pushed as a far child (all that a record fetched at
    the push could serve), "next_pops": pops of a near child whose record
    is the row after its parent's, and "max_stack": the deepest stack of
    any packet."""
    pairs16, leaf_rows, n_pairs, n_leaf_rows = pack_paired_compact(tracer)
    return _packet_walk_plain(
        pairs16, leaf_rows, n_pairs, n_leaf_rows, tracer.leaf_size,
        auto_stack_depth(tracer), origins, dirs, counts, width,
        pair_win_for(width) if pair_win is None else pair_win,
        leaf_win_for(width) if leaf_win is None else leaf_win)


def trace_dense_streamed_plain(tracer: Tracer, origins: torch.Tensor,
                               dirs: torch.Tensor,
                               counts: dict | None = None,
                               width: int = PACKET,
                               pair_win: int | None = None,
                               leaf_win: int | None = None):
    """Plain PyTorch version of trace_dense_streamed: trace_paired_streamed
    _plain's packet walk with every record taken from its slot of the dense
    layout; left leaf before right leaf, each with its own window check.
    pair_win and leaf_win, when given, count 128-float dense rows, as the
    TPU kernel's do (a pair window covers pair_win * 8 pairs, a leaf window
    leaf_win * 2 leaves); by default the windows are the kernel's at this
    width, the same records as trace_paired_streamed's. Same counts as
    trace_paired_streamed_plain."""
    pairs, leaves, n_pairs, n_leaf_rows = pack_dense(tracer)
    return _packet_walk_plain(
        pairs.view(-1, 16), leaves.view(-1, 64), n_pairs, n_leaf_rows,
        tracer.leaf_size, auto_stack_depth(tracer), origins, dirs, counts,
        width,
        pair_win_for(width) if pair_win is None else pair_win * PAIR_PACK,
        leaf_win_for(width) if leaf_win is None else leaf_win * LEAF_PACK)


def trace_streamed_plain(tracer: Tracer, origins: torch.Tensor,
                         dirs: torch.Tensor, counts: dict | None = None,
                         width: int = STREAMED_PACKET,
                         node_win: int | None = None,
                         leaf_win: int | None = None):
    """Plain PyTorch version of trace_streamed: the stackless preorder
    walk with one cursor per packet of `width` consecutive rays (the kernel
    ships STREAMED_PACKET), vectorized over the packets still walking.
    Every lane slab-tests the cursor's node against its own t_best; the
    packet descends when any lane hit, else jumps to the skip pointer; a
    leaf is folded only by the lanes whose own test hit. A lane's extra
    visits are misses for it, so the hits are those of the per-ray walk
    (trace_union_plain), bit for bit, at any width.

    counts, when given, receives "slab" tests (one per lane per node
    visited), "mt" triangle tests, "visits", "node_loads"/"leaf_loads": the
    reloads of aligned node_win/leaf_win-row windows (defaults: the
    kernel's at this width), which in a preorder tree only move forward
    ("backward_loads" counts the reloads that did not: always 0), and
    "node_loads_next"/"leaf_loads_next": the reloads whose target is the
    window right after the one held, all that a prefetch of the following
    window could serve (any other reload jumped past it);
    "longest_walk": the visits of the packet that walked longest, a chain
    of dependent steps no other packet shortens."""
    _check_width(width)
    if tracer.layout != "preorder":
        raise ValueError("the streamed walk needs a preorder (SAH) tree")
    node_win = node_win_for(width) if node_win is None else node_win
    leaf_win = leaf_win_for(width) if leaf_win is None else leaf_win
    nodes = tracer.nodes
    leaf_rows = _leaf_rows(tracer)
    n, n_leaf_rows, L = tracer.n_nodes, leaf_rows.shape[0], tracer.leaf_size
    b = origins.shape[0]
    dev = origins.device
    o, d, live, nq = _pad_packets(origins, dirs, width)
    inv = _safe_inv(d)
    best = _new_best(o.shape[0], dev)
    cur = torch.ones(nq, dtype=torch.int64, device=dev)
    nwin = torch.full((nq,), -1, dtype=torch.int64, device=dev)
    lwin = torch.full((nq,), -1, dtype=torch.int64, device=dev)
    alive = torch.arange(nq, device=dev)
    lane = torch.arange(width, device=dev)
    n_slab = n_mt = n_visits = n_nload = n_lload = 0
    n_nnext = n_lnext = n_back = n_steps = 0
    for _ in range(2 * n + 2):        # a well-formed walk visits <= n nodes
        na = alive.numel()
        if na == 0:
            break
        n_steps += 1
        node = torch.clamp(cur[alive] - 1, 0, n - 1)
        tgt = node // node_win
        held = nwin[alive]
        n_nload += int((tgt != held).sum())
        n_nnext += int(((tgt == held + 1) & (held >= 0)).sum())
        n_back += int((tgt < held).sum())
        nwin[alive] = tgt
        nd = nodes[node]
        ridx = (alive[:, None] * width + lane[None, :]).reshape(-1)
        ndx = nd.repeat_interleave(width, 0)
        lv = live[ridx]
        hit, _ = _slab(o[ridx], inv[ridx], ndx[:, 0:6], best[0][ridx])
        hit = (hit & lv).reshape(na, width)
        any_hit = hit.any(1)
        desc = nd[:, 7]
        leaf = desc <= 0.0
        do = any_hit & leaf
        lrow = torch.clamp((-desc).to(torch.int64) // L, 0, n_leaf_rows - 1)
        ltgt = lrow // leaf_win
        held = lwin[alive]
        n_lload += int((do & (ltgt != held)).sum())
        n_lnext += int((do & (ltgt == held + 1) & (held >= 0)).sum())
        n_back += int((do & (ltgt < held)).sum())
        lwin[alive] = torch.where(do, ltgt, held)
        m = (hit & do[:, None]).reshape(-1)
        rays = ridx[m]
        lf = leaf_rows[lrow.repeat_interleave(width)[m]]
        for k in range(L):
            _mt_fold(lf[:, k * 12:k * 12 + 12], o[rays], d[rays], rays, best)
        nxt = torch.where(any_hit & ~leaf, desc.to(torch.int64),
                          nd[:, 6].to(torch.int64))
        cur[alive] = nxt
        n_slab += int(lv.sum())
        n_mt += rays.numel() * L
        n_visits += na
        alive = alive[nxt > 0]
    if alive.numel():
        raise RuntimeError("BVH walk did not terminate: corrupt tree")
    if counts is not None:
        counts.update(slab=n_slab, mt=n_mt, visits=n_visits,
                      node_loads=n_nload, leaf_loads=n_lload,
                      node_loads_next=n_nnext, leaf_loads_next=n_lnext,
                      backward_loads=n_back, longest_walk=n_steps)
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


def _launch(wrapper, arrays: dict, head: tuple, origins, dirs, hint="",
            width: int | None = None):
    """Check the inputs, launch the wrapper's kernel (the C function
    iris_<wrapper name>, which counts its own launch: kernel_counts) on
    the current stream and return (t, u, v, face). `arrays` are the two
    tree arrays by name, `head` the C function's arguments before the
    rays, `width` a packet walk's packet width (None: the shipped one),
    passed after the stream."""
    name = wrapper.__name__
    last = (_packet_width(name, width),) if name in _PACKET_KERNELS else ()
    _check_cuda(name, arrays, origins, dirs)
    b = origins.shape[0]
    t, u, v, face = _outputs(b, origins.device)
    with torch.cuda.device(origins.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(get_lib(), "iris_" + name)(
            *head, origins.data_ptr(), dirs.data_ptr(), b, t.data_ptr(),
            u.data_ptr(), v.data_ptr(), face.data_ptr(), stream, *last)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}"
                           + (f" ({hint})" if hint and rc == 1 else ""))
    return t, u, v, face


def _on_card(device):
    """A block run with `device` current (None: the current card)."""
    return (contextlib.nullcontext() if device is None
            else torch.cuda.device(device))


def kernel_counts(device=None) -> dict[str, tuple[int, int]]:
    """{wrapper name: (launches, rays)} of each kernel on `device` (the
    current card by default) since the library was loaded or
    reset_kernel_counts() last ran, as the kernels counted them on the card
    (a zero-ray call launches nothing). Waits for the card to finish its
    work. All zero for a CPU device, and in a process that has launched no
    kernel (the library is not loaded)."""
    if _LIB is None or (device is not None
                        and torch.device(device).type != "cuda"):
        return {name: (0, 0) for name in KERNELS}
    out = (ctypes.c_ulonglong * (2 * len(KERNELS)))()
    with _on_card(device):
        rc = _LIB.iris_read_counts(out)
    if rc != 0:
        raise RuntimeError(f"reading the kernels' counts: CUDA error {rc}")
    return {name: (out[2 * i], out[2 * i + 1])
            for i, name in enumerate(KERNELS)}


def launch_counts(device=None) -> dict[str, int]:
    """{wrapper name: launches} (kernel_counts)."""
    return {name: n for name, (n, _) in kernel_counts(device).items()}


def reset_kernel_counts(device=None) -> None:
    """Zero the kernels' counts on `device` (the current card by
    default), once it has finished its work."""
    if _LIB is None or (device is not None
                        and torch.device(device).type != "cuda"):
        return
    with _on_card(device):
        rc = _LIB.iris_reset_counts()
    if rc != 0:
        raise RuntimeError(f"resetting the kernels' counts: CUDA error {rc}")


def walk_stack_depth(tracer: Tracer) -> int:
    """Stack entries of the per-ray walks' kernels (trace_paired,
    trace_dense, trace_ordered), which keep the near child in a register
    and push only far children: at most depth entries, sized depth + 4 as
    auto_stack_depth does, without its 64-entry floor (64 when the depth
    is unknown). The kernels hold iris_paired_stack_cap() entries."""
    return tracer.depth + 4 if tracer.depth else 64


def _stack_entries(name: str, tracer: Tracer, depth: int) -> int:
    """depth, once the kernel is known to hold that many stack entries."""
    cap = get_lib().iris_paired_stack_cap()
    if depth > cap:
        raise ValueError(
            f"{name}: the tree needs a {depth}-entry stack (depth "
            f"{tracer.depth}); the kernel holds {cap}")
    return depth


def _need_preorder(name: str, tracer: Tracer) -> None:
    if tracer.layout != "preorder":
        raise ValueError(f"{name} needs a preorder (SAH) tree")


def trace_union(tracer: Tracer, origins: torch.Tensor, dirs: torch.Tensor):
    """Closest hits by the stackless skip-pointer walk (replaces
    pallas_ray_trace, pallas_intersect.py:240). Any layout, any leaf size.
    Returns (t, u, v, face) per ray."""
    if origins.device.type == "cpu":
        return trace_union_plain(tracer, origins, dirs)
    return _launch(
        trace_union, {"nodes": tracer.nodes, "tris": tracer.tris},
        (tracer.nodes.data_ptr(), tracer.n_nodes, tracer.tris.data_ptr(),
         tracer.tris.shape[0], tracer.leaf_size), origins, dirs)


_WINDOW_HINT = ("invalid value: an empty tree, or the windows of "
                "{}-triangle leaf rows do not fit the shared memory a block "
                "of this card may opt into")


def trace_streamed(tracer: Tracer, origins: torch.Tensor, dirs: torch.Tensor,
                   width: int | None = None):
    """Closest hits by the stackless skip-pointer walk with one cursor per
    packet of STREAMED_PACKET consecutive rays; the node under the cursor
    and both nodes it can lead to are read by broadcast loads, with no
    window and no shared memory (replaces pallas_ray_trace_streamed,
    pallas_intersect.py:371). Preorder trees only. Returns (t, u, v, face)
    per ray.

    width picks another instantiated packet width (PACKET_WIDTHS) so that
    a measurement can hold and time each one; the hits do not depend on
    it, and the dispatch does not pass it."""
    if origins.device.type == "cpu":
        return trace_streamed_plain(
            tracer, origins, dirs,
            width=STREAMED_PACKET if width is None else width)
    _need_preorder("trace_streamed", tracer)
    leaf_rows = _leaf_rows(tracer)
    return _launch(
        trace_streamed, {"nodes": tracer.nodes, "leaf rows": leaf_rows},
        (tracer.nodes.data_ptr(), tracer.n_nodes, leaf_rows.data_ptr(),
         leaf_rows.shape[0], tracer.leaf_size), origins, dirs, width=width)


def trace_ordered(tracer: Tracer, origins: torch.Tensor, dirs: torch.Tensor):
    """Closest hits by the near-first walk with pop-time pruning of a
    preorder tree with any leaf_size (replaces pallas_ray_trace_ordered,
    pallas_intersect.py:579). One ray a thread, the kernel walks the pair
    records (pair_records: both children's boxes in one 64-byte read),
    keeps the near child in a register, pushes the far one with its entry
    distance and prunes a popped entry by comparing that distance with the
    best hit; a warp's lanes step through records until each reaches a
    leaf, then fold their leaves (from tris) together. Each ray's visiting
    order and hits are trace_ordered_plain's node walk's, bit for bit.
    Returns (t, u, v, face) per ray."""
    if origins.device.type == "cpu":
        return trace_ordered_plain(tracer, origins, dirs)
    _need_preorder("trace_ordered", tracer)
    # a tree whose root is a leaf has no records: the kernel reads none
    pairs = pair_records(tracer) if tracer.n_nodes > 1 else tracer.nodes
    n_pairs = pairs.shape[0] if tracer.n_nodes > 1 else 0
    return _launch(
        trace_ordered, {"nodes": tracer.nodes, "pairs": pairs,
                        "tris": tracer.tris},
        (tracer.nodes.data_ptr(), pairs.data_ptr(), n_pairs,
         tracer.tris.data_ptr(), tracer.tris.shape[0] // tracer.leaf_size,
         tracer.leaf_size,
         _stack_entries("trace_ordered", tracer, walk_stack_depth(tracer))),
        origins, dirs)


def trace_paired(tracer: Tracer, origins: torch.Tensor, dirs: torch.Tensor):
    """Closest hits by the per-ray near-first walk over the paired layout
    (replaces pallas_ray_trace_paired, pallas_intersect.py:782): one ray a
    thread, the near child kept in a register and only the far one
    pushed, the leaf fold unrolled over leaf_size (1-10) and the entered
    leaf children of a step folded in one pass where a lane entered one.
    Preorder trees only. Returns (t, u, v, face) per ray,
    trace_paired_plain's bit for bit."""
    if origins.device.type == "cpu":
        return trace_paired_plain(tracer, origins, dirs)
    pairs, leaves, n_pairs, n_leaf_rows = pack_paired(tracer)
    return _launch(
        trace_paired, {"pairs": pairs, "leaves": leaves},
        (pairs.data_ptr(), n_pairs, leaves.data_ptr(), n_leaf_rows,
         tracer.leaf_size,
         _stack_entries("trace_paired", tracer, walk_stack_depth(tracer))),
        origins, dirs)


def trace_paired_streamed(tracer: Tracer, origins: torch.Tensor,
                          dirs: torch.Tensor, width: int | None = None):
    """Closest hits by the near-first packet walk: one cursor and stack per
    packet of PACKET consecutive rays over the compact paired rows
    (replaces pallas_ray_trace_paired_streamed, pallas_intersect.py:989).
    Preorder trees only. Returns (t, u, v, face) per ray.

    width picks another instantiated packet width (PACKET_WIDTHS) for
    measurements; equal-t ties depend on it (the near child is chosen by
    the packet's mean entry distance), so a launch at `width` is held
    against the plain version at that width. The dispatch does not pass
    it."""
    if origins.device.type == "cpu":
        return trace_paired_streamed_plain(
            tracer, origins, dirs, width=PACKET if width is None else width)
    pairs16, leaf_rows, n_pairs, n_leaf_rows = pack_paired_compact(tracer)
    return _launch(
        trace_paired_streamed, {"pairs16": pairs16, "leaf rows": leaf_rows},
        (pairs16.data_ptr(), n_pairs, leaf_rows.data_ptr(), n_leaf_rows,
         tracer.leaf_size, _stack_entries("trace_paired_streamed", tracer,
                                          auto_stack_depth(tracer))),
        origins, dirs, hint=_WINDOW_HINT.format(tracer.leaf_size),
        width=width)


def trace_dense(tracer: Tracer, origins: torch.Tensor, dirs: torch.Tensor):
    """Closest hits by trace_paired's per-ray walk over the dense layout:
    64-byte pair records, 8 to a row, and 256-byte leaf slots, 2 to a row
    (replaces pallas_ray_trace_dense, pallas_intersect.py:1221). Preorder
    trees with leaf_size <= 5 and an internal root. Returns (t, u, v,
    face) per ray, trace_dense_plain's bit for bit."""
    if origins.device.type == "cpu":
        return trace_dense_plain(tracer, origins, dirs)
    pairs, leaves, n_pairs, n_leaf_rows = pack_dense(tracer)
    return _launch(
        trace_dense, {"dense pairs": pairs, "dense leaves": leaves},
        (pairs.data_ptr(), n_pairs, leaves.data_ptr(), n_leaf_rows,
         tracer.leaf_size,
         _stack_entries("trace_dense", tracer, walk_stack_depth(tracer))),
        origins, dirs)


def trace_dense_streamed(tracer: Tracer, origins: torch.Tensor,
                         dirs: torch.Tensor, width: int | None = None):
    """Closest hits by trace_paired_streamed's packet walk over the dense
    layout: the same 64-byte pair records, leaves in 256-byte slots
    (replaces pallas_ray_trace_dense_streamed, pallas_intersect.py:1437).
    Preorder trees with leaf_size <= 5 and an internal root. Returns
    (t, u, v, face) per ray. width as trace_paired_streamed's."""
    if origins.device.type == "cpu":
        return trace_dense_streamed_plain(
            tracer, origins, dirs, width=PACKET if width is None else width)
    pairs, leaves, n_pairs, n_leaf_rows = pack_dense(tracer)
    return _launch(
        trace_dense_streamed, {"dense pairs": pairs, "dense leaves": leaves},
        (pairs.data_ptr(), n_pairs, leaves.data_ptr(), n_leaf_rows,
         tracer.leaf_size, _stack_entries("trace_dense_streamed", tracer,
                                          auto_stack_depth(tracer))),
        origins, dirs, hint=_WINDOW_HINT.format(tracer.leaf_size),
        width=width)
