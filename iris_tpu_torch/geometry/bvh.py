"""BVH build (host) + the flattened device arrays the traversal kernels
read (counterpart of iris_tpu/geometry/bvh.py).

Layout contract, unchanged from the JAX package (bvh.py:40-64):

- nodes (N, 8) f32 = [min.xyz, max.xyz, skip, desc]. skip is the next
  1-based node in preorder after this subtree (0 = walk done). desc >= 1:
  internal, the 1-based first child; desc <= 0: leaf, -desc is its first
  padded triangle row (leaf_size consecutive rows are tested).
- tris (P, 12) f32 = [v0, e1, e2, face_id, pad, pad]; padding rows carry
  face_id = -1 and never report a hit.

SAH (the native C++ builder, "preorder" layout) is the default. The
vectorized Morton builder ("heap" layout) runs only when asked for with
method="morton": the JAX package's silent fallback would change the layout
and with it which traversal kernel runs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from iris_tpu_torch.device import resolve_device
from iris_tpu_torch.utils.profiling import spanned

BIG = np.float32(3e38)


@dataclass(frozen=True)
class TraversalPolicy:
    """Which traversal kernel a tree may go to: the dials of the JAX
    package's _pallas_mode (iris_tpu/geometry/intersect.py:383-466), where
    they are environment variables read at every call (IRIS_TPU_PAIRED,
    IRIS_TPU_DENSE, IRIS_TPU_PAIRED_STREAMED, IRIS_TPU_DENSE_STREAMED), as
    explicit values carried on the Tracer. geometry.intersect.kernel_for
    reads them; the defaults are the JAX package's.

    paired, dense: "auto" (by the size gates), True (wherever the layout
    takes the tree) or False (never). paired_streamed: False sends trees
    past the paired gate on to the dense, resident and plain streamed
    kernels. dense_streamed: True opts into the dense packet walk past the
    resident gate."""

    paired: str | bool = "auto"
    dense: str | bool = "auto"
    paired_streamed: bool = True
    dense_streamed: bool = False

    def __post_init__(self):
        for name in ("paired", "dense"):
            if getattr(self, name) not in ("auto", True, False):
                raise ValueError(f"TraversalPolicy.{name} must be 'auto', "
                                 f"True or False, got {getattr(self, name)!r}")


@dataclass
class Tracer:
    """Flattened BVH + triangle soup on one device."""

    nodes: torch.Tensor         # (N, 8) f32: min.xyz, max.xyz, skip, desc
    tris: torch.Tensor          # (P, 12) f32: v0, e1, e2, face_id, pad
    face_normals: torch.Tensor  # (F, 3) f32 unit geometric normals by face
    n_nodes: int
    leaf_size: int
    n_faces: int                # original face count
    # "preorder" (SAH: child = cur+1, indices increase along any walk) or
    # "heap" (Morton: node b's children are 2b/2b+1)
    layout: str = "heap"
    # maximum node depth (root = 0); sizes the paired walk's stack
    depth: int = 0
    # paired-layout re-pack (cuda_intersect.pack_paired), built on demand
    paired: tuple | None = field(default=None, repr=False, compare=False)
    # the 16 useful floats of each pair row, (n_pairs, 16)
    # (cuda_intersect.pack_paired_compact), built on demand
    pairs16: torch.Tensor | None = field(default=None, repr=False,
                                         compare=False)
    # dense-layout re-pack (cuda_intersect.pack_dense), built on demand
    dense: tuple | None = field(default=None, repr=False, compare=False)
    # which kernels geometry.intersect.kernel_for may choose; set it with
    # build_bvh(..., policy=) or dataclasses.replace(tracer, policy=...)
    policy: TraversalPolicy = TraversalPolicy()


def _expand_bits(x: np.ndarray) -> np.ndarray:
    """Spread 21 bits of x so they occupy every 3rd bit (Morton helper)."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def morton3d(points01: np.ndarray) -> np.ndarray:
    """63-bit Morton codes for points normalized to [0,1]^3."""
    q = np.clip(points01 * (1 << 21), 0, (1 << 21) - 1).astype(np.uint64)
    return (_expand_bits(q[:, 0])
            | (_expand_bits(q[:, 1]) << np.uint64(1))
            | (_expand_bits(q[:, 2]) << np.uint64(2)))


def _skip_pointers(n_nodes: int) -> np.ndarray:
    """1-based preorder skip pointer for every node of a complete binary
    tree: strip trailing 1-bits of b; 0 closes the walk, else stripped+1."""
    b = np.arange(1, n_nodes + 1, dtype=np.uint64)
    stripped = b.copy()
    ones = (stripped & np.uint64(1)).astype(bool)
    while ones.any():
        stripped[ones] >>= np.uint64(1)
        ones = (stripped & np.uint64(1)).astype(bool) & (stripped > 0)
    out = np.where(stripped == 0, 0, stripped + 1).astype(np.int64)
    return out.astype(np.int32)


def preorder_max_depth(nodes_np: np.ndarray) -> int:
    """Max node depth (root = 0) of a preorder tree: node j's subtree spans
    rows [j, skip0_j), so depth[i] = #{j < i : skip0_j > i}."""
    n = nodes_np.shape[0]
    if n <= 1:
        return 0
    skip = nodes_np[:, 6].astype(np.int64)
    skip0 = np.where(skip <= 0, n, skip - 1)
    idx = np.arange(n, dtype=np.int64)
    skip0 = np.maximum(skip0, idx + 1)
    delta = np.zeros(n + 1, np.int64)
    np.add.at(delta, idx + 1, 1)
    np.add.at(delta, skip0, -1)
    return int(np.cumsum(delta)[:n].max())


def _face_normals(triangles: np.ndarray) -> np.ndarray:
    cr = np.cross(triangles[:, 1] - triangles[:, 0],
                  triangles[:, 2] - triangles[:, 0])
    fn = cr / np.maximum(np.linalg.norm(cr, axis=-1, keepdims=True), 1e-20)
    return fn.astype(np.float32)


def _morton_arrays(triangles: np.ndarray, leaf_size: int):
    """Complete-tree LBVH over Morton-sorted faces: (nodes, tris, depth)."""
    n_faces = triangles.shape[0]
    centroid = triangles.mean(axis=1)
    lo, hi = centroid.min(0), centroid.max(0)
    extent = np.maximum(hi - lo, 1e-9)
    order = np.argsort(morton3d((centroid - lo) / extent), kind="stable")
    tris = triangles[order]

    n_leaves_needed = -(-n_faces // leaf_size)
    depth = max(int(np.ceil(np.log2(max(n_leaves_needed, 1)))), 0)
    n_leaves = 1 << depth
    n_nodes = 2 * n_leaves - 1
    first_leaf = n_leaves - 1
    pad_to = n_leaves * leaf_size

    v0 = np.zeros((pad_to, 3), np.float32)
    e1 = np.zeros((pad_to, 3), np.float32)
    e2 = np.zeros((pad_to, 3), np.float32)
    tri_id = np.full((pad_to,), -1, np.int32)
    v0[:n_faces] = tris[:, 0]
    e1[:n_faces] = tris[:, 1] - tris[:, 0]
    e2[:n_faces] = tris[:, 2] - tris[:, 0]
    tri_id[:n_faces] = order.astype(np.int32)

    # leaf AABBs (empty leaves get inverted boxes that never hit)
    tmin = np.minimum(tris.min(1), BIG)
    tmax = tris.max(1)
    flat_min = np.full((n_leaves * leaf_size, 3), BIG, np.float32)
    flat_max = np.full((n_leaves * leaf_size, 3), -BIG, np.float32)
    flat_min[:n_faces] = tmin
    flat_max[:n_faces] = tmax
    leaf_min = flat_min.reshape(n_leaves, leaf_size, 3).min(1)
    leaf_max = flat_max.reshape(n_leaves, leaf_size, 3).max(1)

    node_min = np.full((n_nodes, 3), BIG, np.float32)
    node_max = np.full((n_nodes, 3), -BIG, np.float32)
    node_min[first_leaf:] = leaf_min
    node_max[first_leaf:] = leaf_max
    for level in range(depth - 1, -1, -1):      # bottom-up union per level
        s = (1 << level) - 1
        e = (1 << (level + 1)) - 1
        l, r = 2 * np.arange(s, e) + 1, 2 * np.arange(s, e) + 2
        node_min[s:e] = np.minimum(node_min[l], node_min[r])
        node_max[s:e] = np.maximum(node_max[l], node_max[r])

    skip = _skip_pointers(n_nodes).astype(np.float32)
    idx0 = np.arange(n_nodes)
    desc = np.where(idx0 >= first_leaf,
                    -((idx0 - first_leaf) * leaf_size).astype(np.float32),
                    (2 * (idx0 + 1)).astype(np.float32))
    nodes = np.concatenate([node_min, node_max, skip[:, None],
                            desc[:, None]], axis=1)
    tris_packed = np.concatenate([
        v0, e1, e2, tri_id[:, None].astype(np.float32),
        np.zeros((pad_to, 2), np.float32)], axis=1)
    return nodes, tris_packed, depth


@spanned("bvh.build")
def build_bvh(triangles: np.ndarray, leaf_size: int = 4, method: str = "sah",
              device=None, policy: TraversalPolicy | None = None) -> Tracer:
    """Build the flat BVH from (F, 3, 3) triangle vertices.

    method: "sah" (default, native C++ builder, preorder layout; raises if
    it cannot be built) or "morton" (vectorized complete tree, heap
    layout). policy: the tracer's TraversalPolicy (default: the JAX
    package's defaults). The span bvh.build."""
    from iris_tpu_torch.geometry.bvh_native import build_sah_arrays

    dev = resolve_device(device)
    triangles = np.asarray(triangles, dtype=np.float32)
    n_faces = triangles.shape[0]
    if n_faces == 0:
        raise ValueError("empty mesh")
    if method == "sah":
        nodes, tris = build_sah_arrays(triangles, leaf_size)
        layout, depth = "preorder", preorder_max_depth(nodes)
    elif method == "morton":
        nodes, tris, depth = _morton_arrays(triangles, leaf_size)
        layout = "heap"
    else:
        raise ValueError(f"unknown BVH method {method!r}")
    return Tracer(
        nodes=torch.from_numpy(nodes).to(dev),
        tris=torch.from_numpy(tris).to(dev),
        face_normals=torch.from_numpy(_face_normals(triangles)).to(dev),
        n_nodes=int(nodes.shape[0]),
        leaf_size=leaf_size,
        n_faces=n_faces,
        layout=layout,
        depth=depth,
        policy=policy or TraversalPolicy(),
    )


def build_tracer(mesh, device=None) -> Tracer:
    """Convenience: mesh -> Tracer on `device` (default the card)."""
    return build_bvh(mesh.triangles(), device=device)
