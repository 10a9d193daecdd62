"""Ray-mesh intersection: the single geometry choke point (counterpart of
iris_tpu/geometry/intersect.py; reference utils/path_tracing.py:17-48).

ray_intersect returns (positions, normals, uvs, idx, valid) with normals
unit length and flipped toward the ray origin, idx == -1 for misses. The
traversal itself carries no gradients.

Which traversal runs: kernel_for, the port's replacement for _pallas_mode
(intersect.py:383) and the kernel choice of ray_intersect (:501-527); the
table is in geometry/cuda_intersect.py. On a CUDA tensor every call
launches that kernel; on a CPU tensor the same choice takes the kernel's
plain version.
"""

from __future__ import annotations

import torch

from iris_tpu_torch.core.vecmath import double_sided, normalize
from iris_tpu_torch.geometry import cuda_intersect as ci
from iris_tpu_torch.geometry.bvh import Tracer, TraversalPolicy
from iris_tpu_torch.utils.profiling import spanned

__all__ = ["TraversalPolicy", "traversal_mode", "kernel_for", "ray_trace",
           "spatial_sort_perm", "ray_intersect", "ray_intersect_brute"]

T_MISS = ci.T_MISS
_MT_EPS = ci._MT_EPS


def traversal_mode(tracer: Tracer) -> str | None:
    """_pallas_mode (intersect.py:383-466), line by line, with the
    environment dials read from tracer.policy and the VMEM gates from
    cuda_intersect's constants (read at every call).

    Two things do not carry over: IRIS_TPU_NO_PALLAS and the
    n_rays < 8192 escape to the XLA walk (:393-396); on the card every
    call launches a kernel, whatever its size."""
    pol = tracer.policy
    if pol.dense is True and ci.dense_available(tracer):          # :412
        return "dense"
    if pol.paired is not False and ci.paired_available(tracer):   # :414
        if (pol.paired is True or tracer.n_faces >= 5000
                or not ci.resident_available(tracer)):            # :421
            return "paired"
    if (not ci.paired_available(tracer) and pol.paired_streamed
            and ci.paired_streamed_available(tracer)):            # :436
        return "paired_streamed"
    if pol.dense is not False and ci.dense_available(tracer):     # :440
        if not ci.paired_available(tracer):                       # :448
            return "dense"
    if ci.resident_available(tracer):                             # :450
        return "resident"
    if ci.streamable(tracer):                                     # :452
        if pol.dense_streamed and ci.dense_streamed_available(tracer):
            return "dense_streamed"                               # :459
        if pol.paired_streamed and ci.paired_streamed_available(tracer):
            return "paired_streamed"                              # :462
        return "streamed"                                         # :465
    return None                                                   # :466


def kernel_for(tracer: Tracer):
    """The traversal wrapper ray_intersect sends this tree to: the mode of
    traversal_mode mapped as ray_intersect maps it (intersect.py:501-527).

    With the default TraversalPolicy: < 5000 faces or a heap (Morton) tree
    -> trace_union; a preorder tree with >= 5000 faces -> trace_paired
    inside the paired gate, trace_paired_streamed past it (the 102K-face
    scene), trace_ordered when its leaf row is too wide for the paired
    layout (leaf_size > 10).

    Where the JAX package has no kernel the port keeps one: a heap tree
    past the resident gate (mode None, the XLA walk there) walks
    trace_union, which takes any layout; and a preorder tree past that
    gate whose leaf row is wider than 128 floats, where
    pallas_ray_trace_streamed asserts (pallas_intersect.py:386), keeps
    trace_ordered."""
    mode = traversal_mode(tracer)
    by_mode = {"dense_streamed": ci.trace_dense_streamed,
               "paired_streamed": ci.trace_paired_streamed,
               "dense": ci.trace_dense, "paired": ci.trace_paired}
    if mode in by_mode:
        return by_mode[mode]
    big_preorder = tracer.n_faces >= 5000 and tracer.layout == "preorder"
    if mode == "streamed":
        return (ci.trace_streamed if tracer.leaf_size * 12 <= 128
                else ci.trace_ordered)
    if mode == "resident" and big_preorder:                       # :516
        return ci.trace_ordered
    return ci.trace_union


def ray_trace(tracer: Tracer, origins: torch.Tensor, dirs: torch.Tensor):
    """Closest hit per ray by the dispatched kernel: (t, u, v, face)."""
    origins = origins.detach().float().contiguous()
    dirs = dirs.detach().float().contiguous()
    return kernel_for(tracer)(tracer, origins, dirs)


def _spread8(v: torch.Tensor) -> torch.Tensor:
    """Interleave the low 8 bits of v into every 3rd bit (Morton spread);
    int64 arithmetic, equal to the JAX package's uint32 version."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def spatial_sort_perm(tracer: Tracer, xs: torch.Tensor, ds: torch.Tensor
                      ) -> torch.Tensor:
    """Ray-coherence permutation (intersect.py:362-380): direction octant
    (3 bits) then an 8-bit-per-axis origin Morton code. Secondary rays
    arrive scrambled; sorted, neighbouring threads walk similar paths."""
    lo = tracer.nodes[0, 0:3]
    hi = tracer.nodes[0, 3:6]
    key = torch.zeros(xs.shape[0], dtype=torch.int64, device=xs.device)
    octant = torch.zeros_like(key)
    for c in range(3):
        o = torch.clamp((xs[:, c] - lo[c])
                        / torch.clamp(hi[c] - lo[c], min=1e-9), 0.0, 1.0)
        key = key | (_spread8((o * 255.0).to(torch.int64)) << c)
        octant = octant | ((ds[:, c] > 0).to(torch.int64) << c)
    return torch.argsort((octant << 24) | key, stable=True)


@spanned("geometry.intersect")
def ray_intersect(tracer: Tracer, xs: torch.Tensor, ds: torch.Tensor,
                  sort: bool = False):
    """Reference-parity intersection (utils/path_tracing.py:17-48).

    Args:
        xs: (B, 3) ray origins.  ds: (B, 3) ray directions.
        sort: hint that the rays are spatially incoherent (secondary /
            bounce rays); big trees (>= 5000 faces) then trace them in
            spatial_sort_perm order, as the JAX package does (:489).
    Returns:
        positions (B,3), normals (B,3) unit & viewer-facing, uvs (B,2),
        idx (B,) original face index (-1 = miss), valid (B,) bool.
    The span geometry.intersect.
    """
    perm = None
    if sort and tracer.n_faces >= 5000:
        perm = spatial_sort_perm(tracer, xs, ds)
        xs_t, ds_t = xs[perm], ds[perm]
    else:
        xs_t, ds_t = xs, ds
    t, u, v, face = ray_trace(tracer, xs_t, ds_t)
    if perm is not None:
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(perm.shape[0], device=perm.device)
        t, u, v, face = t[inv], u[inv], v[inv], face[inv]
    face = face.to(torch.int64)
    valid = face >= 0
    n = tracer.face_normals[torch.clamp(face, 0,
                                        tracer.face_normals.shape[0] - 1)]
    n = double_sided(-ds, n)
    vm = valid[:, None]
    n = torch.where(vm, n, 0.0)
    pos = torch.where(vm, xs + t[:, None] * ds, 0.0)
    uv = torch.where(vm, torch.stack([u, v], -1), 0.0)
    idx = torch.where(valid, face, -1)
    return pos, n, uv, idx, valid


def ray_intersect_brute(triangles: torch.Tensor, xs: torch.Tensor,
                        ds: torch.Tensor):
    """O(B*F) reference intersector for tests: triangles (F, 3, 3)."""
    v0 = triangles[:, 0]
    e1 = triangles[:, 1] - triangles[:, 0]
    e2 = triangles[:, 2] - triangles[:, 0]
    o, d = xs[:, None, :], ds[:, None, :]
    pvec = torch.linalg.cross(d.expand(-1, e2.shape[0], -1),
                              e2[None].expand(d.shape[0], -1, -1), dim=-1)
    det = torch.sum(e1[None] * pvec, -1)
    ok_det = torch.abs(det) > _MT_EPS
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    tvec = o - v0[None]
    u = torch.sum(tvec * pvec, -1) * inv_det
    qvec = torch.linalg.cross(tvec, e1[None].expand(d.shape[0], -1, -1),
                              dim=-1)
    v = torch.sum(d * qvec, -1) * inv_det
    t = torch.sum(e2[None] * qvec, -1) * inv_det
    hit = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    t = torch.where(hit, t, T_MISS)
    k = torch.argmin(t, dim=-1)
    t_k = torch.gather(t, 1, k[:, None])[:, 0]
    valid = torch.gather(hit, 1, k[:, None])[:, 0]
    u_k = torch.gather(u, 1, k[:, None])[:, 0]
    v_k = torch.gather(v, 1, k[:, None])[:, 0]
    n = normalize(torch.linalg.cross(e1, e2, dim=-1))[k]
    n = double_sided(-ds, n)
    vm = valid[:, None]
    n = torch.where(vm, n, 0.0)
    pos = torch.where(vm, xs + t_k[:, None] * ds, 0.0)
    idx = torch.where(valid, k, -1)
    uv = torch.where(vm, torch.stack([u_k, v_k], -1), 0.0)
    return pos, n, uv, idx, valid
