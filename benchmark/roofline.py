"""The least time a unit's closest-hit queries could take on the card,
counted the same whatever kernel or tree layout the program uses:

- bytes: each ray read once (origin and direction, 24 B), each hit
  written once (t, u, v and face, 16 B), the scene's triangles read once a
  call (three float32 vertices, 36 B a face);
- operations: the slab and triangle tests (SLAB_OPS and TRI_OPS float32
  operations) of the benchmark's own per-ray walk (benchmark/bvh.py) over
  the same rays;
- peaks: the published H100 SXM rates, 3.35 TB/s and 67 TFLOP/s in
  float32 outside the tensor cores.
"""

from __future__ import annotations

from benchmark import bvh

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = 67e12
RAY_BYTES, HIT_BYTES, FACE_BYTES = 24, 16, 36


def least_time(rays: float, calls: float, faces: int, slab: float,
               tri: float) -> tuple[float, str, float, float]:
    """(seconds, what bounds it, bytes, operations) of `rays` closest hits
    in `calls` calls over `faces` triangles, whose walk made `slab` and
    `tri` tests."""
    nbytes = rays * (RAY_BYTES + HIT_BYTES) + calls * faces * FACE_BYTES
    ops = slab * bvh.SLAB_OPS + tri * bvh.TRI_OPS
    t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_FLOPS
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), \
        nbytes, ops


def share(unit: dict, traversal_ms: float | None) -> float | None:
    """Percent of the unit's measured traversal time that the least time
    is; None where either side is missing."""
    if not unit or not traversal_ms:
        return None
    t, _, _, _ = least_time(unit["rays"], unit["calls"], unit["faces"],
                            unit["slab"], unit["tri"])
    return 100.0 * t / (traversal_ms / 1e3)
