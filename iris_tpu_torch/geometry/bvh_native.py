"""ctypes binding for the native C++ binned-SAH BVH builder
(counterpart of iris_tpu/geometry/bvh_native.py).

The source is the repository's csrc/bvh_builder.cpp; the port compiles it
with g++ into its own build directory (iris_tpu_torch/build/libbvh.so) at
first use. A missing toolchain or a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from iris_tpu_torch.native_build import build_shared

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                      "csrc", "bvh_builder.cpp")

_LOCK = threading.Lock()
_LIB = None


def build() -> tuple[str, str]:
    """Compile the builder if needed: (library path, compiler output)."""
    return build_shared(["g++", "-O3", "-fPIC", "-shared", "-std=c++17"],
                        SOURCE, "libbvh.so", timeout=300)


def get_lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build()[0])
            lib.build_bvh_sah.restype = ctypes.c_int
            lib.build_bvh_sah.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
                ctypes.c_float,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
            ]
            _LIB = lib
        return _LIB


def build_sah_arrays(triangles: np.ndarray, leaf_size: int = 4,
                     spatial_alpha: float = -1.0):
    """(F, 3, 3) triangles -> (nodes (N, 8), tris (P, 12)) float32.

    spatial_alpha < 0 (the default, as in the JAX package) builds pure
    binned object SAH; >= 0 admits SBVH spatial splits."""
    lib = get_lib()
    tris = np.ascontiguousarray(triangles, np.float32)
    f = tris.shape[0]
    # spatial splits duplicate references (capped at 1.8x in the builder);
    # leaves pad to a leaf_size multiple, hence the headroom
    ref_cap = 2 * f + 16
    nodes_cap = max(2 * ref_cap + 2, 16)
    tris_cap = (ref_cap + 1) * leaf_size
    nodes = np.empty((nodes_cap, 8), np.float32)
    out_tris = np.empty((tris_cap, 12), np.float32)
    n_nodes = ctypes.c_int64(0)
    n_rows = ctypes.c_int64(0)
    fp = ctypes.POINTER(ctypes.c_float)
    rc = lib.build_bvh_sah(
        tris.ctypes.data_as(fp), ctypes.c_int64(f), ctypes.c_int(leaf_size),
        ctypes.c_float(spatial_alpha),
        nodes.ctypes.data_as(fp), ctypes.c_int64(nodes_cap),
        out_tris.ctypes.data_as(fp), ctypes.c_int64(tris_cap),
        ctypes.byref(n_nodes), ctypes.byref(n_rows),
    )
    if rc != 0:
        raise RuntimeError(f"native SAH builder failed (rc={rc})")
    return nodes[: n_nodes.value].copy(), out_tris[: n_rows.value].copy()
