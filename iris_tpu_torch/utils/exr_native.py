"""ctypes binding for the native PIZ codec (counterpart of
iris_tpu/utils/exr_native.py).

The source is the repository's csrc/exr_piz.cpp, read as it is; the port
compiles it with g++ into its own build directory
(iris_tpu_torch/build/libexrpiz.so) at first use. A missing toolchain or a
failed build raises: nothing falls back to ZIP.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from iris_tpu_torch.native_build import build_shared

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                      "csrc", "exr_piz.cpp")

_LOCK = threading.Lock()
_LIB = None

_U8P = ctypes.POINTER(ctypes.c_uint8)
_U16P = ctypes.POINTER(ctypes.c_uint16)
_I32P = ctypes.POINTER(ctypes.c_int32)


def build() -> tuple[str, str]:
    """Compile the codec if needed: (library path, compiler output)."""
    return build_shared(["g++", "-O3", "-fPIC", "-shared", "-std=c++17"],
                        SOURCE, "libexrpiz.so", timeout=120)


def get_lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build()[0])
            lib.piz_compress.restype = ctypes.c_long
            lib.piz_compress.argtypes = [_U16P, ctypes.c_long, _U8P,
                                         ctypes.c_long, ctypes.c_int, _I32P,
                                         _I32P, _I32P]
            lib.piz_uncompress.restype = ctypes.c_int
            lib.piz_uncompress.argtypes = [_U8P, ctypes.c_long, _U16P,
                                           ctypes.c_long, ctypes.c_int, _I32P,
                                           _I32P, _I32P]
            _LIB = lib
        return _LIB


def _chan_arrays(nx, ny, size):
    arrs = [np.ascontiguousarray(a, np.int32) for a in (nx, ny, size)]
    return arrs, [a.ctypes.data_as(_I32P) for a in arrs]


def piz_compress(planes: np.ndarray, nx, ny, size) -> bytes:
    """planes: flat uint16 channel-major block data -> PIZ bytes."""
    lib = get_lib()
    planes = np.ascontiguousarray(planes, np.uint16)
    n = planes.size
    cap = 6 + (1 << 13) + 24 + n * 3 + 8192
    out = np.empty(cap, np.uint8)
    arrs, ptrs = _chan_arrays(nx, ny, size)
    got = lib.piz_compress(planes.ctypes.data_as(_U16P), ctypes.c_long(n),
                           out.ctypes.data_as(_U8P), ctypes.c_long(cap),
                           ctypes.c_int(len(arrs[0])), *ptrs)
    if got < 0:
        raise ValueError(f"PIZ encode failed ({n} words, "
                         f"{len(arrs[0])} channels)")
    return out[:got].tobytes()


def piz_uncompress(blob: bytes, n_u16: int, nx, ny, size) -> np.ndarray:
    """PIZ bytes -> flat uint16 channel-major block data."""
    lib = get_lib()
    src = np.frombuffer(blob, np.uint8)
    out = np.empty(n_u16, np.uint16)
    arrs, ptrs = _chan_arrays(nx, ny, size)
    rc = lib.piz_uncompress(src.ctypes.data_as(_U8P),
                            ctypes.c_long(len(blob)),
                            out.ctypes.data_as(_U16P), ctypes.c_long(n_u16),
                            ctypes.c_int(len(arrs[0])), *ptrs)
    if rc != 0:
        raise ValueError(f"PIZ decode failed (code {rc})")
    return out
