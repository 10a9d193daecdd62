"""The hash grid's exact 8-corner encode on Hopper: the kernel of
csrc/hashgrid.cu, its wrapper and its plain version.

models/hashgrid.py's hashgrid_encode launches the kernel for every exact
forward on the card, and on the CPU runs its plain lookups. encode_plain
computes what encode computes, from the same arguments, with those plain
lookups (models/hashgrid.py _cells, _corners, _lookup_words, _lookup_impl,
_row_lookup), on any device: the card's tests and chip_smoke.py hold the
kernel to it bit for bit.

encode() takes the points, the table as the mode reads it (the packed
mode's words, which pack() makes in one pass) and the grid's level
constants on the card, launches one kernel on the current stream and
returns the features in the encode's final layout: (B, F*L) feature-major
in the packed and flat modes, (B, L*F) level-major in the row modes. Both
raise on an input they do not take and on a failed launch: nothing falls
back. Every launch counts 1 on the program counter hashgrid.encode_kernel
(utils/profiling.count: a launch captured into a CUDA graph counts at each
replay of the graph), and the encode and pack kernels count their own
launches on the card (launch_counts()).

The kernel is built at first use with nvcc for sm_90a into
iris_tpu_torch/build/ (plain C ABI, loaded with ctypes).
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from iris_tpu_torch.native_build import build_shared, nvcc
from iris_tpu_torch.utils.profiling import count

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "csrc", "hashgrid.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]
# the kernel's modes (csrc/hashgrid.cu Mode): how the table is read
MODES = {"packed": 0, "flat": 1, "rows": 2, "rows_bf16": 3}
# the features a lane of the row kernel reads (csrc/hashgrid.cu kRowVec)
ROW_VEC = 4

_LOCK = threading.Lock()
_LIB = None


def build() -> tuple[str, str]:
    """Compile csrc/hashgrid.cu if needed: (library path, nvcc output, with
    ptxas' register and spill report; "" when the library was already up
    to date)."""
    return build_shared([nvcc("the hash-grid encode")] + NVCC_FLAGS, SOURCE,
                        "libhashgrid.so")


def get_lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build()[0])
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.iris_hashgrid_encode.restype = i32
            lib.iris_hashgrid_encode.argtypes = [
                vp, i32, vp, i32, i32, i32, i32, vp, vp, vp, vp, vp]
            lib.iris_hashgrid_pack.restype = i32
            lib.iris_hashgrid_pack.argtypes = [vp, ctypes.c_longlong, vp, vp]
            lib.iris_hashgrid_launches.restype = i32
            lib.iris_hashgrid_launches.argtypes = [
                ctypes.POINTER(ctypes.c_ulonglong)]
            lib.iris_hashgrid_reset_launches.restype = i32
            lib.iris_hashgrid_reset_launches.argtypes = []
            _LIB = lib
        return _LIB


def _on_card(device):
    return torch.cuda.device(device if device is not None
                             else torch.cuda.current_device())


def launch_counts(device=None) -> dict[str, int]:
    """{"encode": the encode kernel's launches, "pack": pack's} on `device`
    (the current card by default) since the library was loaded or last
    reset, as the kernels counted them on the card, replays included.
    Waits for the card to finish its work. Zeros in a process that has
    launched neither."""
    if _LIB is None:
        return {"encode": 0, "pack": 0}
    out = (ctypes.c_ulonglong * 2)()
    with _on_card(device):
        rc = _LIB.iris_hashgrid_launches(out)
    if rc != 0:
        raise RuntimeError(f"reading the encode's launches: CUDA error {rc}")
    return {"encode": out[0], "pack": out[1]}


def reset_launch_counts(device=None) -> None:
    """Zero the launch counts on `device` (the current card by default),
    once it has finished its work."""
    if _LIB is None:
        return
    with _on_card(device):
        rc = _LIB.iris_hashgrid_reset_launches()
    if rc != 0:
        raise RuntimeError(f"resetting the encode's launches: CUDA error "
                           f"{rc}")


def _need(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"hashgrid encode kernel: {what}")


def pack(table: torch.Tensor, block: int) -> torch.Tensor:
    """hashgrid._pack_bf16 on the card, in one pass: the (block,) int32
    words of a float32 table of 2 * block entries, entry i's bfloat16 in
    word i's low half and entry block + i's in its high half."""
    _need(table.device.type == "cuda", f"table on {table.device}, not on "
          "the card")
    _need(table.dtype == torch.float32 and table.dim() == 1
          and table.is_contiguous() and table.shape[0] == 2 * block > 0,
          f"packing needs a contiguous float32 ({2 * block},) table, got "
          f"{table.dtype} {tuple(table.shape)}")
    words = torch.empty(block, dtype=torch.int32, device=table.device)
    with torch.cuda.device(table.device):
        rc = get_lib().iris_hashgrid_pack(
            table.data_ptr(), block, words.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hashgrid pack kernel launch failed: CUDA error "
                           f"{rc}")
    return words


def encode(table: torch.Tensor, x: torch.Tensor, levels, mode: str,
           n_levels: int, n_features: int,
           log2_table_size: int) -> torch.Tensor:
    """The exact encode of points x (B, 3) float32 on the card.

    table: mode "packed", the (L*T,) int32 words of pack (or
    hashgrid._pack_bf16, the same bits);
    "flat", the (F*L*T,) float32 table; "rows" and "rows_bf16", the (L*T,
    F) float32 rows ("rows_bf16" reads each value rounded to bfloat16).
    levels: the grid's (resolution float32, resolution + 1 int64,
    dense-level mask bool), each (L,), as hashgrid._level_constants gives
    them. Returns float32 (B, F*L) (packed, flat) or (B, L*F) (rows)."""
    _need(mode in MODES, f"mode {mode!r} is not one of {tuple(MODES)}")
    dev = x.device
    _need(dev.type == "cuda", f"points on {dev}, not on the card")
    _need(x.dtype == torch.float32 and x.dim() == 2 and x.shape[1] == 3
          and x.is_contiguous(),
          f"points must be contiguous float32 (B, 3), got {x.dtype} "
          f"{tuple(x.shape)}")
    t = 1 << log2_table_size
    lt = n_levels * t
    _need(0 < log2_table_size <= 30 and 0 < n_levels and lt < 2 ** 31,
          f"{n_levels} levels of 2^{log2_table_size} entries")
    rows = mode.startswith("rows")
    _need(not rows or (n_features > 0 and n_features % ROW_VEC == 0),
          f"the row modes read {ROW_VEC} features a lane, not a row of "
          f"{n_features}")
    if mode == "packed":
        _need(n_features == 2, "the packed mode reads two features")
        want = (torch.int32, (lt,))
    elif mode == "flat":
        want = (torch.float32, (n_features * lt,))
    else:
        want = (torch.float32, (lt, n_features))
    _need(table.device == dev, f"table on {table.device}, points on {dev}")
    _need((table.dtype, tuple(table.shape)) == want and
          table.is_contiguous(),
          f"a {mode} table must be contiguous {want[0]} {want[1]}, got "
          f"{table.dtype} {tuple(table.shape)}")
    _need(not rows or table.data_ptr() % 16 == 0,
          "the rows are not 16-byte aligned")
    res, res_u, dense = levels
    for name, a, dtype in (("resolutions", res, torch.float32),
                           ("resolutions + 1", res_u, torch.int64),
                           ("dense mask", dense, torch.bool)):
        _need(a.device == dev and a.dtype == dtype
              and tuple(a.shape) == (n_levels,) and a.is_contiguous(),
              f"{name} must be contiguous {dtype} ({n_levels},) on {dev}")
    b = x.shape[0]
    _need(b * n_levels * n_features < 2 ** 31,
          f"{b} points are too many for one launch")
    out = torch.empty((b, n_levels * n_features), dtype=torch.float32,
                      device=dev)
    if b == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = get_lib().iris_hashgrid_encode(
            x.data_ptr(), b, table.data_ptr(), MODES[mode], n_levels,
            n_features, log2_table_size, res.data_ptr(), res_u.data_ptr(),
            dense.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"hashgrid encode kernel launch failed: CUDA "
                           f"error {rc}")
    count("hashgrid.encode_kernel", 1)
    return out


def encode_plain(table: torch.Tensor, x: torch.Tensor, levels, mode: str,
                 n_levels: int, n_features: int,
                 log2_table_size: int) -> torch.Tensor:
    """What encode computes, from the same arguments, by the plain
    lookups, on any device."""
    from iris_tpu_torch.models import hashgrid as H

    res, res_u, dense = levels
    t = 1 << log2_table_size
    b = x.shape[0]
    idxs, weights = H._corners(*H._cells(
        x, res, res_u, dense, torch.arange(n_levels, device=x.device), t,
        n_levels))
    if mode.startswith("rows"):
        gdtype = "bfloat16" if mode == "rows_bf16" else None
        return H._row_lookup(table, idxs, weights, gdtype).reshape(
            b, n_levels * n_features)
    feats = (H._lookup_words(table, idxs, weights) if mode == "packed"
             else H._lookup_impl(table, idxs, weights, n_features,
                                 n_levels * t))
    return feats.reshape(n_features, b, n_levels).permute(1, 0, 2).reshape(
        b, n_features * n_levels)
