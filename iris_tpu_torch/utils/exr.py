"""Minimal OpenEXR 2.0 scanline codec in numpy + zlib (counterpart of
iris_tpu/utils/exr.py; files written by either package read equal in the
other, bit for bit).

The image ships no EXR backend (cv2 built without OpenEXR, imageio has no
plugin), but the pipeline's shading caches and AOV outputs are EXR for
reference-artifact parity (bake_shading.py:131, render.py:225). This module
implements the scanline format: float32/half channels, NONE/ZIP/ZIPS
compression (what OpenEXR itself writes by default), and PIZ through the
native codec (utils/exr_native.py), which must build: a PIZ write does not
fall back to ZIP. B44 and tiled files raise.

Format reference: the public OpenEXRFileLayout documentation.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from iris_tpu_torch.utils.exr_native import piz_compress, piz_uncompress

_MAGIC = 20000630
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP, _COMP_PIZ = 0, 1, 2, 3, 4
_BLOCK_LINES = {_COMP_NONE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16,
                _COMP_PIZ: 32}


def _predictor_encode(data: np.ndarray) -> np.ndarray:
    d = data.astype(np.int16)
    out = np.empty_like(d)
    out[0] = d[0]
    out[1:] = (d[1:] - d[:-1] + 128) & 0xFF
    return out.astype(np.uint8)


def _predictor_decode(data: np.ndarray) -> np.ndarray:
    d = data.astype(np.int64)
    d[1:] -= 128
    return (np.cumsum(d) & 0xFF).astype(np.uint8)


def _reorder_split(data: np.ndarray) -> np.ndarray:
    half = (len(data) + 1) // 2
    out = np.empty_like(data)
    out[:half] = data[0::2]
    out[half:] = data[1::2]
    return out


def _reorder_merge(data: np.ndarray) -> np.ndarray:
    half = (len(data) + 1) // 2
    out = np.empty_like(data)
    out[0::2] = data[:half]
    out[1::2] = data[half:]
    return out


def _zip_compress(raw: bytes) -> bytes:
    arr = np.frombuffer(raw, np.uint8).copy()
    enc = _reorder_split(_predictor_encode(arr))
    comp = zlib.compress(enc.tobytes())
    return comp if len(comp) < len(raw) else raw


def _zip_decompress(blob: bytes, expected: int) -> bytes:
    if len(blob) == expected:
        return blob
    dec = np.frombuffer(zlib.decompress(blob), np.uint8).copy()
    return _predictor_decode(_reorder_merge(dec)).tobytes()


def _piz_decompress(blob: bytes, lines: int, width: int,
                    psizes: list[int]) -> bytes:
    """PIZ block -> scanline-interleaved raw bytes, via the native codec
    (csrc/exr_piz.cpp). Channel-major u16 planes are reordered here."""
    sizes = [s // 2 for s in psizes]          # u16 words per pixel
    nx = [width] * len(sizes)
    ny = [lines] * len(sizes)
    n_u16 = sum(width * lines * s for s in sizes)
    planes = piz_uncompress(blob, n_u16, nx, ny, sizes)
    rows = []
    off = 0
    per_ch = []
    for s in sizes:
        per_ch.append(planes[off: off + width * lines * s]
                      .reshape(lines, width * s))
        off += width * lines * s
    for li in range(lines):
        for ch in per_ch:
            rows.append(ch[li].tobytes())
    return b"".join(rows)


def _piz_compress(raw: bytes, lines: int, width: int,
                  psizes: list[int]) -> bytes:
    """Scanline-interleaved raw bytes -> PIZ block."""
    sizes = [s // 2 for s in psizes]
    data = np.frombuffer(raw, np.uint16).reshape(lines, -1)
    per_ch = []
    off = 0
    for s in sizes:
        per_ch.append(data[:, off: off + width * s].reshape(-1))
        off += width * s
    planes = np.concatenate(per_ch)
    return piz_compress(planes, [width] * len(sizes),
                        [lines] * len(sizes), sizes)


def _read_cstr(buf: bytes, off: int) -> tuple[str, int]:
    end = buf.index(b"\0", off)
    return buf[off:end].decode("ascii"), end + 1


def read_exr(path: str) -> np.ndarray:
    """Read an EXR into (H, W, C) float32. Channels ordered R,G,B[,A] when
    present, else alphabetical."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    if version & 0x200:
        raise NotImplementedError(f"tiled EXR not supported: {path}")
    off = 8

    channels = []  # (name, pixel_type)
    compression = _COMP_NONE
    data_window = None
    while True:
        if buf[off] == 0:
            off += 1
            break
        name, off = _read_cstr(buf, off)
        atype, off = _read_cstr(buf, off)
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4
        payload = buf[off : off + size]
        off += size
        if name == "channels":
            p = 0
            while payload[p] != 0:
                cname, p = _read_cstr(payload, p)
                (ptype,) = struct.unpack_from("<i", payload, p)
                channels.append((cname, ptype))
                p += 16  # type(4) + pLinear+fill(4) + xSampling(4) + ySampling(4)
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", payload)

    if compression not in _BLOCK_LINES:
        raise NotImplementedError(
            f"EXR compression {compression} not supported "
            "(NONE/ZIP/ZIPS/PIZ only)"
        )
    x0, y0, x1, y1 = data_window
    width, height = x1 - x0 + 1, y1 - y0 + 1
    channels.sort(key=lambda c: c[0])
    block = _BLOCK_LINES[compression]
    n_blocks = -(-height // block)

    # offset table
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, off)
    psizes = [2 if t == _PT_HALF else 4 for _, t in channels]
    line_bytes = sum(width * s for s in psizes)

    out = {name: np.empty((height, width), np.float32) for name, _ in channels}
    for bi, boff in enumerate(offsets):
        y, dsize = struct.unpack_from("<ii", buf, boff)
        blob = buf[boff + 8 : boff + 8 + dsize]
        lines = min(block, height - (y - y0))
        if compression == _COMP_PIZ and dsize < lines * line_bytes:
            raw = _piz_decompress(blob, lines, width, psizes)
        else:
            raw = _zip_decompress(blob, lines * line_bytes)
        pos = 0
        for li in range(lines):
            row = y - y0 + li
            for (cname, ptype), s in zip(channels, psizes):
                n = width * s
                dt = np.float16 if ptype == _PT_HALF else (
                    np.float32 if ptype == _PT_FLOAT else np.uint32)
                vals = np.frombuffer(raw, dt, width, pos)
                out[cname][row] = vals.astype(np.float32)
                pos += n

    names = [c[0] for c in channels]
    if all(c in names for c in ("R", "G", "B")):
        order = ["R", "G", "B"] + (["A"] if "A" in names else [])
    else:
        order = names
    img = np.stack([out[c] for c in order], axis=-1)
    return img


def write_exr(path: str, img: np.ndarray, half: bool = True,
              compression: str = "zip") -> None:
    """Write (H, W) or (H, W, C<=4) float array as scanline EXR."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    names = {1: ["Y"], 2: ["X", "Y"], 3: ["B", "G", "R"],
             4: ["A", "B", "G", "R"]}[c]
    # channel i of img maps: RGB(A) input order -> alphabetical storage
    src_for = {"R": 0, "G": 1, "B": 2, "A": 3, "Y": 0, "X": 0}
    if c == 2:
        src_for = {"X": 0, "Y": 1}

    comp = {"none": _COMP_NONE, "zip": _COMP_ZIP, "zips": _COMP_ZIPS,
            "piz": _COMP_PIZ}[compression]
    block = _BLOCK_LINES[comp]
    ptype = _PT_HALF if half else _PT_FLOAT
    dt = np.float16 if half else np.float32
    psize = 2 if half else 4

    def attr(name: str, atype: str, payload: bytes) -> bytes:
        return (name.encode() + b"\0" + atype.encode() + b"\0"
                + struct.pack("<i", len(payload)) + payload)

    chpayload = b""
    for n in names:
        chpayload += (n.encode() + b"\0" + struct.pack("<i", ptype)
                      + b"\0\0\0\0" + struct.pack("<ii", 1, 1))
    chpayload += b"\0"

    header = b""
    header += attr("channels", "chlist", chpayload)
    header += attr("compression", "compression", bytes([comp]))
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header += attr("dataWindow", "box2i", box)
    header += attr("displayWindow", "box2i", box)
    header += attr("lineOrder", "lineOrder", b"\0")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    n_blocks = -(-h // block)
    chunks = []
    for bi in range(n_blocks):
        y = bi * block
        lines = min(block, h - y)
        parts = []
        for li in range(lines):
            for n in names:
                parts.append(img[y + li, :, src_for[n]].astype(dt).tobytes())
        raw = b"".join(parts)
        if comp == _COMP_PIZ:
            data = _piz_compress(raw, lines, w, [psize] * len(names))
            if len(data) >= len(raw):
                data = raw          # store-uncompressed rule
        elif comp != _COMP_NONE:
            data = _zip_compress(raw)
        else:
            data = raw
        chunks.append((y, data))

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        f.write(header)
        table_pos = f.tell()
        f.write(b"\0" * 8 * n_blocks)
        offsets = []
        for y, data in chunks:
            offsets.append(f.tell())
            f.write(struct.pack("<ii", y, len(data)))
            f.write(data)
        f.seek(table_pos)
        f.write(struct.pack(f"<{n_blocks}Q", *offsets))
