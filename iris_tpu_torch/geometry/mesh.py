"""Triangle mesh container + OBJ/PLY loaders (counterpart of
iris_tpu/geometry/mesh.py; pure numpy, no trimesh).

The reference delegates mesh loading to mitsuba.load_dict
(train_brdf_crf.py:60-66) and trimesh (extract_emitter_ldr.py:73); this
module provides the equivalent: positions + faces, with derived per-face
geometry used by emitters and the tracer. Host-side, as in the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class Mesh:
    vertices: np.ndarray  # (V, 3) float32
    faces: np.ndarray     # (F, 3) int32

    @property
    def n_faces(self) -> int:
        return int(self.faces.shape[0])

    def triangles(self) -> np.ndarray:
        """(F, 3, 3) triangle vertex positions."""
        return self.vertices[self.faces]

    def face_normals_areas(self) -> tuple[np.ndarray, np.ndarray]:
        """Unnormalized cross product -> (unit normals (F,3), areas (F,))."""
        tri = self.triangles()
        c = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        norm = np.linalg.norm(c, axis=-1)
        n = c / np.maximum(norm, 1e-20)[:, None]
        return n.astype(np.float32), (norm / 2.0).astype(np.float32)

    def aabb(self) -> tuple[np.ndarray, np.ndarray]:
        return self.vertices.min(0), self.vertices.max(0)


def load_mesh(path: str) -> Mesh:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj(path)
    if ext == ".ply":
        return load_ply(path)
    raise ValueError(f"unsupported mesh format: {path}")


def load_obj(path: str) -> Mesh:
    """Minimal OBJ parser: v and f records (f supports v/vt/vn and negative
    indices); polygons are fan-triangulated."""
    verts: list[list[float]] = []
    faces: list[list[int]] = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                verts.append([float(p[1]), float(p[2]), float(p[3])])
            elif line.startswith("f "):
                p = line.split()[1:]
                idx = []
                for tok in p:
                    s = tok.split("/")[0]
                    i = int(s)
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return Mesh(
        vertices=np.asarray(verts, dtype=np.float32),
        faces=np.asarray(faces, dtype=np.int32).reshape(-1, 3),
    )


_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path: str) -> Mesh:
    """PLY parser: ascii / binary_little_endian / binary_big_endian; extracts
    x,y,z vertex properties and triangulated vertex_indices face lists."""
    with open(path, "rb") as f:
        data = f.read()

    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError("not a valid PLY file")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = None
    elements: list[tuple[str, int, list]] = []  # (name, count, [props])
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append(("scalar", parts[1], parts[2]))

    if fmt == "ascii":
        return _parse_ply_ascii(body, elements)
    endian = "<" if fmt == "binary_little_endian" else ">"
    return _parse_ply_binary(body, elements, endian)


def _parse_ply_ascii(body: bytes, elements) -> Mesh:
    lines = body.decode("ascii", errors="replace").splitlines()
    pos = 0
    verts = None
    faces: list[list[int]] = []
    for name, count, props in elements:
        if name == "vertex":
            names = [p[2] for p in props if p[0] == "scalar"]
            arr = np.array(
                [lines[pos + i].split() for i in range(count)], dtype=np.float64
            )
            ix, iy, iz = names.index("x"), names.index("y"), names.index("z")
            verts = arr[:, [ix, iy, iz]].astype(np.float32)
            pos += count
        elif name == "face":
            for i in range(count):
                toks = lines[pos + i].split()
                n = int(toks[0])
                idx = [int(t) for t in toks[1 : 1 + n]]
                for k in range(1, n - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
            pos += count
        else:
            pos += count
    return Mesh(verts, np.asarray(faces, dtype=np.int32).reshape(-1, 3))


def _parse_ply_binary(body: bytes, elements, endian: str) -> Mesh:
    offset = 0
    verts = None
    faces_arr = None
    for name, count, props in elements:
        if all(p[0] == "scalar" for p in props):
            dt = np.dtype([(p[2], endian + _PLY_DTYPES[p[1]]) for p in props])
            arr = np.frombuffer(body, dtype=dt, count=count, offset=offset)
            offset += dt.itemsize * count
            if name == "vertex":
                verts = np.stack(
                    [arr["x"], arr["y"], arr["z"]], axis=-1
                ).astype(np.float32)
        else:
            # list property (face element). Fast path: uniform triangle lists.
            assert props[0][0] == "list", "unsupported PLY layout"
            cnt_dt = np.dtype(endian + _PLY_DTYPES[props[0][1]])
            idx_dt = np.dtype(endian + _PLY_DTYPES[props[0][2]])
            first_n = int(
                np.frombuffer(body, dtype=cnt_dt, count=1, offset=offset)[0]
            )
            rec_size = cnt_dt.itemsize + first_n * idx_dt.itemsize
            uniform = offset + count * rec_size <= len(body)
            if uniform:
                blob = np.frombuffer(body, dtype=np.uint8,
                                     count=count * rec_size, offset=offset)
                counts = blob.reshape(count, rec_size)[
                    :, : cnt_dt.itemsize].copy()
                counts = counts.view(cnt_dt).reshape(count)
                uniform = bool(np.all(counts == first_n))
            if uniform:
                idx = blob.reshape(count, rec_size)[:, cnt_dt.itemsize:].copy()
                idx = idx.view(idx_dt).reshape(count, first_n).astype(np.int64)
                if first_n == 3:
                    tri = idx
                else:
                    tri = np.concatenate(
                        [np.stack([idx[:, 0], idx[:, k], idx[:, k + 1]], -1)
                         for k in range(1, first_n - 1)], 0)
                offset += count * rec_size
            else:
                # variable-size polygons (also where a first polygon larger
                # than the rest would read past the body): slow path
                tris = []
                for _ in range(count):
                    n = int(np.frombuffer(body, cnt_dt, 1, offset)[0])
                    offset += cnt_dt.itemsize
                    idx = np.frombuffer(body, idx_dt, n, offset).astype(np.int64)
                    offset += n * idx_dt.itemsize
                    for k in range(1, n - 1):
                        tris.append([idx[0], idx[k], idx[k + 1]])
                tri = np.asarray(tris, dtype=np.int64)
            if name == "face":
                faces_arr = tri.astype(np.int32)
    if verts is None or faces_arr is None:
        raise ValueError("PLY missing vertex or face element")
    return Mesh(verts, faces_arr.reshape(-1, 3))


def save_ply(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Write a binary little-endian triangle PLY (used by emitter-mesh export)."""
    v = np.ascontiguousarray(vertices, dtype="<f4")
    f = np.ascontiguousarray(faces, dtype="<i4")
    with open(path, "wb") as out:
        out.write(b"ply\nformat binary_little_endian 1.0\n")
        out.write(f"element vertex {len(v)}\n".encode())
        out.write(b"property float x\nproperty float y\nproperty float z\n")
        out.write(f"element face {len(f)}\n".encode())
        out.write(b"property list uchar int vertex_indices\nend_header\n")
        out.write(v.tobytes())
        cnt = np.full((len(f), 1), 3, dtype=np.uint8)
        rec = np.zeros(len(f), dtype=[("n", "u1"), ("idx", "<i4", (3,))])
        rec["n"] = cnt[:, 0]
        rec["idx"] = f
        out.write(rec.tobytes())
