"""The data/IO layer of the port against the JAX package: EXR files both
ways (every compression, half and float), the third-party EXR of
tests/data, OBJ and PLY meshes, save_ply, and the camera-ray functions of
data/rays.py. All are host-side numpy in both packages, so every
comparison is exact: the same bytes, the same arrays."""

import os

import numpy as np
import pytest

from iris_tpu.data import rays as jrays
from iris_tpu.geometry import mesh as jmesh
from iris_tpu.utils import exr as jexr
from iris_tpu_torch.data import rays as trays
from iris_tpu_torch.geometry import mesh as tmesh
from iris_tpu_torch.utils import exr as texr

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _image(h=37, w=29, c=3, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.gamma(0.7, 1.5, (h, w, c)).astype(np.float32)
    img[0, :] = 0.0                   # runs of zeros, as a miss region
    img[5, 3] = 65000.0               # near half's top
    return img


@pytest.mark.parametrize("compression", ["none", "zip", "zips", "piz"])
@pytest.mark.parametrize("half", [True, False])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_exr_both_ways_bit_for_bit(tmp_path, compression, half, channels):
    img = _image(c=channels)[..., 0] if channels == 1 else _image(
        c=channels)
    p_port, p_jax = tmp_path / "port.exr", tmp_path / "jax.exr"
    texr.write_exr(str(p_port), img, half=half, compression=compression)
    jexr.write_exr(str(p_jax), img, half=half, compression=compression)
    assert p_port.read_bytes() == p_jax.read_bytes()
    for p in (p_port, p_jax):
        a, b = texr.read_exr(str(p)), jexr.read_exr(str(p))
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    want = img.astype(np.float16).astype(np.float32) if half else img
    np.testing.assert_array_equal(
        texr.read_exr(str(p_jax)).reshape(want.shape), want)


def test_exr_piz_multiblock(tmp_path):
    """PIZ blocks hold 32 lines: 70 lines make three, the last short."""
    img = _image(h=70, w=41)
    p = tmp_path / "piz.exr"
    jexr.write_exr(str(p), img, compression="piz")
    np.testing.assert_array_equal(texr.read_exr(str(p)),
                                  jexr.read_exr(str(p)))
    q = tmp_path / "piz_port.exr"
    texr.write_exr(str(q), img, compression="piz")
    assert q.read_bytes() == p.read_bytes()


def test_third_party_exr_reads_equal():
    p = os.path.join(DATA, "python_thirdparty.exr")
    a, b = texr.read_exr(p), jexr.read_exr(p)
    assert a.size > 0 and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)


def test_exr_refuses_a_non_exr(tmp_path):
    p = tmp_path / "x.exr"
    p.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError):
        texr.read_exr(str(p))


# ------------------------------------------------------------------ meshes

_VERTS = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                     [0.5, 0.5, 1.25]], np.float32)


def _write_obj(path):
    path.write_text(
        "# quad + two triangles, v/vt/vn and negative indices\n"
        + "".join(f"v {x} {y} {z}\n" for x, y, z in _VERTS)
        + "vt 0 0\nvn 0 0 1\n"
        "f 1/1/1 2/1/1 3/1/1 4/1/1\n"
        "f 1 2 5\n"
        "f -3 -2 -1\n")


def _write_ply_ascii(path):
    path.write_text(
        "ply\nformat ascii 1.0\ncomment x\n"
        f"element vertex {len(_VERTS)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\n"
        "element face 3\nproperty list uchar int vertex_indices\n"
        "end_header\n"
        + "".join(f"{x} {y} {z} 7\n" for x, y, z in _VERTS)
        + "4 0 1 2 3\n3 0 1 4\n3 2 3 4\n")


_MIXED = {"tri": [[0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4]],
          "mixed": [[0, 1, 4], [2, 3, 4], [0, 1, 2, 3]],
          "quad_first": [[0, 1, 2, 3], [0, 1, 4], [2, 3, 4]]}


def _write_ply_binary(path, endian, faces):
    """Binary PLY with triangle lists, or mixed polygon sizes (the slow
    path of the parser)."""
    e = "<" if endian == "little" else ">"
    head = (f"ply\nformat binary_{endian}_endian 1.0\n"
            f"element vertex {len(_VERTS)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n")
    body = _VERTS.astype(e + "f4").tobytes()
    for f in faces:
        body += np.uint8(len(f)).tobytes() + np.asarray(f, e + "i4").tobytes()
    path.write_bytes(head.encode() + body)


def _same_mesh(a, b):
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)
    assert a.vertices.dtype == b.vertices.dtype
    assert a.faces.dtype == b.faces.dtype


@pytest.mark.parametrize("kind", ["obj", "ply_ascii", "ply_le", "ply_be",
                                  "ply_le_mixed"])
def test_meshes_load_equal(tmp_path, kind):
    p = tmp_path / ("m.obj" if kind == "obj" else "m.ply")
    if kind == "obj":
        _write_obj(p)
    elif kind == "ply_ascii":
        _write_ply_ascii(p)
    else:
        _write_ply_binary(p, "little" if "le" in kind else "big",
                          _MIXED["mixed" if "mixed" in kind else "tri"])
    got = tmesh.load_mesh(str(p))
    _same_mesh(got, jmesh.load_mesh(str(p)))
    assert got.n_faces >= 3
    n, a = got.face_normals_areas()
    jn, ja = jmesh.load_mesh(str(p)).face_normals_areas()
    np.testing.assert_array_equal(n, jn)
    np.testing.assert_array_equal(a, ja)


def test_binary_ply_with_a_larger_first_polygon(tmp_path):
    """A quad before triangles: the uniform-list fast path would read past
    the body (the JAX package's parser raises there); the port falls to
    the per-polygon path and fan-triangulates."""
    p = tmp_path / "m.ply"
    _write_ply_binary(p, "little", _MIXED["quad_first"])
    m = tmesh.load_ply(str(p))
    np.testing.assert_array_equal(m.vertices, _VERTS)
    np.testing.assert_array_equal(
        m.faces, [[0, 1, 2], [0, 2, 3], [0, 1, 4], [2, 3, 4]])


def test_save_ply_round_trips(tmp_path):
    rng = np.random.default_rng(3)
    v = rng.normal(size=(40, 3)).astype(np.float32)
    f = rng.integers(0, 40, (60, 3)).astype(np.int32)
    p, q = tmp_path / "port.ply", tmp_path / "jax.ply"
    tmesh.save_ply(str(p), v, f)
    jmesh.save_ply(str(q), v, f)
    assert p.read_bytes() == q.read_bytes()
    m = tmesh.load_ply(str(p))
    np.testing.assert_array_equal(m.vertices, v)
    np.testing.assert_array_equal(m.faces, f)
    _same_mesh(m, jmesh.load_ply(str(p)))


def test_load_mesh_refuses_other_formats(tmp_path):
    with pytest.raises(ValueError):
        tmesh.load_mesh(str(tmp_path / "m.stl"))


# ------------------------------------------------------------ camera rays

def _c2w(seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return np.hstack([q, rng.normal(size=(3, 1))]).astype(np.float32)


def _equal(a, b):
    a, b = (a if isinstance(a, tuple) else (a,)), (
        b if isinstance(b, tuple) else (b,))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x, y)


def test_rays_blender_bit_equal():
    dirs = trays.get_ray_directions_blender(7, 9, 6.3)
    _equal(dirs, jrays.get_ray_directions_blender(7, 9, 6.3))
    c2w = _c2w(0)
    _equal(trays.get_rays_blender(dirs, c2w, 6.3),
           jrays.get_rays_blender(dirs, c2w, 6.3))
    _equal(trays.get_rays_blender(dirs, c2w),
           jrays.get_rays_blender(dirs, c2w))
    o, d, dx, dy = trays.get_rays_blender(dirs, c2w, 6.3)
    _equal(trays.concat_rays(o, d, dx, dy), jrays.concat_rays(o, d, dx, dy))


def test_rays_intrinsics_bit_equal():
    k = np.asarray([[50.0, 0, 11.5], [0, 52.0, 8.25], [0, 0, 1]], np.float32)
    local = trays.get_direction_k(k, (13, 21))
    _equal(local, jrays.get_direction_k(k, (13, 21)))
    c2w = _c2w(1)
    for diff in (True, False):
        _equal(trays.to_world_k(local, c2w, k, diff),
               jrays.to_world_k(local, c2w, k, diff))
    origin, look, up = np.asarray([1.0, 2, 3]), np.asarray([1.0, 2, 4]), \
        np.asarray([0.0, 1, 0])
    _equal(trays.opengl_cam_to_opencv(origin, look, up),
           jrays.opengl_cam_to_opencv(origin, look, up))


def test_read_cam_params_equal(tmp_path):
    p = tmp_path / "cam.txt"
    rng = np.random.default_rng(2)
    blocks = rng.normal(size=(2, 3, 3)).astype(np.float32)
    p.write_text("2\n" + "".join(" ".join(f"{x:.6f}" for x in row) + "\n"
                                 for blk in blocks for row in blk))
    a, b = trays.read_cam_params(str(p)), jrays.read_cam_params(str(p))
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        _equal(x, y)
