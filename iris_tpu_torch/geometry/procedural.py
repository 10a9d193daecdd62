"""Procedural test scenes (counterpart of iris_tpu/geometry/procedural.py):
a box room with interior clutter boxes and an emissive ceiling quad, plus
camera and random ray sets. Host-side numpy, bit-identical to the JAX
package's copy for the same arguments."""

from __future__ import annotations

import numpy as np

from iris_tpu_torch.geometry.mesh import Mesh


def _quad(p0, p1, p2, p3):
    """Two triangles for quad p0-p1-p2-p3 (ccw)."""
    return [[p0, p1, p2], [p0, p2, p3]]


def _box(lo, hi, flip=False):
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    c = lambda *p: list(p)  # noqa: E731
    quads = (
        _quad(c(x0, y0, z0), c(x1, y0, z0), c(x1, y1, z0), c(x0, y1, z0))  # z0
        + _quad(c(x0, y0, z1), c(x0, y1, z1), c(x1, y1, z1), c(x1, y0, z1))  # z1
        + _quad(c(x0, y0, z0), c(x0, y1, z0), c(x0, y1, z1), c(x0, y0, z1))  # x0
        + _quad(c(x1, y0, z0), c(x1, y0, z1), c(x1, y1, z1), c(x1, y1, z0))  # x1
        + _quad(c(x0, y0, z0), c(x0, y0, z1), c(x1, y0, z1), c(x1, y0, z0))  # y0
        + _quad(c(x0, y1, z0), c(x1, y1, z0), c(x1, y1, z1), c(x0, y1, z1))  # y1
    )
    tris = np.asarray(quads, dtype=np.float32)
    if flip:
        tris = tris[:, ::-1, :]
    return tris


def make_box_scene(n_clutter: int = 8, seed: int = 0,
                   light_size: float = 0.4):
    """Room [0,2]^2 x [0,1] + clutter boxes + emissive ceiling quad.

    Returns (mesh, emitter_face_mask) where the last 2 faces are the light.
    """
    rng = np.random.default_rng(seed)
    tris = [_box((0, 0, 0), (2, 2, 1))]
    for _ in range(n_clutter):
        c = rng.uniform([0.2, 0.2, 0.0], [1.8, 1.8, 0.3])
        s = rng.uniform(0.05, 0.25, size=3)
        tris.append(_box(c, c + s))
    # emissive quad slightly below ceiling, facing down
    h = light_size / 2
    cx, cy, z = 1.0, 1.0, 0.98
    quad = np.asarray(
        _quad([cx - h, cy - h, z], [cx - h, cy + h, z],
              [cx + h, cy + h, z], [cx + h, cy - h, z]),
        dtype=np.float32,
    )
    tris.append(quad)
    all_tris = np.concatenate(tris, axis=0)

    verts = all_tris.reshape(-1, 3)
    faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    mesh = Mesh(verts.astype(np.float32), faces)
    is_emitter = np.zeros(len(faces), dtype=bool)
    is_emitter[-2:] = True
    return mesh, is_emitter


def random_rays(n: int, seed: int = 0, origin=(1.0, 1.0, 0.5)):
    """Rays from a point inside the room in random directions."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.asarray(origin, np.float32), (n, 3)).copy()
    return o.astype(np.float32), d.astype(np.float32)


def camera_rays(n_side: int, origin=(1.0, 0.25, 0.5), look=(0.0, 1.0, 0.0),
                fov: float = 70.0):
    """Pinhole rays + differentials: returns rays_o, rays_d, dxdu, dydv."""
    look = np.asarray(look, np.float64)
    look = look / np.linalg.norm(look)
    up = np.asarray([0.0, 0.0, 1.0])
    right = np.cross(look, up)
    right /= np.linalg.norm(right)
    up = np.cross(right, look)
    f = 0.5 * n_side / np.tan(np.radians(fov) / 2)
    i, j = np.meshgrid(np.arange(n_side) + 0.5, np.arange(n_side) + 0.5)
    d = (
        (i - n_side / 2)[..., None] / f * right
        + (n_side / 2 - j)[..., None] / f * up
        + look
    ).reshape(-1, 3)
    o = np.broadcast_to(np.asarray(origin, np.float64), d.shape)
    dxdu = np.broadcast_to(right / f, d.shape)
    dydv = np.broadcast_to(up / f, d.shape)
    return (o.astype(np.float32), d.astype(np.float32),
            dxdu.astype(np.float32), dydv.astype(np.float32))
