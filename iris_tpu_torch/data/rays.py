"""Camera-ray generation (numpy, host-side; counterpart of
iris_tpu/data/rays.py, bit for bit).

Two conventions, matching the reference datasets:
- Blender/synthetic: x-left, y-up, z-forward local frame from a shared focal
  (synthetic_ldr.py:21-57).
- Intrinsics-matrix (real / ScanNet++): pixel-center K-based OpenCV rays
  (real_ldr.py:49-83).
Ray differentials dxdu/dydv are the world-space per-pixel derivative columns
R[:, 0]/f and R[:, 1]/f used by the integrators for pixel jitter.

Wire format everywhere: rays[..., :3]=origin, 3:6=direction (unnormalized),
6:9=dxdu, 9:12=dydv.
"""

from __future__ import annotations

import numpy as np


def get_ray_directions_blender(h: int, w: int, focal: float) -> np.ndarray:
    """(H, W, 3) local directions, x-left / y-up / z-forward."""
    x = np.linspace(0.5, w - 0.5, w)
    y = np.linspace(0.5, h - 0.5, h)
    j, i = np.meshgrid(y, x, indexing="ij")
    return np.stack(
        [-(i - w / 2) / focal, -(j - h / 2) / focal, np.ones_like(i)], -1
    ).astype(np.float32)


def get_rays_blender(directions: np.ndarray, c2w: np.ndarray,
                     focal: float | None = None):
    """World rays from local directions + 3x4 c2w. With focal, returns
    (o, d, dxdu, dydv); else (o, normalized d)."""
    r = c2w[:, :3]
    d = directions @ r.T
    o = np.broadcast_to(c2w[:, 3], d.shape)
    d = d.reshape(-1, 3)
    o = o.reshape(-1, 3).copy()
    if focal is not None:
        dxdu = np.broadcast_to(
            (np.asarray([1.0 / focal, 0, 0]) @ r.T), d.shape
        ).reshape(-1, 3)
        dydv = np.broadcast_to(
            (np.asarray([0, 1.0 / focal, 0]) @ r.T), d.shape
        ).reshape(-1, 3)
        return (o.astype(np.float32), d.astype(np.float32),
                dxdu.astype(np.float32), dydv.astype(np.float32))
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def get_direction_k(k: np.ndarray, img_hw) -> np.ndarray:
    """(HW, 3) unnormalized OpenCV local rays from intrinsics."""
    h, w = img_hw
    sy, sx = np.meshgrid(np.linspace(0.5, h - 0.5, h),
                         np.linspace(0.5, w - 0.5, w), indexing="ij")
    return np.stack([
        (sx - k[0, 2]) / k[0, 0],
        (sy - k[1, 2]) / k[1, 1],
        np.ones_like(sy),
    ], -1).reshape(-1, 3).astype(np.float32)


def to_world_k(rays_d: np.ndarray, c2w: np.ndarray, k: np.ndarray,
               ray_diff: bool = True):
    """World rays (+differentials) from K-based local rays and 3x4 c2w."""
    r = c2w[:3, :3]
    o = np.broadcast_to(c2w[:, 3], rays_d.shape).astype(np.float32)
    d = (rays_d @ r.T).astype(np.float32)
    if not ray_diff:
        return o, d / np.linalg.norm(d, axis=-1, keepdims=True)
    dxdu = np.broadcast_to(np.asarray([1.0 / k[0, 0], 0, 0]) @ r.T,
                           d.shape).astype(np.float32)
    dydv = np.broadcast_to(np.asarray([0, 1.0 / k[1, 1], 0]) @ r.T,
                           d.shape).astype(np.float32)
    return o.copy(), d, dxdu.copy(), dydv.copy()


def opengl_cam_to_opencv(origin, lookat, up) -> np.ndarray:
    """(origin, lookat, up) OpenGL triple -> 3x4 OpenCV c2w
    (real_ldr.py:143-153)."""
    origin = np.asarray(origin, np.float64)
    at = lookat - origin
    at = at / np.linalg.norm(at)
    up = np.asarray(up, np.float64)
    if abs(np.dot(at, up)) >= 2e-3:
        raise ValueError("lookat/up must be perpendicular")
    r = np.stack((np.cross(-up, at), -up, at), -1)
    return np.hstack([r, origin.reshape(3, 1)]).astype(np.float32)


def read_cam_params(path: str) -> list[np.ndarray]:
    """cam.txt / K_list.txt reader: count line + 3-row blocks
    (real_ldr.py:25-34)."""
    with open(path) as f:
        lines = f.read().splitlines()
    n = int(lines[0])
    vals = np.asarray([ln.split() for ln in lines[1:]], np.float32)
    if vals.shape[0] != n * 3:
        raise ValueError(f"{path}: {vals.shape[0]} rows for {n} blocks")
    return list(np.split(vals, n, axis=0))


def concat_rays(o, d, dxdu, dydv) -> np.ndarray:
    return np.concatenate([o, d, dxdu, dydv], -1).astype(np.float32)
