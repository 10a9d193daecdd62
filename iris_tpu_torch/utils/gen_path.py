"""Smooth interpolated camera trajectories (counterpart of
iris_tpu/utils/gen_path.py, numpy, bit for bit).

Parity: reference utils/ray_utils.py generate_interpolated_path
(:166-213) — the standard multinerf B-spline technique over (position,
lookat, up) keypoints — plus pose averaging utilities used by
render_video.
"""

from __future__ import annotations

import numpy as np
import scipy.interpolate


def normalize(v):
    return v / np.linalg.norm(v)


def viewmatrix(lookdir, up, position):
    """3x4 OpenCV c2w from forward/up/position."""
    vec2 = normalize(lookdir)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def average_pose(poses: np.ndarray) -> np.ndarray:
    """Mean camera: average position, forward and up (ray_utils.py:48)."""
    center = poses[:, :3, 3].mean(0)
    fwd = normalize(poses[:, :3, 2].sum(0))
    up = normalize(poses[:, :3, 1].sum(0))
    return viewmatrix(fwd, up, center)


def generate_interpolated_path(
    poses: np.ndarray, n_interp: int, spline_degree: int = 5,
    smoothness: float = 0.03, rot_weight: float = 0.1,
) -> np.ndarray:
    """(n,3,4) OpenCV c2w keyframes -> (n_interp*(n-1), 3, 4) smooth path."""

    def poses_to_points(poses, dist):
        pos = poses[:, :3, -1]
        lookat = pos - dist * poses[:, :3, 2]
        up = pos + dist * poses[:, :3, 1]
        return np.stack([pos, lookat, up], 1)

    def points_to_poses(points):
        return np.array([viewmatrix(p - l, u - p, p) for p, l, u in points])

    points = poses_to_points(poses, dist=rot_weight)
    sh = points.shape
    pts = points.reshape(sh[0], -1)
    k = min(spline_degree, sh[0] - 1)
    tck, _ = scipy.interpolate.splprep(pts.T, k=k, s=smoothness)
    u = np.linspace(0, 1, n_interp * (sh[0] - 1), endpoint=False)
    new = np.array(scipy.interpolate.splev(u, tck)).T.reshape(-1, sh[1],
                                                              sh[2])
    return points_to_poses(new)


def create_spheric_poses(radius, mean_h, n_poses=120):
    """Circle of inward-looking poses (ray_utils.py:120-155 analogue)."""
    out = []
    for th in np.linspace(0, 2 * np.pi, n_poses, endpoint=False):
        pos = np.asarray([radius * np.cos(th), radius * np.sin(th), mean_h])
        out.append(viewmatrix(-normalize(pos), np.asarray([0, 0, 1.0]), pos))
    return np.stack(out)


def average_poses(poses: np.ndarray, pts3d: np.ndarray | None = None
                  ) -> np.ndarray:
    """Average pose per the NeRF-LLFF convention (ray_utils.py:55-87):
    center from pts3d (or camera positions), z = mean forward, x from the
    mean up hint, y completing the frame. Returns (3, 4)."""
    center = (pts3d.mean(0) if pts3d is not None
              else poses[..., 3].mean(0))
    z = normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def center_poses(poses: np.ndarray, pts3d: np.ndarray | None = None):
    """Re-express all poses (and optionally a point cloud) in the
    average-pose frame (ray_utils.py:89-118). Returns centered poses
    (N, 3, 4), plus centered pts3d when given."""
    pose_avg = average_poses(poses, pts3d)
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = pose_avg
    inv = np.linalg.inv(pose_avg_homo)
    last = np.tile(np.asarray([0.0, 0.0, 0.0, 1.0]), (len(poses), 1, 1))
    centered = (inv @ np.concatenate([poses, last], 1))[:, :3]
    if pts3d is not None:
        pts = pts3d @ inv[:3, :3].T + inv[:3, 3]
        return centered, pts
    return centered
