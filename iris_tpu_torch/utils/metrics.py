"""Image quality metrics: PSNR and SSIM (numpy; skimage-compatible), a copy
of iris_tpu/utils/metrics.py, so that the port imports nothing of the JAX
package.

These replicate
skimage.metrics.peak_signal_noise_ratio / structural_similarity with the
defaults the reference uses (render.py:236-237: data_range=1,
channel_axis=-1 — i.e. gaussian-free 7x7 uniform window variant matching
skimage's default win_size=7, gaussian_weights=False).
"""

from __future__ import annotations

import numpy as np


def psnr(gt: np.ndarray, pred: np.ndarray, data_range: float = 1.0) -> float:
    mse = np.mean((np.asarray(gt, np.float64) - np.asarray(pred, np.float64))
                  ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """Separable box filter with skimage-style reflect padding."""
    out = x.astype(np.float64)
    for axis in (0, 1):
        pad = [(0, 0)] * out.ndim
        pad[axis] = (size // 2, size // 2)
        p = np.pad(out, pad, mode="reflect")
        c = np.cumsum(p, axis=axis)
        z = np.zeros_like(np.take(c, [0], axis=axis))
        c = np.concatenate([z, c], axis=axis)
        hi = np.take(c, range(size, c.shape[axis]), axis=axis)
        lo = np.take(c, range(0, c.shape[axis] - size), axis=axis)
        out = (hi - lo) / size
    return out


def ssim(
    gt: np.ndarray, pred: np.ndarray, data_range: float = 1.0,
    win_size: int = 7, channel_axis: int | None = -1,
) -> float:
    x = np.asarray(gt, np.float64)
    y = np.asarray(pred, np.float64)
    if channel_axis is not None and x.ndim == 3:
        vals = [ssim(x[..., c], y[..., c], data_range, win_size, None)
                for c in range(x.shape[-1])]
        return float(np.mean(vals))

    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    n = win_size ** 2
    cov_norm = n / (n - 1)

    ux = _uniform_filter(x, win_size)
    uy = _uniform_filter(y, win_size)
    uxx = _uniform_filter(x * x, win_size)
    uyy = _uniform_filter(y * y, win_size)
    uxy = _uniform_filter(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2)
    )
    pad = (win_size - 1) // 2
    return float(s[pad:-pad or None, pad:-pad or None].mean())
