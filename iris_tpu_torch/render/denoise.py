"""Edge-aware à-trous denoiser with aux-buffer guides (counterpart of
iris_tpu/render/denoise.py), plain PyTorch on the device.

Substitute for the closed-source OptixDenoiser the reference applies to
Monte-Carlo renders outside the gradient path (bake_shading.py:81,
render.py:151): a multi-pass à-trous wavelet filter with color-range
bilateral weights, optionally joint-bilateral on first-hit NORMAL and
ALBEDO guides. Taps wrap around the image borders (torch.roll), as the
JAX package's jnp.roll does; the edges are kept so for parity.

- invalid (miss) pixels are stored as zeros; the `mask` argument
  zero-weights invalid taps and passes invalid pixels through;
- denoise_hdr scales the color sigma to a spike-aware (95th-percentile)
  noise estimate, computed on the host with scipy.

The JAX package's IRIS_TPU_NO_DENOISE switch is not read: a stage that
may skip the filter takes a --denoise argument instead.
"""

from __future__ import annotations

import numpy as np
import torch

from iris_tpu_torch.device import resolve_device

_OFFSETS = [(-2, -2), (-2, 0), (-2, 2), (0, -2), (0, 0), (0, 2), (2, -2),
            (2, 0), (2, 2), (-1, -1), (-1, 1), (1, -1), (1, 1), (-1, 0),
            (1, 0), (0, -1), (0, 1)]
_KW = {0: 3.0 / 8.0, 1: 1.0 / 4.0, 2: 1.0 / 16.0}


def _inv_two_sigma2(sigma, ref: torch.Tensor) -> torch.Tensor:
    # 2 sigma^2 in f32 on the device, as the jitted JAX filter computes it
    s = torch.as_tensor(sigma, dtype=ref.dtype, device=ref.device)
    return 2.0 * s * s


@torch.no_grad()
def atrous_denoise(img: torch.Tensor, n_passes: int = 3,
                   sigma_color: float = 0.25,
                   normal: torch.Tensor | None = None,
                   albedo: torch.Tensor | None = None,
                   sigma_normal: float = 0.2, sigma_albedo: float = 0.15,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """img: (H, W, 3) HDR radiance -> denoised (H, W, 3).

    normal/albedo: optional (H, W, 3) first-hit guides, weighed against
    the ORIGINAL buffers every pass. mask: (H, W) bool validity; invalid
    taps get zero weight and invalid pixels pass through."""
    mask_w = None if mask is None else mask.to(img.dtype)[..., None]
    den_c = _inv_two_sigma2(sigma_color, img)
    den_n = _inv_two_sigma2(sigma_normal, img)
    den_a = _inv_two_sigma2(sigma_albedo, img)

    def one_pass(x, step):
        h, w, _ = x.shape
        acc = torch.zeros_like(x)
        wacc = torch.zeros((h, w, 1), dtype=x.dtype, device=x.device)
        for dy, dx in _OFFSETS:
            k = _KW[max(abs(dy), abs(dx))]
            sh = (dy * step, dx * step)
            shifted = torch.roll(x, sh, dims=(0, 1))
            d2 = torch.sum((shifted - x) ** 2, -1, keepdim=True)
            wgt = k * torch.exp(-d2 / den_c)
            if normal is not None:
                dn = torch.sum((torch.roll(normal, sh, dims=(0, 1))
                                - normal) ** 2, -1, keepdim=True)
                wgt = wgt * torch.exp(-dn / den_n)
            if albedo is not None:
                da = torch.sum((torch.roll(albedo, sh, dims=(0, 1))
                                - albedo) ** 2, -1, keepdim=True)
                wgt = wgt * torch.exp(-da / den_a)
            if mask_w is not None:
                wgt = wgt * torch.roll(mask_w, sh, dims=(0, 1))
            acc = acc + shifted * wgt
            wacc = wacc + wgt
        out = acc / torch.clamp(wacc, min=1e-8)
        if mask_w is not None:
            out = torch.where(mask_w > 0, out, x)
        return out

    out = img
    for p in range(n_passes):
        out = one_pass(out, 1 << p)
    return out


def estimate_noise_sigma(img, mask=None) -> float:
    """MC-noise scale for bilateral sigmas: the 95th percentile of
    |img - 3x3 median| over valid pixels (host, numpy + scipy). Low-spp
    Monte Carlo noise is spike-dominated, so a median/MAD estimate
    collapses; the filter must open its range to the spike magnitude."""
    from scipy.ndimage import median_filter

    img = np.asarray(img, np.float32)
    lum = img.mean(-1)
    dev = np.abs(lum - median_filter(lum, size=3))
    if mask is not None:
        dev = dev[np.asarray(mask, bool)]
    if dev.size == 0:
        return 0.0
    return float(np.quantile(dev, 0.95))


def denoise_hdr(img, n_passes: int = 3, sigma_color: float | None = None,
                normal=None, albedo=None, mask=None, device=None
                ) -> np.ndarray:
    """Numpy in/out wrapper used by the bake stages: the filter runs on
    `device` (the card unless the caller passes device="cpu"). Pass
    first-hit `normal`/`albedo` (H, W, 3) guides and a validity `mask`
    (H, W).

    sigma_color default: noise-proportional, 2x the q95 spike estimate
    (estimate_noise_sigma), floored at 0.25 without guides and at 0.05
    with them (the guides carry the edge-stopping)."""
    dev = resolve_device(device)
    img = np.asarray(img, np.float32)
    if mask is not None:
        mask = np.asarray(mask, bool).reshape(img.shape[:2])
    if sigma_color is None:
        s_noise = estimate_noise_sigma(img, mask)
        floor = 0.25 if normal is None and albedo is None else 0.05
        sigma_color = max(2.0 * s_noise, floor)

    def t(a):
        return None if a is None else torch.as_tensor(
            np.asarray(a, np.float32).reshape(img.shape[:2] + (-1,)),
            device=dev)

    mk = None if mask is None else torch.as_tensor(mask, device=dev)
    out = atrous_denoise(torch.as_tensor(img, device=dev), n_passes,
                         sigma_color, t(normal), t(albedo), mask=mk)
    return out.cpu().numpy()
