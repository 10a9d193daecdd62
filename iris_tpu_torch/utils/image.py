"""PNG/image helpers (PIL-backed) + colormap save (counterpart of
iris_tpu/utils/image.py).

Parity with reference render.py save_image (:37-46) and the dataset PNG
loaders (synthetic_ldr.py:67-78).
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def save_image(image, path: str, colormap: bool = False) -> np.ndarray:
    """Clip to [0,1], optionally magma-colormap single-channel, save PNG."""
    image = np.asarray(image)
    image = np.clip(image.astype(np.float32), 0.0, 1.0)
    if image.ndim == 3 and image.shape[-1] == 1:
        image = image[..., 0]
    if colormap:
        import matplotlib.cm as cm

        image = cm.magma(image)[..., :3]
    arr = (image * 255).astype(np.uint8)
    Image.fromarray(arr).save(path)
    return arr


def open_png(path: str, img_hw=None, gamma: float | None = None) -> np.ndarray:
    """Load PNG -> float32 (H, W, 3) in [0,1]; optional resize + gamma
    linearization (reference open_png, synthetic_ldr.py:67-78)."""
    img = Image.open(path).convert("RGB")
    if img_hw is not None and (img.height, img.width) != tuple(img_hw):
        img = img.resize((img_hw[1], img_hw[0]), Image.BILINEAR)
    arr = np.asarray(img).astype(np.float32) / 255.0
    if gamma:
        arr = arr ** gamma
    return arr


def srgb_gamma(x: np.ndarray) -> np.ndarray:
    """sRGB tone curve (reference ModelTrainer.gamma, train_brdf_crf.py:154)."""
    x = np.asarray(x)
    return np.where(x <= 0.0031308, 12.92 * x,
                    1.055 * np.power(np.maximum(x, 1e-8), 1 / 2.4) - 0.055)
