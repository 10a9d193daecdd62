"""PNG/image helpers (PIL-backed) + colormap save (counterpart of
iris_tpu/utils/image.py).

Parity with reference render.py save_image (:37-46) and the dataset PNG
loaders (synthetic_ldr.py:67-78). The JAX package maps single-channel
images through matplotlib's magma colormap; the port keeps that map as a
constant (MAGMA, below) and imports no matplotlib, which the card's
machine lacks.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

# matplotlib's magma colormap (matplotlib.cm.magma.colors, 256 entries) as
# the 8-bit values save_image writes, floor(255 * channel): row i, RGB
_MAGMA_HEX = (
    "00000300000400000601000701010901010b02020d02020f030311040313040415050417"
    "06051907051b08061d09071f0a07220b08240c09260d0a280e0a2a0f0b2c100c2f110c31"
    "120d33140d35150e38160e3a170f3c180f3f1a10411b10441c10461e10491f114b20114d"
    "2211502311522511552611572811592a115c2b115e2d10602f1062301065321067341068"
    "350f6a370f6c390f6e3b0f6f3c0f713e0f72400f73420f74430f75450f76470f77481078"
    "4a10794b10794d117a4f117b50127b52127c53137c55137d57147d58157e5a157e5b167e"
    "5d177e5e177f60187f61187f63197f651a80661a80681b80691c806b1c806c1d806e1e81"
    "6f1e81711f81731f817420817621817721817922817a22817c23817e24817f2481812581"
    "8225818426818526818727818928818a28818c29808d29808f2a80912a80922b80942b80"
    "952c80972c7f992d7f9a2d7f9c2e7f9e2e7e9f2f7ea12f7ea3307ea4307da6317da7317d"
    "a9327cab337cac337bae347bb0347bb1357ab3357ab53679b63679b83778b93778bb3877"
    "bd3977be3976c03a75c23a75c33b74c53c74c63c73c83d72ca3e72cb3e71cd3f70ce4070"
    "d0416fd1426ed3426dd4436dd6446cd7456bd9466ada4769dc4869dd4968de4a67e04b66"
    "e14c66e24d65e44e64e55063e65162e75262e85461ea5560eb5660ec585fed595fee5b5e"
    "ee5d5def5e5df0605df1615cf2635cf3655cf3675bf4685bf56a5bf56c5bf66e5bf6705b"
    "f7715bf7735cf8755cf8775cf9795cf97b5df97d5dfa7f5efa805efa825ffb8460fb8660"
    "fb8861fb8a62fc8c63fc8e63fc9064fc9265fc9366fd9567fd9768fd9969fd9b6afd9d6b"
    "fd9f6cfda16efda26ffda470fea671fea873feaa74feac75feae76feaf78feb179feb37b"
    "feb57cfeb77dfeb97ffebb80febc82febe83fec085fec286fec488fec689fec78bfec98d"
    "fecb8efdcd90fdcf92fdd193fdd295fdd497fdd698fdd89afdda9cfddc9dfddd9ffddfa1"
    "fde1a3fce3a5fce5a6fce6a8fce8aafceaacfcecaefceeb0fcf0b1fcf1b3fcf3b5fcf5b7"
    "fbf7b9fbf9bbfbfabdfbfcbf"
)
MAGMA = np.frombuffer(bytes.fromhex("".join(_MAGMA_HEX)), np.uint8
                      ).reshape(256, 3)


def magma_bytes(image: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 magma colours of values in [0, 1], entry by entry as
    matplotlib picks them (min(int(256 x), 255)); NaN maps to black."""
    bad = np.isnan(image)
    idx = np.minimum((np.where(bad, 0, image) * 256).astype(np.int64), 255)
    return np.where(bad[..., None], 0, MAGMA[idx]).astype(np.uint8)


def save_image(image, path: str, colormap: bool = False) -> np.ndarray:
    """Clip to [0,1], optionally magma-colormap single-channel, save PNG."""
    image = np.asarray(image)
    image = np.clip(image.astype(np.float32), 0.0, 1.0)
    if image.ndim == 3 and image.shape[-1] == 1:
        image = image[..., 0]
    if colormap:
        arr = magma_bytes(image)
    else:
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
