"""Dataset prep: tone-map HDR EXRs into LDR PNGs with sampled CRFs and
binned exposures (counterpart of iris_tpu/utils/hdr2ldr.py, host numpy,
the same bytes; parity: reference crf/hdr2ldr.py).

The reference samples CRFs from the DoRF database (dorfCurves.txt — absent
upstream too, listed in its .MISSING_LARGE_BLOBS); here curves are sampled
from the EMoR basis instead (mean curve + random weights), which spans the
same measured response space. Exposures follow the reference scheme:
2^{-2..2}, assigned brightest-image -> smallest exposure.

Writes <dir_tgt>/cam/{crf,exposure}.npy and one PNG per EXR, the layout
data.datasets.SyntheticDataset(img_dir=...) reads.

Usage: python -m iris_tpu_torch.utils.hdr2ldr --dir_src <split>/Image \
           --dir_tgt <split>/<ldr dir> [--seed 0]
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np

from iris_tpu_torch.models.emor import emor_mean_and_basis
from iris_tpu_torch.utils.exr import read_exr
from iris_tpu_torch.utils.image import save_image


def sample_crfs(seed: int = 0, dim: int = 5, scale: float = 0.25
                ) -> np.ndarray:
    """(3, 1024) per-channel response curves from the EMoR space."""
    f0, basis = emor_mean_and_basis(dim)
    rng = np.random.default_rng(seed)
    w = rng.normal(0, scale, (3, dim)).astype(np.float32)
    crf = f0[None] + w @ basis
    # monotone + normalized
    crf = np.maximum.accumulate(crf, axis=-1)
    crf = (crf - crf[:, :1]) / np.maximum(crf[:, -1:] - crf[:, :1], 1e-6)
    return crf.astype(np.float32)


def apply_crf(irr: np.ndarray, curves: np.ndarray) -> np.ndarray:
    x = np.linspace(0, 1, curves.shape[-1])
    out = [np.interp(irr[..., c], x, curves[c]) for c in range(3)]
    return np.stack(out, -1)


def convert(dir_src: str, dir_tgt: str, curves: np.ndarray,
            levels=(-2, -1, 0, 1, 2)):
    os.makedirs(os.path.join(dir_tgt, "cam"), exist_ok=True)
    np.save(os.path.join(dir_tgt, "cam", "crf.npy"), curves)

    paths = sorted(os.path.join(dir_src, n) for n in os.listdir(dir_src)
                   if n.endswith(".exr"))
    exposure = np.sort((2.0 ** np.asarray(levels)))[::-1]
    means = np.asarray([read_exr(p).mean() for p in paths])
    order = np.argsort(means)
    img_exp = np.zeros(len(paths), np.float32)
    step = max(len(paths) // len(exposure), 1)
    for i, e in enumerate(exposure):
        img_exp[order[i * step: (i + 1) * step]] = e
    img_exp[order[step * len(exposure):]] = exposure[-1]
    np.save(os.path.join(dir_tgt, "cam", "exposure.npy"), img_exp)

    for p, e in zip(paths, img_exp):
        hdr = read_exr(p)[..., :3]
        ldr = apply_crf(np.clip(hdr * e, 0, 1), curves)
        stem = os.path.splitext(os.path.basename(p))[0]
        save_image(ldr, os.path.join(dir_tgt, stem + ".png"))


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--dir_src", required=True)
    parser.add_argument("--dir_tgt", required=True)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    convert(args.dir_src, args.dir_tgt, sample_crfs(args.seed))
    print("[hdr2ldr] wrote", args.dir_tgt)


if __name__ == "__main__":
    main()
