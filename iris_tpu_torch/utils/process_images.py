"""Standalone dataset-image resize tool (counterpart of
iris_tpu/utils/process_images.py, host PIL, the same bytes).

Parity: reference utils/dataset/scannetpp/process.py — downscale every
image in a directory to at most --max_width (aspect preserved) before
training on ScanNet++ DSLR captures. Area-average downsampling (the
closest match to cv2.INTER_AREA the reference relies on for photographs).

Every file of --input that PIL can identify is written under the same name
to --output; directories and files that are not images are skipped. The
JAX tool skips any file whose read raises; here a file PIL identifies but
cannot read (a truncated PNG) raises, so a damaged capture is not dropped
without a word.

Usage: python -m iris_tpu_torch.utils.process_images --input <dir>
           --output <dir> [--max_width 1024] [--nearest]
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np
from PIL import Image, UnidentifiedImageError


def resize_max_width(img: np.ndarray, max_width: int,
                     nearest: bool = False) -> np.ndarray:
    """nearest=True for LABEL images (semantic/part masks): area
    averaging would invent fractional label ids at region borders."""
    h, w = img.shape[:2]
    if w <= max_width:
        return img
    w_new = max_width
    h_new = int(max_width / w * h)
    pil = Image.fromarray(img)
    return np.asarray(pil.resize((w_new, h_new),
                                 Image.NEAREST if nearest else Image.BOX))


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--input", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--max_width", type=int, default=1024)
    parser.add_argument("--nearest", action="store_true",
                        help="nearest-neighbor resampling (label masks)")
    args = parser.parse_args(argv)

    os.makedirs(args.output, exist_ok=True)
    names = sorted(os.listdir(args.input))
    n = 0
    for name in names:
        src = os.path.join(args.input, name)
        if not os.path.isfile(src):
            continue
        try:
            pil = Image.open(src)
        except UnidentifiedImageError:
            continue
        with pil:
            img = np.asarray(pil)
        out = resize_max_width(img, args.max_width, args.nearest)
        Image.fromarray(out).save(os.path.join(args.output, name))
        n += 1
    print(f"[process_images] wrote {n} images to {args.output}")


if __name__ == "__main__":
    main()
