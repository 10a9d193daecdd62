"""EMoR (Empirical Model of Response) basis loading (counterpart of
iris_tpu/models/emor.py).

data_files/emor.txt and invemor.txt are the public EMoR model data from the
Columbia CAVE "Modeling the Space of Camera Response Functions" project
(Grossberg & Nayar, PAMI 2004), shipped unmodified. Each record is a name
line followed by 256 lines x 4 numbers = 1024 samples.
"""

from __future__ import annotations

import functools
import os

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "data_files")


@functools.lru_cache(maxsize=4)
def parse_emor_file(inv: bool = False):
    """(names (C,), vectors (C, 1024)): vectors[0] is the sample grid E,
    vectors[1] the mean curve f0, vectors[2:] the PCA basis h(i); `inv`
    reads the inverse-response model."""
    path = os.path.join(_DATA_DIR, "invemor.txt" if inv else "emor.txt")
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    stride = 1 + 256
    names, vectors = [], []
    for i in range(len(lines) // stride):
        names.append(lines[i * stride].split("=")[0].strip())
        nums = []
        for ln in lines[i * stride + 1:(i + 1) * stride]:
            nums.extend(ln.split())
        vectors.append(np.asarray(nums, dtype=np.float32))
    return np.asarray(names), np.stack(vectors)


def emor_mean_and_basis(dim: int, inv: bool = False):
    """(f0 (1024,), basis (dim, 1024)) — what EmorCRF consumes."""
    _, vectors = parse_emor_file(inv=inv)
    return vectors[1].copy(), vectors[2:2 + dim].copy()
