"""iris_tpu_torch — the PyTorch/CUDA port of iris_tpu.

A second package beside ``iris_tpu/`` (the JAX reference, which it never
imports). Module names mirror ``iris_tpu/`` so each file has an obvious
counterpart. Plain tensor code is PyTorch; the BVH traversal kernels that
the JAX package writes in Pallas are hand-written CUDA C++ for Hopper
(``csrc/traverse.cu``, bound in ``geometry/cuda_intersect.py``).

Entry points default to ``device="cuda"`` and raise when no card is
present; pass ``device="cpu"`` to run the plain PyTorch versions.
"""

__version__ = "0.1.0"

from iris_tpu_torch.const import GAMMA, RAY_EPS, SEED  # noqa: F401
