"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds its tensors on.

    None means the card: the port is written for the GPU, and a silent
    move to the CPU would hide a missing card behind slow plain code. CPU
    runs (the parity tests) ask for it with device="cpu"."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "iris_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions")
    return dev
