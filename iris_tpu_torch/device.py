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


def describe(device) -> dict:
    """What a printed result names its device by: the card's name and power
    limit as `nvidia-smi --query-gpu=name,power.limit` reads them (a card
    set below its maximum power runs slower under load), or {"name":
    "cpu"}. The power limit is None where nvidia-smi cannot be run."""
    import subprocess

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"name": str(dev)}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    power = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=60, check=True)
        power = out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        pass
    return {"name": torch.cuda.get_device_name(index), "power_limit": power}
