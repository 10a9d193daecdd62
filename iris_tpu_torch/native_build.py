"""Compile a native source of the port into a shared library at first use.

Outputs go to iris_tpu_torch/build/ (listed in .gitignore), so a fresh
checkout builds everything it runs from the sources it holds. A library is
rebuilt when it is older than its source. Each build writes a file of its
own and renames it into place, so concurrent processes (test workers) never
load a half-written library. A failed build raises: nothing falls back.
"""

from __future__ import annotations

import os
import shutil
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


def nvcc(what: str) -> str:
    """The CUDA compiler: nvcc on PATH, else under CUDA_HOME
    (/usr/local/cuda). Raises, naming `what` cannot be built, if neither
    has it."""
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found: {what} cannot be built (set "
                           "CUDA_HOME or put nvcc on PATH)")
    return path


def build_shared(cmd: list[str], src: str, name: str,
                 timeout: float = 600.0) -> tuple[str, str]:
    """Run `cmd + [src, "-o", out]` unless BUILD_DIR/name is up to date.

    Returns (path of the library, the compiler's output; "" when the
    library was already up to date)."""
    src = os.path.abspath(src)
    if not os.path.exists(src):
        raise FileNotFoundError(f"native source missing: {src}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, name)
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so, ""
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run(cmd + [src, "-o", tmp], capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {name} failed ({' '.join(cmd)}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    return so, proc.stdout + proc.stderr
