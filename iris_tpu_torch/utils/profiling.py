"""Device-trace capture (counterpart of iris_tpu/utils/profiling.py, over
torch.profiler):

    from iris_tpu_torch.utils.profiling import device_trace
    with device_trace("outputs/trace_encode") as prof:
        step()
        torch.cuda.synchronize()
    prof.key_averages()

writes outputs/trace_encode/trace.json, a Chrome trace of the CPU and, on
the card, the CUDA activity (it opens in Perfetto, ui.perfetto.dev, or
chrome://tracing). The JAX version runs unprofiled when the backend cannot
trace; this one raises, so that a run asked for a trace never comes back
without one.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile

from iris_tpu_torch.device import resolve_device


def available() -> bool:
    """Whether torch.profiler can record (its Kineto back end is built
    in): the CUDA activity then comes with it on the card."""
    return torch.autograd.kineto_available()


@contextlib.contextmanager
def device_trace(logdir: str, name: str = "trace", device=None):
    """Profile the block and write `logdir`/`name`.json (logdir created if
    needed); yields the torch.profiler.profile, whose key_averages() the
    caller may read after the block. `device`: the device the block runs
    on (default: the card), whose activity is recorded with the CPU's."""
    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, name + ".json")
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
    print(f"[profiling] trace written to {path}")
