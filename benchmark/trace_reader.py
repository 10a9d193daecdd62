"""Reading torch.profiler's trace of a few steady units: device kernels,
the host's launch calls, the union of the kernels' intervals (so that
kernels that overlap count once), and the longest idle gaps with what the
host was doing in each. The trace is written to a temporary file, read
and deleted."""

from __future__ import annotations

import json
import os
import tempfile

UNIT = "bench_unit"
# the seven traversal kernels, by their names in csrc/traverse.cu
TRAVERSAL = ("trace_union_kernel", "trace_paired_kernel",
             "trace_dense_kernel", "trace_ordered_kernel",
             "trace_paired_streamed_kernel", "trace_dense_streamed_kernel",
             "trace_streamed_kernel")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
            "cudaGraphLaunch", "cuGraphLaunch")


def is_traversal(name: str) -> bool:
    return any(k in name for k in TRAVERSAL)


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def summarize(evs: list, units: int) -> dict:
    """The per-unit numbers and the breakdown of the traced units (every
    one inside a `bench_unit` range on the host)."""
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in evs
              if e.get("ph") == "X" and e.get("name") == UNIT
              and e.get("cat") != "gpu_user_annotation"]
    if not ranges or units <= 0:
        return {}
    w0, w1 = min(s for s, _ in ranges), max(e for _, e in ranges)
    kern = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in evs
            if e.get("ph") == "X" and e.get("cat") == "kernel"
            and w0 <= e["ts"] < w1]
    busy = union([(max(s, w0), min(e, w1)) for s, e, _ in kern])
    busy_us = sum(e - s for s, e in busy)
    wall_us = w1 - w0
    trav = sum(e - s for s, e, n in kern if is_traversal(n))
    other = sum(e - s for s, e, n in kern if not is_traversal(n))
    launches = sum(1 for e in evs if e.get("cat") == "cuda_runtime"
                   and e.get("name") in LAUNCHES and w0 <= e["ts"] < w1)
    by_name: dict = {}
    for s, e, n in kern:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in evs
            if e.get("ph") == "X" and e.get("cat") in (
                "cpu_op", "user_annotation", "cuda_runtime", "python_function")
            and e.get("name") != UNIT]
    gaps = []
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    labelled = []
    for s, e in gaps:
        mid = (s + e) / 2
        inside = [h for h in host if h[0] <= mid < h[1]]
        label = max(inside, key=lambda h: h[0])[2] if inside else "host idle"
        labelled.append([label, (e - s) / 1e6])
    return {
        "units": units, "wall_s": wall_us / 1e6, "busy_s": busy_us / 1e6,
        "idle_share": 1.0 - busy_us / wall_us,
        "kernels_per_unit": len(kern) / units,
        "traversal_ms": trav / units / 1e3,
        "models_ms": other / units / 1e3,
        "host_launch_calls": launches / units,
        "breakdown": {"device_ops": [[n, us / 1e6] for n, us in ops],
                      "idle_gaps": labelled},
    }
