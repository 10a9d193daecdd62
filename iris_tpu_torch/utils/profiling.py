"""The port's tracing: spans and counters at the boundaries where the work
is done, which also see into a CUDA graph replay, and device-trace
capture over torch.profiler (counterpart of iris_tpu/utils/profiling.py).

Spans and counters:

    from iris_tpu_torch.utils import profiling
    with profiling.span("hashgrid.encode"):
        profiling.count("hashgrid.gather_bytes", nbytes)
        ...
    profiling.report()

- span(name) adds its host seconds and one call to a process-wide total
  per name (its self seconds too: its time less that of the spans opened
  inside it on its own thread), and, while a profiler records, opens
  torch.profiler.record_function(name), so that the trace shows it on its
  own clock with the eager kernels under it. With no profiler recording
  it opens none: a record_function costs the host about 0.1 ms around a
  batcher's numpy work, and the batcher runs with the card idle.
- Inside a capture (capturing(), which utils/graphs.Graph opens around
  each capture) a span also records a timing CUDA event on the current
  stream at its entry and at its exit. Recorded as external events, they
  become event-record nodes of the graph: no kernel, no host work at
  replay, and every replay stamps them again. Outside a capture a span
  records no device event. A range open on the host while a graph was
  captured is gone from a profiler's trace of its replay; these marks are
  what remains of it.
- count(name, n) adds a host integer computed from shapes: to the
  process-wide totals in eager code, to the graph's per-replay tally
  inside a capture, which each replay of the graph adds to the
  process-wide totals.
- report() synchronises the card and returns a plain dict:
  {"graphs": {graph name: {"counts": the tally a replay adds,
  "spans": {span: {"calls", "ms", "self_ms"}} of the last replay of a
  graph of that name}}, "host": {span: {"calls", "s", "self_s"}},
  "counts": the process-wide counters, eager and replayed}. A device
  span's self time is its duration less its child spans' (the marks lie
  on one stream, in the order they were recorded, so children nest
  inside their parent and follow each other); spans opened in a backward
  pass, on autograd's engine thread, nest in the same order.

There is no switch: the marks are in every captured graph. The few calls
that need the card are the module's _cuda_* functions, so that the CPU
tests can exercise the rest with stand-ins.

Device-trace capture:

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
import functools
import os
import threading
import time

import torch
from torch.profiler import ProfilerActivity, profile

from iris_tpu_torch.device import resolve_device


def _cuda_event():
    """A timing event that a capture records as an event-record node."""
    return torch.cuda.Event(enable_timing=True, external=True)


def _cuda_synchronize():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Capture:
    """What one graph's capture recorded: its name, its marks (opening,
    span name, event) in record order, and the counts a replay adds."""

    def __init__(self, name: str):
        self.name = name
        self.marks: list = []
        self.tally: dict = {}

    def mark(self, opening: bool, name: str) -> None:
        ev = _cuda_event()
        ev.record()
        self.marks.append((opening, name, ev))

    def spans(self) -> dict:
        """{span: {"calls", "ms", "self_ms"}} of the last replay, from the
        marks' offsets to the first mark."""
        out: dict = {}
        if not self.marks:
            return out
        first = self.marks[0][2]
        open_: list = []                  # [name, start ms, children's ms]
        for opening, name, ev in self.marks:
            t = first.elapsed_time(ev)
            if opening:
                open_.append([name, t, 0.0])
                continue
            name, t0, inner = open_.pop()
            ms = t - t0
            rec = out.setdefault(name, {"calls": 0, "ms": 0.0,
                                        "self_ms": 0.0})
            rec["calls"] += 1
            rec["ms"] += ms
            rec["self_ms"] += ms - inner
            if open_:
                open_[-1][2] += ms
        return out


class _Totals:
    """The process-wide record: host spans by name, counters, the capture
    open now, and the capture of each graph name that replayed last."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.host: dict = {}
        self.counts: dict = {}
        self.capture: Capture | None = None
        self.last: dict = {}

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_T = _Totals()


class Span:
    """An open span: its name and, once closed, its host seconds."""

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self.inner = 0.0                   # seconds of the spans inside it


@contextlib.contextmanager
def span(name: str):
    """Time the block as span `name` (module docstring). Yields the
    Span."""
    s = Span(name)
    stack = _T.stack()
    cap = _T.capture
    with (torch.profiler.record_function(name)
          if torch.autograd._profiler_enabled()
          else contextlib.nullcontext()):
        if cap is not None:
            cap.mark(True, name)
        stack.append(s)
        t0 = time.perf_counter()
        try:
            yield s
        finally:
            s.seconds = time.perf_counter() - t0
            stack.pop()
            if cap is not None:
                cap.mark(False, name)
            if stack:
                stack[-1].inner += s.seconds
            with _T.lock:
                rec = _T.host.setdefault(name, {"calls": 0, "s": 0.0,
                                                "self_s": 0.0})
                rec["calls"] += 1
                rec["s"] += s.seconds
                rec["self_s"] += s.seconds - s.inner


def spanned(name: str):
    """Decorator: every call of the function is span `name`."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call

    return wrap


def count(name: str, n: int) -> None:
    """Add n to counter `name` (module docstring)."""
    with _T.lock:
        cap = _T.capture
        to = cap.tally if cap is not None else _T.counts
        to[name] = to.get(name, 0) + int(n)


@contextlib.contextmanager
def capturing(name: str):
    """The capture of graph `name`: the block runs inside a
    `graph.capture` span, and the spans and counts inside it are the
    graph's. Yields (the Capture, the graph.capture Span)."""
    if _T.capture is not None:
        raise RuntimeError(f"graph {name!r} captured inside the capture of "
                           f"{_T.capture.name!r}")
    cap = Capture(name)
    with span("graph.capture") as s:
        _T.capture = cap
        try:
            yield cap, s
        finally:
            _T.capture = None


def replayed(cap: Capture) -> None:
    """The graph that `cap` records replays: its marks are stamped anew,
    its tally added to the process-wide counters."""
    with _T.lock:
        _T.last[cap.name] = cap
        for name, n in cap.tally.items():
            _T.counts[name] = _T.counts.get(name, 0) + n


def report() -> dict:
    """The spans and counters recorded so far (module docstring)."""
    _cuda_synchronize()
    with _T.lock:
        host = {k: dict(v) for k, v in _T.host.items()}
        counts = dict(_T.counts)
        last = dict(_T.last)
    return {"graphs": {name: {"counts": dict(cap.tally),
                              "spans": cap.spans()}
                       for name, cap in last.items()},
            "host": host, "counts": counts}


def reset() -> None:
    """Forget every span and counter (a capture open now is kept)."""
    with _T.lock:
        _T.host.clear()
        _T.counts.clear()
        _T.last.clear()


def available() -> bool:
    """Whether torch.profiler can record (its Kineto back end is built
    in): the CUDA activity then comes with it on the card."""
    return torch.autograd.kineto_available()


@contextlib.contextmanager
def device_trace(logdir: str, name: str = "trace", device=None):
    """Profile the block and write `logdir`/`name`.json (logdir created if
    needed); yields the torch.profiler.profile, whose key_averages() the
    caller may read after the block. `device`: the device the block runs
    on (default: the card), whose activity is recorded with the CPU's.

    The trace shows host spans as ranges on its own clock, eager kernels
    under them. A graph replay shows as one launch and its kernels, with
    none of the ranges that were open at its capture; its device spans
    are in report(), timed from the replay's own marks: each mark an
    offset from the replay's first mark, which lies just before the
    replay's first kernel."""
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
