"""CUDA graphs: many steps in one dispatch (the port's counterpart of one
jitted lax.scan, iris_tpu/train/loop.py:55-90 and
iris_tpu/utils/timing.py:91-115).

A training step of the port is about a thousand kernel launches, and on
the card the host takes longer to issue them than the card takes to run
them. A CUDA graph records the launches of a function once (capture) and
issues all of them again with one call (replay). train.loop.
make_train_chunk captures K optimizer steps, utils.timing.bench_scan
`iters` benchmark calls. What a graph holds static, and how each replay
stays the eager run's:

- Inputs. A replay reads the tensors the capture read, at the same
  addresses: the parameters and the optimizer state (updated in place),
  and StaticBatches, the (K, B, ...) batch columns of a chunk in one
  device buffer, filled before each replay by ONE host-to-device copy
  from pinned memory (the JAX package's one device_put of the stacked
  chunk, loop.py:146-148).
- Generators. Each call slot draws from a torch.Generator of its own,
  registered with the graph (CUDAGraph.register_generator_state) and
  reseeded before every replay: its Philox seed and offset are read at
  replay time, so slot j of a replay draws what a fresh generator with
  that seed draws eagerly (train.loop.step_generator). No draw may use
  the default generator or an unregistered one.
- Memory. Every graph of a GraphContext allocates from one pool
  (torch.cuda.graph_pool_handle): what a graph's calls free during its
  capture is reused inside it, and the outputs it returns live there,
  overwritten by the next replay.
- Warm-up. Work that must not fall inside a capture (a kernel library's
  build, Adam's lazily made state, cuBLAS's workspace of the capture
  stream, a grid's level constants) happens in an eager run on the
  context's stream first (GraphContext.on_stream).
- Launch counts. The traversal kernels count their own launches and
  rays on the card (geometry/cuda_intersect.py, kernel_counts), so a
  replay counts the launches it runs and a capture, which runs nothing,
  counts none; nothing here accounts for them.
- Observers. observing(observer) tells an instrument of every capture
  and replay (their host seconds, seeds and CUDA events), so that timers
  and checks read graphs without reaching into this module.
- No fallback. A capture or replay that fails raises; nothing runs the
  steps eagerly in its place.

The few calls that need the card are the module's _cuda_* functions, so
that the CPU tests can exercise the rest with stand-ins.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


def _cuda_stream(device):
    return torch.cuda.Stream(device)


def _cuda_current_stream(device):
    return torch.cuda.current_stream(device)


def _cuda_on(stream):
    return torch.cuda.stream(stream)


def _cuda_pool():
    return torch.cuda.graph_pool_handle()


def _cuda_graph():
    return torch.cuda.CUDAGraph()


def _cuda_capture(graph, pool, stream, fn):
    """fn()'s launches recorded into graph (none run); fn's result."""
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        return fn()


def _cuda_event(enable_timing=False):
    return torch.cuda.Event(enable_timing=enable_timing)


def _cuda_pinned(nbytes):
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


_OBSERVERS: list = []


@contextlib.contextmanager
def observing(observer):
    """While active, `observer` is told of every capture and replay of a
    Graph: observer.captured(graph) once a capture is done (graph.
    capture_s holds its host seconds), observer.replayed(graph, seeds,
    start, end) once a replay is queued, start and end being timing CUDA
    events recorded on the caller's stream just before and after it (the
    replay's outputs are graph.outputs until the next one). Yields the
    observer."""
    _OBSERVERS.append(observer)
    try:
        yield observer
    finally:
        _OBSERVERS.remove(observer)


class GraphContext:
    """The stream, memory pool and warm-up state that the graphs of one run
    share, on one card."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = _cuda_stream(self.device)
        self.pool = _cuda_pool()
        self.warm = False

    @contextlib.contextmanager
    def on_stream(self):
        """Run the block's eager work on the capture stream (the warm-up),
        ordered after the caller's stream and before its later work."""
        caller = _cuda_current_stream(self.device)
        self.stream.wait_stream(caller)
        with _cuda_on(self.stream):
            yield
        caller.wait_stream(self.stream)

    def capture(self, fn, generators=()) -> "Graph":
        """Capture fn() into a Graph of this context (its outputs are
        Graph.outputs). The context must be warm."""
        if not self.warm:
            raise RuntimeError("a graph is captured after a warm-up run on "
                               "its context's stream (on_stream)")
        return Graph(self, fn, generators)


class Graph:
    """One captured CUDA graph: its outputs, its registered generators and
    the host seconds its capture took (capture_s)."""

    def __init__(self, ctx: GraphContext, fn, generators=()):
        self.graph = _cuda_graph()
        self.generators = list(generators)
        for gen in self.generators:
            self.graph.register_generator_state(gen)
        t0 = time.perf_counter()
        self.outputs = _cuda_capture(self.graph, ctx.pool, ctx.stream, fn)
        self.capture_s = time.perf_counter() - t0
        for observer in list(_OBSERVERS):
            observer.captured(self)

    def replay(self, seeds=()):
        """Reseed the slot generators (one seed each) and replay on the
        caller's stream; returns the outputs, which the next replay
        overwrites."""
        seeds = list(seeds)
        if len(seeds) != len(self.generators):
            raise ValueError(f"{len(seeds)} seeds for "
                             f"{len(self.generators)} generators")
        for gen, seed in zip(self.generators, seeds):
            gen.manual_seed(seed)
        if not _OBSERVERS:
            self.graph.replay()
            return self.outputs
        start, end = _cuda_event(True), _cuda_event(True)
        start.record()
        self.graph.replay()
        end.record()
        for observer in list(_OBSERVERS):
            observer.replayed(self, seeds, start, end)
        return self.outputs


class StaticBatches:
    """The batch columns a captured chunk reads: K batch dicts of equal
    keys, shapes and dtypes, each column held as one (K, ...) tensor
    inside a single device buffer, with a pinned host twin. fill() stacks
    a chunk's numpy arrays (or CPU tensors) into the pinned buffer and
    copies the whole of it to the card in one copy, on the caller's
    stream; a column of CUDA tensors is stacked on the card. None stays
    None. views[j] is step j's batch dict."""

    ALIGN = 256

    def __init__(self, batches, device):
        self.k = len(batches)
        self.device = torch.device(device)
        self.layout, self.device_cols, offset = {}, {}, 0
        for key, v in batches[0].items():
            if v is None:
                continue
            if isinstance(v, torch.Tensor) and v.device.type == "cuda":
                self.device_cols[key] = torch.empty(
                    (self.k,) + tuple(v.shape), dtype=v.dtype,
                    device=self.device)
                continue
            a = np.asarray(v)
            dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
            nbytes = self.k * a.nbytes
            self.layout[key] = (offset, a.shape, a.dtype, dtype, nbytes)
            offset += -(-nbytes // self.ALIGN) * self.ALIGN
        self.host = _cuda_pinned(offset)
        self.buf = torch.empty(offset, dtype=torch.uint8, device=self.device)
        cols = dict(self.device_cols)
        for key, (off, shape, _, dtype, nbytes) in self.layout.items():
            cols[key] = self.buf[off:off + nbytes].view(dtype).view(
                (self.k,) + tuple(shape))
        self.keys = tuple(batches[0])
        self.views = [{key: (cols[key][j] if key in cols else None)
                       for key in self.keys} for j in range(self.k)]
        self._copied = None

    def fill(self, batches) -> None:
        if len(batches) != self.k:
            raise ValueError(f"{len(batches)} batches for a chunk of "
                             f"{self.k}")
        for b in batches:
            if tuple(b) != self.keys or any(
                    (b[key] is None) != (self.views[0][key] is None)
                    for key in self.keys):
                raise ValueError(f"batch keys {tuple(b)} differ from the "
                                 f"captured chunk's {self.keys}")
        if self._copied is not None:     # the last copy has left the buffer
            self._copied.synchronize()
        host = self.host.numpy()
        for key, (off, shape, np_dtype, _, nbytes) in self.layout.items():
            out = host[off:off + nbytes].view(np_dtype).reshape(
                (self.k,) + tuple(shape))
            cols = [np.asarray(b[key]) for b in batches]
            if any(c.shape != tuple(shape) or c.dtype != np_dtype
                   for c in cols):
                raise ValueError(f"batch column {key!r} changed shape or "
                                 "dtype since the capture")
            np.stack(cols, out=out)
        if self.layout:
            self.buf.copy_(self.host, non_blocking=True)
            self._copied = _cuda_event()
            self._copied.record()
        for key, col in self.device_cols.items():
            col.copy_(torch.stack([b[key] for b in batches]))
