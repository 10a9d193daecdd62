"""Stand-ins for the CUDA calls of iris_tpu_torch.utils.graphs (its
_cuda_* functions), so that the CPU tests run its capture and replay
logic: a captured function runs once at capture, where the card records
its launches, and again at every replay, where the card issues them."""

import contextlib

import torch


class Stream:
    def wait_stream(self, other):
        pass


class Graph:
    """A graph whose replay re-runs the captured function (rerun=False:
    runs nothing, to watch what the replay itself does)."""

    def __init__(self, rerun=True):
        self.fn, self.rerun, self.replays, self.generators = None, rerun, 0, []

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1
        if self.rerun:
            self.fn()


class Event:
    def __init__(self, enable_timing=False):
        self.enable_timing = enable_timing

    def record(self):
        pass

    def synchronize(self):
        pass


def capture(graph, pool, stream, fn):
    graph.fn = fn
    return fn()


def use(monkeypatch, rerun=True):
    """Put the stand-ins in place; returns the list the graphs made are
    appended to."""
    from iris_tpu_torch.utils import graphs

    made = []

    def new_graph():
        made.append(Graph(rerun))
        return made[-1]

    for name, fn in (("_cuda_stream", lambda device: Stream()),
                     ("_cuda_current_stream", lambda device: Stream()),
                     ("_cuda_on", lambda stream: contextlib.nullcontext()),
                     ("_cuda_pool", lambda: None),
                     ("_cuda_graph", new_graph),
                     ("_cuda_capture", capture),
                     ("_cuda_event", Event),
                     ("_cuda_pinned", lambda n: torch.empty(
                         n, dtype=torch.uint8))):
        monkeypatch.setattr(graphs, name, fn)
    return made
