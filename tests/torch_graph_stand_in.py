"""Stand-ins for the CUDA calls of iris_tpu_torch.utils.graphs (its
_cuda_* functions), so that the CPU tests run its capture and replay
logic: a captured function runs once at capture, where the card records
its launches, and again at every replay, where the card issues them. As
on the card, a capture draws nothing from the registered generators (a
replay draws from their state at replay time) and a replay writes its
results into the tensors the capture returned."""

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
        self.outputs = None

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1
        if self.rerun:
            _write_into(self.outputs, self.fn())


def _write_into(out, new):
    """Copy a replay's results into the captured outputs, in place."""
    if isinstance(out, torch.Tensor):
        out.copy_(new)
    elif isinstance(out, (tuple, list)):
        for a, b in zip(out, new):
            _write_into(a, b)
    elif isinstance(out, dict):
        for k in out:
            _write_into(out[k], new[k])


class Event:
    def __init__(self, enable_timing=False):
        self.enable_timing = enable_timing

    def record(self):
        pass

    def synchronize(self):
        pass


def capture(graph, pool, stream, fn):
    graph.fn = fn
    states = [g.get_state() for g in graph.generators]
    graph.outputs = fn()
    for g, state in zip(graph.generators, states):
        g.set_state(state)
    return graph.outputs


def use(monkeypatch, rerun=True):
    """Put the stand-ins in place (a capture's timing marks included);
    returns the list the graphs made are appended to."""
    from iris_tpu_torch.utils import graphs, profiling

    monkeypatch.setattr(profiling, "_cuda_event", lambda: Event(True))

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
