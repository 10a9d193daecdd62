"""Host seconds of the program's CUDA graph captures (span graph.capture)
over the run."""

from benchmark.metrics import _program as P


def read(t):
    return P.host_s("graph.capture")
