"""Host milliseconds a training step of the batcher's spatial sort (span
batcher.sort) over the run."""

from benchmark.metrics import _program as P


def read(t):
    return P.host_ms_a_step("batcher.sort")
