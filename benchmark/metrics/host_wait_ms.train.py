"""Host milliseconds a training step spent waiting for a chunk's losses
(span train.sync) over the run."""

from benchmark.metrics import _program as P


def read(t):
    return P.host_ms_a_step("train.sync")
