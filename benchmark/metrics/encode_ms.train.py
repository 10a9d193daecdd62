"""Device milliseconds a training step of the hash-grid encode's forward
passes (span hashgrid.encode), from the training chunk graph's last replay."""

from benchmark.metrics import _program as P


def read(t):
    return P.unit_ms(P.TRAIN, ["hashgrid.encode"])
