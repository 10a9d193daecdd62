"""Device milliseconds a training step of the hash-grid encode's backward
passes, their scatters included (span hashgrid.encode_bwd), from the
training chunk graph's last replay."""

from benchmark.metrics import _program as P


def read(t):
    return P.unit_ms(P.TRAIN, ["hashgrid.encode_bwd"])
