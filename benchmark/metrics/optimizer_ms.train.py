"""Device milliseconds a training step of the optimizer's update (span
optim.adam), from the training chunk graph's last replay."""

from benchmark.metrics import _program as P


def read(t):
    return P.unit_ms(P.TRAIN, ["optim.adam"])
