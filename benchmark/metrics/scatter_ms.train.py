"""Device milliseconds a training step of the order-fixed segment sums
(span segment.sum: the encode's backward scatter and every other), from
the training chunk graph's last replay."""

from benchmark.metrics import _program as P


def read(t):
    return P.unit_ms(P.TRAIN, ["segment.sum"])
