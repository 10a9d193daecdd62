"""Device milliseconds a training step of the stage's shading of the baked
caches and its camera response (span loss.shade), from the training chunk
graph's last replay."""

from benchmark.metrics import _program as P


def read(t):
    return P.unit_ms(P.TRAIN, ["loss.shade"])
