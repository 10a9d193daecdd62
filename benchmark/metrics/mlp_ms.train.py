"""Device milliseconds a training step of the MLP's forward passes (span
mlp.apply), from the training chunk graph's last replay."""

from benchmark.metrics import _program as P


def read(t):
    return P.unit_ms(P.TRAIN, ["mlp.apply"])
