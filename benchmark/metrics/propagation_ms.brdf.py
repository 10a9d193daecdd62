"""Device milliseconds a training step of the semantic propagation loss:
its forward (span loss.propagation, the per-pixel segment means inside
it included) and the backward of its partner gathers (span
loss.propagation_bwd), from the training chunk graph's last replay."""

from benchmark.metrics import _program as P


def read(t):
    return P.unit_ms(P.TRAIN, ["loss.propagation", "loss.propagation_bwd"])
