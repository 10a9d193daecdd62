"""Device milliseconds a training step of the losses' weighted segment
means (span loss.segment_means: the per-part means, the albedo anchor's
target and the propagation loss's per-segment means), from the training
chunk graph's last replay."""

from benchmark.metrics import _program as P


def read(t):
    return P.unit_ms(P.TRAIN, ["loss.segment_means"])
