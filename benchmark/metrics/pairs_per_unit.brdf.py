"""Partner pairs the semantic propagation loss draws a training step (the
counter loss.partner_pairs: batch x n_pairs a call), from the training
chunk graph's last replay."""

from benchmark.metrics import _program as P


def read(t):
    g, n = P._graph(P.TRAIN)
    k = g and g["counts"].get("loss.partner_pairs")
    return k / n if k else None
