"""Rows the deterministic segment sums sort a training step (the counter
segment.rows: the hash grid's gradient scatter, the losses' segment means
and the propagation loss's gather backward), from the training chunk
graph's last replay."""

from benchmark.metrics import _program as P


def read(t):
    g, n = P._graph(P.TRAIN)
    k = g and g["counts"].get("segment.rows")
    return k / n if k else None
