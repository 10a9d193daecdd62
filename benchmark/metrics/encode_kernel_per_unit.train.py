"""Launches of the hash grid's encode kernel a training step (the counter
hashgrid.encode_kernel: every exact 8-corner forward on the card, one
launch each), from the training chunk graph's last replay."""

from benchmark.metrics import _program as P


def read(t):
    g, n = P._graph(P.TRAIN)
    k = g and g["counts"].get("hashgrid.encode_kernel")
    return k / n if k else None
