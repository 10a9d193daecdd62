"""Launches of the hash grid's encode kernel a render round (the counter
hashgrid.encode_kernel: every exact 8-corner forward on the card, one
launch each), from the render round graph's last replay."""

from benchmark.metrics import _program as P


def read(t):
    g, n = P._graph(P.RENDER)
    k = g and g["counts"].get("hashgrid.encode_kernel")
    return k / n if k else None
