"""Device milliseconds a render round of the hash-grid encode (span
hashgrid.encode), from the render round graph's last replay."""

from benchmark.metrics import _program as P


def read(t):
    return P.unit_ms(P.RENDER, ["hashgrid.encode"])
