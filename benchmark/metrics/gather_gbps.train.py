"""GB/s of the table reads the hash grid's encodes need in a training step
(the counter hashgrid.gather_bytes) over their time (the span
hashgrid.encode), from the training chunk graph's last replay."""

from benchmark.metrics import _program as P


def read(t):
    return P.gather_gbps(P.TRAIN)
