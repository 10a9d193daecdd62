"""Host seconds of the program's BVH builds (span bvh.build) over the
run."""

from benchmark.metrics import _program as P


def read(t):
    return P.host_s("bvh.build")
