"""Device kernels a unit, graph replays included, from the profiler. The
unit is a render round."""


def read(t):
    return t.get("kernels_per_unit")
