"""Device milliseconds a render round of the integrator's own shading: the
self time of its first hits and bounces (spans integrator.first_hit and
integrator.bounce, less the intersects, encodes and MLPs inside them),
from the render round graph's last replay."""

from benchmark.metrics import _program as P


def read(t):
    return P.unit_ms(P.RENDER, ["integrator.first_hit", "integrator.bounce"],
                     "self_ms")
