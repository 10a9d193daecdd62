"""1 - the union of the kernels' intervals over the wall time of the traced
units. The unit is a render round."""


def read(t):
    return t.get("idle_share")
