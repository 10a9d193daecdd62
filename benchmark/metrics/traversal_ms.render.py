"""Device milliseconds a unit of the seven traversal kernels of
csrc/traverse.cu. The unit is a render round."""


def read(t):
    return t.get("traversal_ms")
