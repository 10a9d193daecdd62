"""Device milliseconds a unit of the seven traversal kernels of
csrc/traverse.cu. The unit is a training step."""


def read(t):
    return t.get("traversal_ms")
