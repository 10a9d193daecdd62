"""Device milliseconds a unit of every kernel but the seven traversal
kernels. The unit is a training step."""


def read(t):
    return t.get("models_ms")
