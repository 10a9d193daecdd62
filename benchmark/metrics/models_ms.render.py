"""Device milliseconds a unit of every kernel but the seven traversal
kernels. The unit is a render round."""


def read(t):
    return t.get("models_ms")
