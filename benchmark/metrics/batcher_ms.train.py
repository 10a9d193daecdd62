"""Host milliseconds a step inside RayBatcher's next(), over the window's
steps. The unit is a training step."""


def read(t):
    return t.get("batcher_ms")
