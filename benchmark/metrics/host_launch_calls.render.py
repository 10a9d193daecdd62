"""The host's kernel-launch and graph-launch calls a unit, from the
profiler's runtime events. The unit is a render round."""


def read(t):
    return t.get("host_launch_calls")
