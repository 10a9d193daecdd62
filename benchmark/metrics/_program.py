"""What the readers of the program's own spans and counters share. They
read iris_tpu_torch.utils.profiling.report() after the cell's run has
returned: the device spans and counts of a graph's last replay, the host
spans and the counters over the whole run. Each function returns None
where the program recorded nothing to read (nothing was captured, as on
the CPU, or the program has no such span or counter)."""

from __future__ import annotations

TRAIN = ("train_chunk", "train.steps")     # a graph and its unit counter
RENDER = ("render_round", "render.rounds")


def report():
    from iris_tpu_torch.utils import profiling

    read = getattr(profiling, "report", None)
    return read() if read else None


def _graph(unit):
    r = report()
    g = r and r["graphs"].get(unit[0])
    n = g and g["counts"].get(unit[1])
    return (g, n) if n else (None, None)


def unit_ms(unit, names, key="ms"):
    """Milliseconds a unit of the spans `names` in the last replay of the
    unit's graph (key "self_ms": their self time)."""
    g, n = _graph(unit)
    got = [g["spans"][s][key] for s in names if g and s in g["spans"]]
    return sum(got) / n if got else None


def gather_gbps(unit):
    """The table bytes the hash grid's encodes need (the counter
    hashgrid.gather_bytes: corners x features at the precision the mode
    reads, no index arrays) over their time, in GB/s, in the last replay
    of the unit's graph: an encode that does the same reads in less time
    reads higher."""
    g, _ = _graph(unit)
    nbytes = g and g["counts"].get("hashgrid.gather_bytes")
    enc = g and g["spans"].get("hashgrid.encode")
    if not nbytes or not enc or enc["ms"] <= 0:
        return None
    return nbytes / (enc["ms"] * 1e-3) / 1e9


def host_ms_a_step(name):
    """Host milliseconds of span `name` over the run, a training step."""
    r = report()
    h = r and r["host"].get(name)
    n = r and r["counts"].get("train.steps")
    return 1e3 * h["s"] / n if h and n else None


def host_s(name):
    """Host seconds of span `name` over the run."""
    r = report()
    h = r and r["host"].get(name)
    return h["s"] if h else None
