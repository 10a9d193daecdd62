"""The port's spans and counters (iris_tpu_torch/utils/profiling.py): on
the CPU with stand-in events and a stand-in capture (the nesting and self
time of a replay's device spans, per-replay tallies, the report's shape,
host spans on two threads) and the benchmark's readers of them; on the
card (marked `cuda`, skips without one) a captured graph's spans against
the profiler's kernel times:

    python -m pytest --noconftest tests/test_torch_profiling.py -q
"""

import contextlib
import json
import os
import threading
import time

import pytest
import torch

import torch_graph_stand_in
from iris_tpu_torch.utils import graphs, profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Clock:
    """A device clock the test advances: each stand-in event records it."""

    def __init__(self):
        self.now = 0.0

    def event(self):
        clock = self

        class Event:
            def record(self):
                self.t = clock.now

            def elapsed_time(self, end):
                return end.t - self.t

        return Event()

    def work(self, ms):
        self.now += ms


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(profiling, "_cuda_event", c.event)
    profiling.reset()
    yield c
    profiling.reset()


def _unit(clock, stretch=1.0):
    """root (1 ms of its own) > a (2) > b (3), then a again (4): what one
    replay of the graph runs, each kernel `stretch` times as long."""
    with profiling.span("root"):
        profiling.count("units", 2)
        clock.work(1 * stretch)
        with profiling.span("a"):
            clock.work(2 * stretch)
            with profiling.span("b"):
                clock.work(3 * stretch)
        with profiling.span("a"):
            clock.work(4 * stretch)


def test_device_spans_nest_and_take_their_self_time(clock):
    """A capture's marks nest by their order on the stream: each span's
    calls, milliseconds and self milliseconds (its time less its
    children's, which add up to the root), and the counts a replay adds;
    each replay adds its tally to the process-wide counters; outside a
    capture a span records no device mark and a count goes to them
    directly."""
    with profiling.capturing("g") as (cap, sp):
        _unit(clock)
    assert len(cap.marks) == 8 and sp.seconds > 0
    assert profiling.report()["graphs"] == {}        # never replayed
    profiling.replayed(cap)
    got = profiling.report()
    assert set(got) == {"graphs", "host", "counts"}
    g = got["graphs"]["g"]
    assert g["counts"] == {"units": 2}
    assert g["spans"] == {
        "root": {"calls": 1, "ms": 10.0, "self_ms": 1.0},
        "a": {"calls": 2, "ms": 9.0, "self_ms": 6.0},
        "b": {"calls": 1, "ms": 3.0, "self_ms": 3.0}}
    assert sum(s["self_ms"] for s in g["spans"].values()) == 10.0
    assert got["counts"] == {"units": 2}
    assert got["host"]["a"]["calls"] == 2
    assert got["host"]["graph.capture"]["calls"] == 1
    _unit(clock)                                     # eager: host only
    assert len(cap.marks) == 8
    assert profiling.report()["counts"] == {"units": 4}
    profiling.replayed(cap)
    assert profiling.report()["counts"] == {"units": 6}
    assert profiling.report()["host"]["root"]["calls"] == 2


def test_graphs_record_their_capture_and_last_replay(clock, monkeypatch):
    """Graph opens the capture scope: its spans are its marks, its
    capture_s the graph.capture span's seconds; a replay notes which graph
    of its name ran last, whose marks the report reads (each replay
    stamps them again); a capture inside a capture raises."""
    torch_graph_stand_in.use(monkeypatch, rerun=False)
    monkeypatch.setattr(profiling, "_cuda_event", clock.event)
    ctx = graphs.GraphContext("cpu")
    ctx.warm = True
    one = ctx.capture(lambda: _unit(clock), name="unit")
    two = ctx.capture(lambda: _unit(clock, 2.0), name="unit")
    host = profiling.report()["host"]["graph.capture"]
    assert host["calls"] == 2
    assert host["s"] == pytest.approx(one.capture_s + two.capture_s)
    one.replay()
    assert profiling.report()["graphs"]["unit"]["spans"]["root"]["ms"] \
        == 10.0
    two.replay()
    assert profiling.report()["graphs"]["unit"]["spans"]["root"]["ms"] \
        == 20.0
    assert list(profiling.report()["graphs"]) == ["unit"]
    with profiling.capturing("outer"):
        with pytest.raises(RuntimeError, match="inside the capture"):
            ctx.capture(lambda: None, name="inner")


def test_host_spans_on_two_threads(clock):
    """A host span's parent is the innermost open span of its own thread:
    two threads that open their spans in turn each charge their child to
    their own parent."""
    turn = threading.Barrier(2, timeout=10)

    def worker(tag):
        with profiling.span("p" + tag):
            turn.wait()
            with profiling.span("c" + tag):
                time.sleep(0.02 if tag == "a" else 0.002)
                turn.wait()
            turn.wait()

    threads = [threading.Thread(target=worker, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    host = profiling.report()["host"]
    for tag in "ab":
        p, c = host["p" + tag], host["c" + tag]
        assert p["calls"] == c["calls"] == 1
        assert p["s"] - p["self_s"] == pytest.approx(c["s"], abs=1e-9)
        assert c["self_s"] == c["s"]


def test_spans_are_profiler_ranges_while_it_records(clock, monkeypatch):
    """A span is a range of a recording profiler's trace, and opens none
    with no profiler recording; its host totals count both."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("traced"):
            torch.ones(4).sum()
    assert [e.name for e in prof.events()].count("traced") == 1
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a: opened.append(a))
    with profiling.span("traced"):
        pass
    assert opened == []
    assert profiling.report()["host"]["traced"]["calls"] == 2


@pytest.mark.parametrize("mode, keyed, want", [
    (dict(row_gather=True), False, 8 * 2 * 4),
    (dict(row_gather=True, fwd_gather_dtype="bfloat16"), False, 8 * 2 * 4),
    (dict(row_gather=True, fwd_gather_dtype="bfloat16"), True, 8 * 2 * 2),
    (dict(row_gather=True, stochastic_fwd=True), True, 1 * 2 * 4),
    (dict(row_gather=True, stochastic_fwd=True, fwd_level_sample=2), True,
     1 * 2 * 4 // 2),
    (dict(), False, 8 * 2 * 2),
    (dict(packed_gather=False), True, 8 * 2 * 4),
    (dict(stochastic_fwd=True), True, 1 * 2 * 2),
], ids=["row", "row-bf16-exact", "row-bf16", "row-one-corner",
        "row-half-levels", "packed", "flat", "packed-one-corner"])
def test_encode_counts_the_table_bytes_it_needs(clock, mode, keyed, want):
    """An encode is one hashgrid.encode span and counts the table bytes of
    its mode and estimator, a point and level: corners x features x the
    bytes of the precision it reads (no index arrays)."""
    from iris_tpu_torch.models.hashgrid import (
        HashGridConfig, hashgrid_encode, init_hashgrid)

    cfg = HashGridConfig(n_levels=4, log2_table_size=10, **mode)
    gen = torch.Generator().manual_seed(0)
    table = init_hashgrid(gen, cfg, "cpu")
    x = torch.rand(16, 3, generator=gen)
    hashgrid_encode(table, cfg, x, gen if keyed else None)
    got = profiling.report()
    assert got["host"]["hashgrid.encode"]["calls"] == 1
    assert got["counts"] == {"hashgrid.gather_bytes": 16 * 4 * want}


def _program_readers():
    from benchmark import run

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        names = [m["name"] for m in json.load(f)["per_layer"]
                 if m["source"] in ("program_span", "program_counter")]
    return {n: run.reader(ROOT, n) for n in names}


def test_readers_return_none_on_an_empty_report(monkeypatch):
    """Every reader of the program's spans finds nothing in an empty
    report, nor in a program without report(); on a report they read the
    unit's share of the graph's last replay and the run's host spans."""
    readers = _program_readers()
    assert readers
    empty = {"graphs": {}, "host": {}, "counts": {}}
    monkeypatch.setattr(profiling, "report", lambda: empty)
    assert {n: r({}) for n, r in readers.items()} == dict.fromkeys(readers)
    monkeypatch.delattr(profiling, "report")
    assert {n: r({}) for n, r in readers.items()} == dict.fromkeys(readers)

    def spans(ms):
        return {k: {"calls": 1, "ms": v, "self_ms": v / 2}
                for k, v in ms.items()}

    full = {"graphs": {
        "train_chunk": {"counts": {"train.steps": 10,
                                   "hashgrid.gather_bytes": 4e9},
                        "spans": spans({"hashgrid.encode": 20.0,
                                        "integrator.bounce": 6.0,
                                        "integrator.first_hit": 4.0})},
        "render_round": {"counts": {"render.rounds": 1},
                         "spans": spans({"mlp.apply": 3.0})}},
        "host": {"batcher.sort": {"calls": 40, "s": 0.2, "self_s": 0.2},
                 "bvh.build": {"calls": 1, "s": 1.5, "self_s": 1.5}},
        "counts": {"train.steps": 40}}
    monkeypatch.setattr(profiling, "report", lambda: full, raising=False)
    got = {n: r({}) for n, r in readers.items()}
    assert got["encode_ms.train"] == 2.0
    assert got["integrator_ms.train"] == 0.5       # self time, a step
    assert got["gather_gbps.train"] == pytest.approx(200.0)
    assert got["mlp_ms.render"] == 3.0
    assert got["batch_sort_ms.train"] == pytest.approx(5.0)
    assert got["bvh_build_s"] == 1.5
    assert got["mlp_ms.train"] is None and got["capture_s"] is None


@pytest.mark.cuda
def test_graph_spans_match_the_profilers_kernels(tmp_path):
    """On the card: a graph of three matmuls under two spans, replayed;
    each span's milliseconds within 5% of the profiler's kernel times of
    the replay, and the replay runs as many kernels as the same function
    captured with no span in it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    a = torch.randn(4096, 4096, device=dev)

    def body(marked):
        def span(name):
            return profiling.span(name) if marked else contextlib.nullcontext()

        with span("outer"):
            x = a @ a
            with span("inner"):
                x = x @ a
            return x @ a

    ctx = graphs.GraphContext(dev)
    with ctx.on_stream():
        body(False)
    ctx.warm = True
    marked = ctx.capture(lambda: body(True), name="probe_marked")
    plain = ctx.capture(lambda: body(False), name="probe_plain")
    kernels = {}
    for name, g in (("plain", plain), ("marked", marked)):
        g.replay()
        torch.cuda.synchronize()
        with profiling.device_trace(str(tmp_path), name, dev):
            g.replay()
            torch.cuda.synchronize()
        with open(tmp_path / f"{name}.json") as f:
            kernels[name] = sorted(
                (e["ts"], e["ts"] + e["dur"]) for e in
                json.load(f)["traceEvents"] if e.get("cat") == "kernel")
    assert len(kernels["marked"]) == len(kernels["plain"]) == 3
    spans = profiling.report()["graphs"]["probe_marked"]["spans"]
    k = kernels["marked"]
    outer_us = k[-1][1] - k[0][0]
    inner_us = k[1][1] - k[1][0]
    assert spans["outer"]["ms"] * 1e3 == pytest.approx(outer_us, rel=0.05)
    assert spans["inner"]["ms"] * 1e3 == pytest.approx(inner_us, rel=0.05)
