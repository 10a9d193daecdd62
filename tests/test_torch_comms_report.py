"""parallel/comms_report.py of the PyTorch port: what a data-parallel
train step sends, counted on two gloo ranks on the CPU, against the bytes
its design says it sends; the ring model; the link rate required. The
guard of tests/test_comms_report.py: per-step traffic is the
trainable-parameter bytes (the gradient all-reduce) plus O(B) gathered
floats (the losses' per-ray rows), and nothing larger."""

import json

import numpy as np
import pytest

from iris_tpu_torch.parallel.comms_report import (
    report, ring_allreduce_seconds, summarize,
)
from iris_tpu_torch.parallel import comms_report
from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_ranks import comms_at_sizes, spawn

SIDES = (8, 12)             # 64 and 144 pixels, 32 and 72 a rank


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    return spawn(comms_at_sizes, 2, tmp_path_factory.mktemp("comms"), SIDES)


def test_counted_bytes_are_params_plus_gathered_rows(counted, capsys):
    """At both batch sizes, on both ranks: one all-reduce a gradient leaf,
    together the trainable-parameter bytes; one all-gather, 4 bytes times
    the global batch times the floats a ray; nothing else. Only the
    gathered term grows with the batch."""
    allreduce = []
    for side, per_rank in zip(SIDES, zip(*counted)):
        b = side * side
        for calls, param_bytes, width in per_rank:
            s = summarize(calls)
            kinds = [k for k, _ in calls]
            assert kinds.count("all_gather") == 1
            assert kinds.count("all_reduce") == len(calls) - 1 == 8
            by = s["bytes_by_kind"]
            assert by["all_reduce"] == param_bytes
            assert by["all_gather"] == 4 * b * width
            # ldr, albedo 3 each; valid 1 (the batch's own columns are
            # read whole on every rank, not gathered)
            assert width == 7
            r = report(calls, param_bytes, 2, link_bw=25e9)
            assert r["allreduce_to_param"] == 1.0
            assert r["collective_bytes_per_step"] == (
                param_bytes + 4 * b * width)
            assert r["ring_allreduce_ms"] == pytest.approx(
                ring_allreduce_seconds(param_bytes, 2, 25e9) * 1e3)
            allreduce.append(by["all_reduce"])
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines()]
    assert len(printed) == 4 and printed[0]["world_size"] == 2
    assert len(set(allreduce)) == 1
    g8, g12 = (summarize(counted[0][i][0])["bytes_by_kind"]["all_gather"]
               for i in range(2))
    assert g12 / g8 == pytest.approx(144 / 64)


def test_ring_model():
    # 8-way ring all-reduce of 1 GB at 100 GB/s: 2*(7/8)*1e9/1e11 s
    assert np.isclose(ring_allreduce_seconds(1e9, 8, 100e9),
                      2 * 7 / 8 * 1e-2)
    assert ring_allreduce_seconds(1e9, 1, 100e9) == 0.0


def test_link_bw_is_required():
    """No interconnect rate is assumed: report and the CLI want one."""
    with pytest.raises(TypeError):
        report([("all_reduce", 4)], 4, 2)
    with pytest.raises(SystemExit):
        comms_report.main([])


def test_cli_labels_what_it_counted(capfd):
    """The CLI on two gloo ranks on the CPU, asked for explicitly: rank 0
    prints one JSON line that names the grid, the batch, the device and
    the backend it counted, beside the bytes; NCCL is refused off the
    card."""
    comms_report.main(["--link_bw", "2.5e10", "--device", "cpu", "--batch",
                       "64", "--hash_levels", "4", "--hash_features", "4",
                       "--log2_table", "10"])
    lines = [line for line in capfd.readouterr().out.splitlines()
             if line.startswith("{")]
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert (r["device"], r["backend"], r["world_size"]) == ("cpu", "gloo", 2)
    assert r["grid"] == {"hash_levels": 4, "hash_features": 4,
                         "log2_table": 10}
    assert r["rays_per_step"] == 64 and r["gathered_floats_per_ray"] == 7
    assert r["gather_bytes_per_step"] == 4 * 64 * 7
    assert r["allreduce_to_param"] == 1.0
    assert comms_report.rank_devices("cpu", None, 3) == (["cpu"] * 3,
                                                        "gloo")
    with pytest.raises(ValueError, match="NCCL runs on the card"):
        comms_report.rank_devices("cpu", "nccl", 2)
