"""BENCHMARK.json against the benchmark's contract, and a cell added as new
files alone."""

from __future__ import annotations

import json
import os
import re
import shutil

from benchmark import run
from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_names_units():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    metrics = b["end_to_end"] + b["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    assert all(0.01 <= m["bound"] <= 0.25 for m in b["end_to_end"])
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert LINE.match(m["layer"])
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def test_every_cell_finds_its_files():
    b = bench()
    for w in b["workloads"]:
        spec = run.cell_spec(ROOT, w["name"])
        assert spec["traffic"]["kind"]
        assert os.path.exists(os.path.join(
            ROOT, "benchmark", "kinds", f"{spec['traffic']['kind']}.py"))
        assert os.path.exists(os.path.join(
            ROOT, "benchmark", "limits", f"{w['name']}.json"))
        e2e = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec["per_layer"]
        for m in spec["per_layer"]:
            assert callable(run.reader(ROOT, m["name"]))
            assert m["moves"] in e2e


def test_a_cell_is_added_by_new_files_alone(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell added
    in a copy as new files and entries: found by name, no file edited."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark")
    b = bench()
    cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                      "ref32x2.json")))
    cfg["name"] = "new_cfg"
    (tmp_path / "benchmark" / "configs" / "new_cfg.json").write_text(
        json.dumps(cfg))
    tr = json.load(open(os.path.join(ROOT, "benchmark", "traffic",
                                     "final_render.json")))
    tr["n_views"] = 4
    (tmp_path / "benchmark" / "traffic" / "new_mix.json").write_text(
        json.dumps(tr))
    (tmp_path / "benchmark" / "metrics" / "new_metric.render.py").write_text(
        "def read(t):\n    return 7.0\n")
    b["configs"].append({"name": "new_cfg", "source": "https://example.org",
                         "file": "benchmark/configs/new_cfg.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "new-cell", "config": "new_cfg",
                           "traffic": "new_mix", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "new_metric.render", "unit": "ms",
                           "better": "lower", "source": "device_trace",
                           "layer": "device", "moves": "render_samples_per_s",
                           "workloads": ["new-cell"]})
    b["end_to_end"][1]["workloads"].append("new-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    spec = run.cell_spec(str(tmp_path), "new-cell")
    assert spec["config"]["name"] == "new_cfg"
    assert spec["traffic"]["n_views"] == 4
    assert [m["name"] for m in spec["per_layer"]] == ["new_metric.render"]
    assert run.reader(str(tmp_path), "new_metric.render")({}) == 7.0
    assert {m["name"] for m in spec["end_to_end"]} == {
        "render_samples_per_s", "setup_s"}
