"""Run one cell of BENCHMARK.json once, on the card, and print its result.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Everything a cell needs is found by name: the cell's configuration in
benchmark/configs/<config>.json, its traffic in
benchmark/traffic/<traffic>.json (whose "kind" names the driver,
benchmark/kinds/<kind>.py), each per-layer metric's reader in
benchmark/metrics/<metric>.py and the comparison limits in
benchmark/limits/<workload>.json. With --trace 0 the result holds the
cell's end-to-end metrics, with --trace 1 its per-layer metrics, read from
torch.profiler over a few units after the window.

The last line of standard output is the result (JSON); the numbers that
decided `correct` are the last lines of standard error and the result's
last key. With no card, or fewer than the cell asks for, or with JAX or
the JAX package loaded once the window has closed, it prints no result and
exits with a code other than 0.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "iris_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(root: str, workload: str) -> dict:
    """The cell's entries of BENCHMARK.json with its configuration and
    traffic files loaded."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    wl = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return {
        "bench": bench, "workload": wl,
        "config": load_json(os.path.join(root, conf["file"])),
        "traffic": load_json(os.path.join(
            root, "benchmark", "traffic", f"{wl['traffic']}.json")),
        "end_to_end": [m for m in bench["end_to_end"]
                       if workload in m.get("workloads", [workload])],
        "per_layer": [m for m in bench["per_layer"]
                      if workload in m.get("workloads", [workload])],
    }


def reader(root: str, name: str):
    """The read(t) function of benchmark/metrics/<name>.py."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    top = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


class Result:
    """What the cell's driver reports, gathered for the result line."""

    def __init__(self):
        self.attempted = self.failed = 0
        self.e2e: dict = {}
        self.work: dict = {}
        self.trace: dict = {}
        self.peak = None
        self.nums: dict = {}

    def window(self, attempted, failed, metrics, work):
        self.attempted, self.failed = int(attempted), int(failed)
        self.e2e.update(metrics)
        self.work = work

    def traced(self, prof, units, extra=None):
        from benchmark import trace_reader

        self.trace.update(trace_reader.summarize(trace_reader.events(prof),
                                                 units))
        self.trace.update(extra or {})

    def memory(self, device):
        import torch

        if torch.device(device).type == "cuda":
            self.peak = int(torch.cuda.max_memory_allocated(device))

    def roofline(self, unit):
        self.trace["roofline_unit"] = unit

    def numbers(self, nums):
        self.nums = nums


class Harness:
    """The context a driver runs in: the cell's files, the run's
    arguments and device, its set-up clock and profiler, and `patch`,
    through which the tests plant faults (identity in a run)."""

    def __init__(self, root, spec, seed, seconds, trace, device,
                 faults=None):
        self.root = root
        self.workload = spec["workload"]["name"]
        self.config, self.traffic = spec["config"], spec["traffic"]
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device = device
        self.faults = faults or {}
        self.setup_s = None
        self.result = Result()

    def setup_done(self):
        self.setup_s = time.perf_counter() - T0

    def start_profiler(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def patch(self, name, obj):
        fault = self.faults.get(name)
        return fault(obj) if fault else obj


def assemble(h: Harness, spec: dict, root: str, device_info: dict) -> dict:
    """The result line's object, `checks` last."""
    from benchmark import compare

    r = h.result
    if h.trace:
        t = dict(r.trace)
        metrics = {}
        for m in spec["per_layer"]:
            v = reader(root, m["name"])(t)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        vals = dict(r.e2e, setup_s=h.setup_s)
        metrics = {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"] if m["name"] in vals}
    ok, checks = compare.judge(r.nums, compare.limits(root, h.workload))
    dev = dict(device_info, memory_peak_bytes=r.peak)
    if h.trace:
        dev.update(busy_s=r.trace.get("busy_s"),
                   window_s=r.trace.get("wall_s"))
    out = {"correct": ok, "attempted": r.attempted, "failed": r.failed,
           "metrics": metrics, "device": dev}
    if h.trace and "breakdown" in r.trace:
        out["breakdown"] = r.trace["breakdown"]
    out["checks"] = checks
    return out


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="print the readings of the check's numbers for "
                   "the control and the planted faults (and for the "
                   "program, where the cell's driver runs it for them) "
                   "instead of a result")
    args = p.parse_args(argv)
    root = os.getcwd()
    spec = cell_spec(root, args.workload)
    cache = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")

    import torch

    chips = spec["workload"]["chips"]
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); {seen} "
              "visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    h = Harness(root, spec, args.seed, args.seconds, bool(args.trace), dev)
    print(f"[bench] {args.workload} seed {args.seed}: {card_line()}",
          file=sys.stderr)
    kind = importlib.import_module(
        f"benchmark.kinds.{spec['traffic']['kind']}")
    if args.control:
        print(json.dumps({"control": kind.control(h)}), flush=True)
        return 0
    kind.run(h)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded in the measured process: {bad}",
              file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    out = assemble(h, spec, root, info)
    print(f"[bench] setup_s {h.setup_s!r}", file=sys.stderr)
    for k, v in h.result.work.items():
        print(f"[bench] window {k} {v!r}", file=sys.stderr)
    if "roofline_unit" in h.result.trace:
        from benchmark import roofline

        u = h.result.trace["roofline_unit"]
        t, bound, nb, ops = roofline.least_time(
            u["rays"], u["calls"], u["faces"], u["slab"], u["tri"])
        print(f"[bench] traversal bound a unit {t * 1e3!r} ms by {bound} "
              f"({nb!r} B, {ops!r} FLOP) at 3.35 TB/s, 67 TFLOP/s; card "
              f"{card_line()}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
