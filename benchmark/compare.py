"""The numbers that decide `correct`, and their limits.

Each number is a gap between what the program's timed path produced and
what the reference computed from the same inputs, and each has its own
limit in benchmark/limits/<workload>.json, set between the largest value
sound runs gave and the smallest the control or a planted fault gave
(PERF.md lists the readings)."""

from __future__ import annotations

import json
import math
import os

import numpy as np


def norm_gaps(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's |norm_prog - norm_ref| over the larger of the
    leaf's reference norm and the median leaf's; `keep` limits the
    leaves."""
    names = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in ref]))
    worst = 0.0
    for k in names:
        if not math.isfinite(prog[k]):
            return math.inf
        worst = max(worst, abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30))
    return worst


def value_gaps(prog: np.ndarray, ref: np.ndarray, floor: float
               ) -> np.ndarray:
    """Per value |prog - ref| / (|ref| + floor); non-finite program values
    read infinite."""
    p = np.asarray(prog, np.float64)
    r = np.asarray(ref, np.float64)
    g = np.abs(p - r) / (np.abs(r) + floor)
    return np.where(np.isfinite(p), g, np.inf)


def quantile(g: np.ndarray, q: float) -> float:
    return float(np.quantile(g.reshape(-1), q)) if g.size else math.inf


def limits(root: str, workload: str) -> dict:
    path = os.path.join(root, "benchmark", "limits", f"{workload}.json")
    with open(path) as f:
        return json.load(f)


def judge(numbers: dict, lim: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit, or not finite, fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = lim.get(name, {}).get("limit")
        good = (limit is not None and value is not None
                and math.isfinite(value) and value <= limit)
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
