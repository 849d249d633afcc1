"""The comparison helpers and the verdict: each number compared with its
limit, printed beside it."""
from __future__ import annotations

import json
import math


def mismatches(a, b) -> int:
    """Elements that differ (shapes must agree; a shape mismatch counts
    every element)."""
    if tuple(a.shape) != tuple(b.shape):
        return max(a.numel(), b.numel())
    return int((a.cpu() != b.cpu()).sum())


def gap(a, b, rows=None) -> float:
    """Largest |a - b| over the rows kept, as a share of the largest |b|
    there (the reference's scale); NaN where a is not finite."""
    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
    if rows is not None:
        rows = rows.cpu()
        a, b = a[rows], b[rows]
    if a.numel() == 0:
        return 0.0
    if not bool(a.isfinite().all()):
        return math.inf
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / max(scale, 1e-30)


def abs_gap(a, b) -> float:
    """Largest |a - b| (inf where a is not finite)."""
    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
    if not bool(a.isfinite().all()):
        return math.inf
    return float((a - b).abs().max()) if a.numel() else 0.0


def verdict(readings: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): each reading at or under its
    limit; a reading with no limit fails."""
    checks, ok = {}, True
    for name in sorted(readings):
        value, limit = readings.get(name), limits.get(name)
        good = (value is not None and limit is not None
                and not math.isnan(value) and value <= limit)
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def worst(per_output: list) -> dict:
    """The largest reading of each name over several compared outputs."""
    out = {}
    for r in per_output:
        for k, v in r.items():
            out[k] = v if k not in out else max(out[k], v)
    return out


def print_checks(checks: dict, stream) -> None:
    """One line a number: name, value, limit."""
    for name, c in checks.items():
        print(f"check {name} {json.dumps(c['value'])} <= "
              f"{json.dumps(c['limit'])}", file=stream)
