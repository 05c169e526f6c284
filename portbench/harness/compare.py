"""The numbers `correct` compares, and the comparison itself.

For one solve the program answers (x, f, v): the best restart's point,
its objective and its largest violation.  The reference (reference/)
answers the same solve as (bucket, f, v, x).  The numbers:

    claim_gap   the program's (f, v) against its own x evaluated in
                float64 on the host: max(|f - f64| / max(1, |f64|),
                |v - v64|), the worst over every solve of the window;
    f_gap       |f - f_ref| / max(1, |f_ref|), the worst over the
                sampled solves;
    v_gap       |v - v_ref|, likewise;
    x_gap       max |x - x_ref| / max(1, max |x_ref|), likewise.

A number is compared where the cell's limits file (limits/<cell>.json)
gives it a limit; each limit was set from the readings that file keeps.
"""

from __future__ import annotations

import math

import numpy as np


def claim_gap(claimed, exact) -> float:
    (f, v), (f64, v64) = claimed, exact
    return max(abs(f - f64) / max(1.0, abs(f64)), abs(v - v64))


def answer_gaps(answer, best) -> dict:
    x, f, v = answer
    _, f_r, v_r, x_r = best
    x, x_r = np.asarray(x, np.float64), np.asarray(x_r, np.float64)
    return {"f_gap": abs(f - f_r) / max(1.0, abs(f_r)),
            "v_gap": abs(v - v_r),
            "x_gap": float(np.abs(x - x_r).max()
                           / max(1.0, float(np.abs(x_r).max())))}


def _worst(values):
    """The largest value, NaN if any is NaN (a NaN must fail)."""
    values = [float(v) for v in values]
    if any(math.isnan(v) for v in values):
        return math.nan
    return max(values, default=0.0)


def worst(claims, gaps) -> dict:
    out = {"claim_gap": _worst(claims)}
    for key in ("f_gap", "v_gap", "x_gap"):
        out[key] = _worst(g[key] for g in gaps)
    return out


def combine(per_rank) -> dict:
    """The worst of each number over the ranks."""
    return {k: _worst(r[k] for r in per_rank) for k in per_rank[0]}


def judge(numbers: dict, limits: dict, failed: int):
    """(correct, checks): every number that has a limit within it, and no
    failed solve; checks maps each compared number to its value and limit,
    with the failed solves last."""
    checks = {k: {"value": numbers[k], "limit": float(limits[k])}
              for k in numbers if k in limits}
    ok = failed == 0 and all(c["value"] <= c["limit"]
                             for c in checks.values())
    checks["failed_solves"] = {"value": failed, "limit": 0}
    return ok, checks
