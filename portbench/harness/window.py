"""The arithmetic of the measured window: seeds, rates and percentiles."""

from __future__ import annotations

import math

import numpy as np


def solve_seed(seed: int, i: int) -> int:
    """The generator seed of solve i of a run (i = -1: the warm-up), a
    63-bit number drawn from (seed, i), so that the reference can draw the
    same starts again."""
    words = np.random.SeedSequence([int(seed), i + 1]).generate_state(
        2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def more(elapsed: float, count: int, seconds: float) -> bool:
    """Whether another solve starts: the first always, the next while the
    window is shorter than `seconds`."""
    return count == 0 or elapsed < seconds


def rate(units: float, seconds: float) -> float:
    """Work per second over the whole window: all the units completed in
    it over all of its time."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return units / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all the values, linearly
    interpolated between the closest ranks (numpy's default)."""
    v = sorted(float(x) for x in values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def union_seconds(intervals, lo: float, hi: float) -> float:
    """The length of the union of intervals (start, end), clipped to
    [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float):
    """The stretches of [lo, hi] that no interval covers, as (start,
    end), in order."""
    out, t = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out
