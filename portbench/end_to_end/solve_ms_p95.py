"""solve_ms_p95: the 95th percentile, over every solve of the window, of
one solve_restarts call's time from the call to the best point read on
the host (on several cards, each solve's slowest rank)."""

from ..harness.window import percentile


def read(run):
    per_solve = zip(*(r["solve_s"] for r in run["ranks"]))
    return percentile([max(t) * 1e3 for t in per_solve], 95)
