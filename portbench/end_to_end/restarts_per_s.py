"""restarts_per_s: every restart of every solve of the window over all of
its time, from the first timed solve's call to the host read of the last
solve started before the window's seconds ran out (on several cards the
longest of the ranks' windows)."""

from ..harness.window import rate


def read(run):
    ranks = run["ranks"]
    return rate(ranks[0]["solves"] * ranks[0]["restarts"],
                max(r["window_s"] for r in ranks))
