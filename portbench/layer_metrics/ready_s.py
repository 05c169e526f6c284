"""ready_s: the seconds of `launch.initialize` (the harness's span around
it on each rank: the store, the one-rank-a-card check, the NCCL group),
the slowest rank's.  None on one card, where nothing is launched."""


def read(run):
    ready = [r["ready_s"] for r in run["ranks"] if "ready_s" in r]
    return max(ready) if ready else None
