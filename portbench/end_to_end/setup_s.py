"""setup_s: from the start of the run's process to the first timed solve's
call: imports, the CUDA context, loading (at a checkout's first run,
building) the kernels' library, making the problem, the warm-up solves
and, on several cards, starting the ranks and joining the group (the
slowest rank)."""


def read(run):
    return max(r["setup_s"] for r in run["ranks"])
