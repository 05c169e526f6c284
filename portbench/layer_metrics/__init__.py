"""Per-layer metrics, one module a metric: read(run) -> value or None,
from the traced run (`run` as in end_to_end/__init__.py; each rank's
"trace" is harness/trace.reduce's).  A reader that finds nothing to read
returns None and the metric is left out of the line."""


def launches(rank, pattern):
    """The durations (s) of the window's launches of the one kernel whose
    name holds `pattern`, in order; None where no kernel or several
    kernels match."""
    names = [k for k in rank["trace"]["launches"] if pattern in k]
    if len(names) != 1:
        return None
    return rank["trace"]["launches"][names[0]]
