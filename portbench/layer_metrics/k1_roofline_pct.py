"""k1_roofline_pct: K1's (the CD sweep kernel's) share of its roofline on
the reference's sampled solves: the least time the card could take for
their work (roofline/k1.py, from the restart-sweeps and probes that
reference/coord_descent.py counted on the same starts) over K1's
measured time on those solves (the profiler's kernel durations, one
launch a solve).  On several cards, the least share of the ranks."""

from ..roofline import k1
from . import launches

KERNEL = "cd_sweep_kernel"


def read(run):
    shares = []
    for r in run["ranks"]:
        durs = launches(r, KERNEL)
        if not r["work"] or durs is None or len(durs) != r["solves"]:
            return None
        bound = sum(k1.bound_s(r["n"], r["m"], r["E"], w["restarts"],
                               w["lane_sweeps"], w["probes"])
                    for w in r["work"])
        shares.append(100.0 * bound / sum(durs[w["index"]]
                                           for w in r["work"]))
    return min(shares)
