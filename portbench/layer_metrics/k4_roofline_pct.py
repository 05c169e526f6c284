"""k4_roofline_pct: K4's (the CCP kernel's) share of its roofline on the
reference's sampled solves: the least time for their work (roofline/k4.py,
from the per-tile outer steps and inner trips that reference/dccp.py ran
on the same starts) over K4's measured time on those solves (one launch a
solve).  On several cards, the least share of the ranks."""

from ..roofline import k4
from . import launches

KERNEL = "ccp_kernel"


def read(run):
    shares = []
    for r in run["ranks"]:
        durs = launches(r, KERNEL)
        if not r["work"] or durs is None or len(durs) != r["solves"]:
            return None
        bound = sum(k4.bound_s(r["n"], r["m"], w["E"], w["restarts"],
                               w["trips"]) for w in r["work"])
        shares.append(100.0 * bound / sum(durs[w["index"]]
                                           for w in r["work"]))
    return min(shares)
