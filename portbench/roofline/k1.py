"""K1's work: the two-phase CD improve of R restarts at n, m, E.

Per restart-sweep: the F refresh, (m+1)(2n^2 + 2n) operations, and n
coordinate restrictions of 2(m+1)n each.  Per bisection probe: C_ROW
operations on each of the m + E canonical rows (the row's
canonicalization, about 25, and its violation, 6).  The scan of the
candidates against the rows stops at the first row a candidate fails,
so its length depends on the data; it is left out, and the bound is a
floor.  Bytes: P, q and r read once, the starts in and the result out,
float32.
"""

from .peaks import bound_s as _bound

C_ROW = 31


def ops(n, m, e, lane_sweeps, probes):
    per_sweep = (m + 1) * (2 * n * n + 2 * n) + n * 2 * (m + 1) * n
    return float(lane_sweeps * per_sweep + probes * (m + e) * C_ROW)


def nbytes(n, m, restarts):
    return 4.0 * ((m + 1) * n * n + (m + 1) * n + (m + 1) + 2 * restarts * n)


def bound_s(n, m, e, restarts, lane_sweeps, probes):
    return _bound(ops(n, m, e, lane_sweeps, probes), nbytes(n, m, restarts))
