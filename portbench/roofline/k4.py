"""K4's work: the penalty-CCP improve of R restarts at n, m, E, from the
per-tile (64 restarts) outer steps and inner trips.

Per lane and inner trip: the 2(m+1) rotations (2n^2 each), each hinge
block's set-up (15 operations a coordinate), the consensus and dual
updates (6 a coordinate and block) and 8n more; per outer step one
linearization (m+1+E rotations and 6(m+1)n), plus the first.  The
hinges' Newton trips (19 operations a coordinate each) run only for the
lanes whose prox needs the multiplier, which the data decide, so they
are left out and the bound is a floor.  Bytes: the eigenbases V once,
the starts in and the result out, float32.
"""

from .peaks import bound_s as _bound

L_TILE = 64


def ops(n, m, e, trips):
    B = 1 + m + e
    inner = 4 * (m + 1) * n * n + (m + e) * n * 15 + 6 * B * n + 8 * n
    lin = 2 * (m + 1 + e) * n * n + 6 * (m + 1) * n
    return float(L_TILE * sum(t[1] * inner + (t[0] + 1) * lin
                              for t in trips))


def nbytes(n, m, restarts):
    return 4.0 * ((m + 1) * n * n + 2 * restarts * n)


def bound_s(n, m, e, restarts, trips):
    return _bound(ops(n, m, e, trips), nbytes(n, m, restarts))
