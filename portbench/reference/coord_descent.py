"""The reference of the two-phase coordinate-descent improve (the
COORD_DESCENT chain that K1 runs): a frozen copy, in plain PyTorch, of the
algorithm of the reference package (qcqp/qcqp.py:101-192, in the lockstep
form with per-lane exits, warm slack brackets and the 40-trip bisection
that the port's kernels use), one correctly rounded op per step, in a
fixed order, so that on the card it computes every lane as a kernel with
the same operation order does.

It imports nothing of the program: its copies of the one-variable
helpers and of the sweep loops live here, so that a change to the
program's own plain versions moves neither this reference nor the work
it counts (`improve` returns the restart-sweeps and the bisection probes
that the roofline of roofline/k1.py reads).

Layout: restarts on the last axis, (rows, R).
"""

from __future__ import annotations

import torch

REL_SLACK_TOL = 1.0 / 16.0
N_BISECT = 40

_INF = float("inf")
_NAN = float("nan")


def canon_leq(p, q, c, tol):
    """_canon_leq: the membership form of {p x^2 + q x + c <= 0} per row.
    Returns (base, sgn, a, b, es, cand), each shaped like p."""
    D = q * q - 4.0 * p * c
    rD = torch.sqrt(torch.clamp_min(D, 0.0))
    two_p = torch.where(p.abs() > tol, 2.0 * p, torch.ones_like(p))
    lo = (-q - rD) / two_p
    hi = (-q + rD) / two_p
    xlin = -c / torch.where(q.abs() > tol, q, torch.ones_like(q))
    ninf = torch.full_like(p, -_INF)
    pinf = torch.full_like(p, _INF)
    nan = torch.full_like(p, _NAN)

    pos, neg = p > tol, p < -tol
    Dge = D >= 0
    qpos, qneg = q > tol, q < -tol
    lin = ~pos & ~neg

    base = (neg | (lin & ~qpos & ~qneg)).to(p.dtype)
    interval = (pos & Dge) | (lin & (qpos | qneg))
    complement = neg & Dge
    one, zero = torch.ones_like(p), torch.zeros_like(p)
    sgn = torch.where(interval, one, torch.where(complement, -one, zero))
    es = torch.where(complement, -one, one)
    a = torch.where(pos & Dge, lo,
                    torch.where(lin & qneg, xlin,
                                torch.where(complement, hi, ninf)))
    b = torch.where(pos & Dge, hi,
                    torch.where(lin & qpos, xlin,
                                torch.where(complement, lo, pinf)))
    a = torch.where(torch.isfinite(a), a - es * 5e-7 * (1.0 + a.abs()), a)
    b = torch.where(torch.isfinite(b), b + es * 5e-7 * (1.0 + b.abs()), b)
    cand = torch.where(pos & Dge, lo,
                       torch.where(neg & Dge, lo,
                                   torch.where(lin & qneg, xlin, nan)))
    return base, sgn, a, b, es, cand


def neutralize(block, mask):
    """Rows where mask is false accept everything (base 1, sgn 0); the
    bounds and the candidate stay as they are."""
    base, sgn, a, b, es, cand = block
    return (torch.where(mask, base, torch.ones_like(base)),
            torch.where(mask, sgn, torch.zeros_like(sgn)), a, b, es, cand)


def g_form(base, sgn, a, b):
    """_g_form: feasibility against row j is s_j * max(a2_j - x, x - b2_j)
    <= 0."""
    s = torch.where(sgn < -0.5, -torch.ones_like(sgn), torch.ones_like(sgn))
    nosgn = sgn.abs() < 0.5
    empty = (base < 0.5) & nosgn
    full = (base > 0.5) & nosgn
    a2 = torch.where(empty, _INF, torch.where(full, -_INF, a))
    b2 = torch.where(empty, -_INF, torch.where(full, _INF, b))
    return s, a2, b2


def feas_matrix_from_canon(blocks, cands):
    """Feasibility (0/1, shaped like cands (C, R)) of each candidate against
    every canonical row of `blocks` (each tuple's tensors (k_i, R))."""
    cf = torch.clamp(cands, -3.0e38, 3.0e38)
    parts = [g_form(base, sgn, a, b) for (base, sgn, a, b, _, _) in blocks]
    s = torch.cat([t[0] for t in parts])
    a2 = torch.cat([t[1] for t in parts])
    b2 = torch.cat([t[2] for t in parts])
    if s.shape[0]:
        x = cf[:, None, :]
        gj = s[None] * torch.maximum(a2[None] - x, x - b2[None])
        g = gj.amax(dim=1)          # NaN-propagating, like the JAX fold
    else:
        g = torch.full_like(cands, -_INF)
    return ((g <= 0.0) & ~torch.isnan(cands) & ~torch.isnan(g)).to(
        cands.dtype)


def _pick(cands, idx):
    return torch.gather(cands, 0, idx[None, :])[0]


def feasible_point_from_canon(blocks, xk):
    """_feasible_point_from_canon: (witness (R,), exists (R,))."""
    R = xk.shape[0]
    ninf = torch.full((1, R), -_INF, dtype=xk.dtype, device=xk.device)
    cands = torch.cat([blk[5] for blk in blocks] + [ninf], dim=0)
    feas = feas_matrix_from_canon(blocks, cands)
    exists = feas.amax(dim=0) > 0.5
    dist = torch.where(feas > 0.5, (cands - xk[None, :]).abs(), _INF)
    dist = torch.where(torch.isnan(dist), _INF, dist)
    any_fin = dist.amin(dim=0) < _INF
    idx = torch.where(any_fin, torch.argmin(dist, dim=0),
                      torch.argmin(1.0 - feas, dim=0))
    return _pick(cands, idx), exists



def feasible_point_rows_split(p, q, r, act, p2, q2, r2, act2, xk, s, tol):
    """feasible_point_rows_split: the E equality rows pre-gathered into
    (p2, q2, r2, act2) (E, R), or None when E == 0."""
    sb = s[None, :]
    blocks = [neutralize(canon_leq(p, q, r - sb, tol), act > 0)]
    if p2 is not None:
        blocks.append(neutralize(canon_leq(-p2, -q2, -r2 - sb, tol),
                                 act2 > 0))
    return feasible_point_from_canon(blocks, xk)



def bisect_accept(feasible_point, xk, viol, tol, viol_tol, n_bisect,
                  viol_of, work, rel=REL_SLACK_TOL, warm=None):
    """_bisect_accept for a batch of lanes.  Returns (v, (wlo, whi)): v is
    the accepted coordinate value (xk where not accepted), (wlo, whi) the
    lane's final bracket for the next sweep's warm start.  Adds the probes
    it makes, summed over lanes, to work["probes"] (a tensor on the lanes'
    device, so that counting reads nothing back to the host)."""
    es_cold = viol - viol_tol

    def gap_tgt(ss):
        return tol + rel * torch.clamp_min(ss, 0.0)

    if warm is None:
        ss = torch.full_like(xk, -tol)
        es = es_cold
        wflag = torch.zeros_like(xk)
    else:
        wlo, whi = warm
        hi_ok = torch.isfinite(whi) & (whi < es_cold)
        es = torch.where(hi_ok,
                         torch.minimum(es_cold, whi * (1.0 + rel) + tol),
                         es_cold)
        lo_ok = torch.isfinite(wlo) & (wlo > 0.0) & ~torch.isfinite(whi)
        ss = torch.where(lo_ok,
                         torch.clamp_min(wlo * (1.0 - rel) - tol, -tol),
                         torch.full_like(xk, -tol))
        ss = torch.clamp_min(torch.minimum(ss, es - 1.0 * gap_tgt(ss)), -tol)
        wflag = (ss > -tol).to(xk.dtype)

    bx, bs = xk, viol
    found = torch.zeros_like(xk)
    for _ in range(n_bisect):
        esc = torch.where((found < 0.5) & (es < es_cold), 1.0, -1.0).to(
            xk.dtype)
        live = torch.maximum(es - ss - gap_tgt(ss), esc) > 0.0
        if not bool(live.any()):
            break
        need_esc = ((es - ss) <= gap_tgt(ss)) & (found < 0.5) & (es < es_cold)
        es = torch.where(need_esc, es_cold, es)
        do = (es - ss) > gap_tgt(ss)
        sm = 0.501 * ss + 0.499 * es
        work["probes"] = work["probes"] + do.sum()
        xi, exists = feasible_point(sm)
        take = do & exists
        g = viol_of(xi)
        s_up = torch.where(torch.isfinite(xi) & ~torch.isnan(g),
                           torch.minimum(g, sm), sm)
        ss = torch.where(do & ~exists, sm, ss)
        reset = take & (wflag > 0.5)
        ss = torch.where(reset, -tol, ss)
        wflag = torch.where(reset, 0.0, wflag)
        es = torch.where(take, s_up, es)
        bx = torch.where(take, xi, bx)
        bs = torch.where(take, s_up, bs)
        found = torch.maximum(found, take.to(xk.dtype))

    accept = (found > 0.5) & (bs < viol) & torch.isfinite(bx)
    return (torch.where(accept, bx, xk),
            (ss, torch.where(accept, bs, _INF)))



def viol_of_split(p, q, r, act, p2, q2, r2, act2):
    """_phase1_kernel_split.viol_of: the positive side of every row, and
    the negative side of the E equality rows."""
    def viol_of(v):
        vb = v[None, :]
        val = (p * vb + q) * vb + r
        w = torch.where(act > 0.5, torch.clamp_min(val, 0.0), 0.0)
        w = w.amax(dim=0) if w.shape[0] else torch.zeros_like(v)
        if p2 is not None:
            val2 = (p2 * vb + q2) * vb + r2
            w2 = torch.where(act2 > 0.5, torch.clamp_min(-val2, 0.0), 0.0)
            w = torch.maximum(w, w2.amax(dim=0))
        return w
    return viol_of


def _matvec(M, x):
    """M (..., n) times x (n, R) -> (..., R), summed over j = 0, 1, ... in
    order with one rounding per multiply and per add: the CUDA kernel's
    arithmetic exactly, for every restart column on its own (a BLAS matmul
    sums in an order that depends on the batch's shape)."""
    acc = torch.zeros(M.shape[:-1] + x.shape[1:], dtype=x.dtype,
                      device=x.device)
    for j in range(x.shape[0]):
        acc = acc + M[..., j, None] * x[j]
    return acc


class _Ctx:
    """_make_ctx: F refresh, violations and the coordinate restriction, on
    the (rows, R) layout."""

    def __init__(self, P, q, r, eq_idx):
        self.P, self.q, self.r = P, q, r
        self.k1, self.n = P.shape[0], P.shape[-1]
        self.m = self.k1 - 1
        self.eq_idx = tuple(int(i) for i in eq_idx)
        self.eq_t = torch.as_tensor(self.eq_idx, dtype=torch.long,
                                    device=P.device)
        eqm = torch.zeros(self.m, dtype=torch.bool, device=P.device)
        eqm[self.eq_t] = True
        self.eqm = eqm[:, None]

    def refresh_F(self, x):
        """F (m+1, R) from x (n, R): x^T P_i x + q_i^T x + r_i."""
        Y = _matvec(self.P, x)                       # (m+1, n, R)
        s = torch.zeros_like(Y[:, 0])
        for a in range(self.n):
            s = s + x[a] * Y[:, a]
        return s + _matvec(self.q, x) + self.r[:, None]

    def viols_from_F(self, F):
        vals = F[1:]
        return torch.where(self.eqm, vals.abs(), torch.clamp_min(vals, 0.0))

    def max_viol(self, F):
        """Max violation per lane, with initial 0 (m == 0 gives 0)."""
        if self.m == 0:
            return torch.zeros(F.shape[1], dtype=F.dtype, device=F.device)
        return self.viols_from_F(F).amax(dim=0)

    def restriction(self, k, x, F):
        """(xk (R,), t2 (m+1, 1), t1, t0 (m+1, R)); P[:, k, :] is
        P[:, :, k] by symmetry."""
        xk = x[k]
        Gk = _matvec(self.P[:, k, :], x)
        t2 = self.P[:, k, k][:, None]
        qk = self.q[:, k][:, None]
        t1 = 2.0 * (Gk - t2 * xk) + qk
        t0 = F - xk * (2.0 * Gk + qk) + t2 * (xk * xk)
        return xk, t2, t1, t0

    def rows(self, t2, t1, t0):
        """Constraint rows (t2c, t1c, t0c, act) and the gathered equality
        rows (None when E == 0)."""
        R = t1.shape[1]
        t2c = t2[1:].expand(self.m, R)
        t1c, t0c = t1[1:], t0[1:]
        act = ((t2c != 0.0) | (t1c != 0.0)).to(t1.dtype)
        if self.eq_idx:
            eq = tuple(t.index_select(0, self.eq_t)
                       for t in (t2c, t1c, t0c, act))
        else:
            eq = (None,) * 4
        return t2c, t1c, t0c, act, eq


def _phase1_loop(ctx, x, num_iters, tol, viol_tol, n_bisect, work):
    """_phase1_loop with per-lane exits; x (n, R) is updated in place.
    work["lane_sweeps"] counts the sweeps run, summed over lanes."""
    n, R = x.shape
    warm_lo = torch.full((n, R), _INF, dtype=x.dtype, device=x.device)
    warm_hi = torch.full((n, R), _INF, dtype=x.dtype, device=x.device)
    viol_last = torch.full((R,), _INF, dtype=x.dtype, device=x.device)
    changed = torch.ones(R, dtype=torch.bool, device=x.device)
    for _ in range(num_iters):
        idx = torch.nonzero((viol_last >= viol_tol) & changed).flatten()
        if idx.numel() == 0:
            break
        work["lane_sweeps"] += idx.numel()
        xa, wl, wh = x[:, idx], warm_lo[:, idx], warm_hi[:, idx]
        F = ctx.refresh_F(xa)                        # drift control
        ch = torch.zeros(idx.numel(), dtype=torch.bool, device=x.device)
        for k in range(n):
            xk, t2, t1, t0 = ctx.restriction(k, xa, F)
            t2c, t1c, t0c, act, (p2, q2, r2, act2) = ctx.rows(t2, t1, t0)
            viol = (torch.where(act > 0.5, ctx.viols_from_F(F), 0.0)
                    .amax(dim=0) if ctx.m else torch.zeros_like(xk))

            def feasible_point(s):
                return feasible_point_rows_split(t2c, t1c, t0c, act, p2, q2,
                                                 r2, act2, xk, s, tol)
            v, (wlo, whi) = bisect_accept(
                feasible_point, xk, viol, tol, viol_tol, n_bisect,
                viol_of_split(t2c, t1c, t0c, act, p2, q2, r2, act2),
                work, warm=(wl[k], wh[k]))
            wl[k], wh[k] = wlo, whi
            ch |= v != xk
            F = t2 * (v * v) + t1 * v + t0
            xa[k] = v
        x[:, idx], warm_lo[:, idx], warm_hi[:, idx] = xa, wl, wh
        viol_last[idx] = ctx.max_viol(F)
        changed[idx] = ch
    return x


def _phase2_select(blocks, xk, p0, q0, r0):
    """_phase2_select: argmin of p0 x^2 + q0 x + r0 over the vertex, the
    un-shifted bounds of every block and +-inf, ties proximal to xk.
    p0, q0, r0, xk (R,).  Returns (v (R,), any_feas (R,))."""
    R = xk.shape[0]
    safe_p0 = torch.where(p0 > 0.0, p0, torch.ones_like(p0))
    vertex = torch.where(p0 > 0.0, -q0 / (2.0 * safe_p0), _NAN)
    cand_rows = [vertex[None]]
    for (base, sgn, a, b, es, _) in blocks:
        a_t = a + es * 5e-7 * (1.0 + a.abs())
        b_t = b - es * 5e-7 * (1.0 + b.abs())
        cand_rows.append(torch.where(a.abs() < _INF, a_t, _NAN))
        cand_rows.append(torch.where(b.abs() < _INF, b_t, _NAN))
    cand_rows.append(torch.full((1, R), -_INF, dtype=xk.dtype,
                                device=xk.device))
    cand_rows.append(torch.full((1, R), _INF, dtype=xk.dtype,
                                device=xk.device))
    cands = torch.cat(cand_rows, dim=0)              # (C, R)
    feas = feas_matrix_from_canon(blocks, cands)

    p0, q0, r0 = p0[None], q0[None], r0[None]
    finite_vals = (p0 * cands + q0) * cands + r0
    one = torch.ones_like(cands)
    sgn_c = torch.where(cands > 0.0, one, -one)
    infv = torch.where(
        p0 != 0.0, torch.where(p0 > 0.0, _INF, -_INF) * one,
        torch.where(q0 != 0.0, torch.where(q0 > 0.0, sgn_c, -sgn_c) * _INF,
                    r0 * one))
    vals = torch.where(cands.abs() == _INF, infv, finite_vals)
    vals = torch.where((feas > 0.5) & ~torch.isnan(vals), vals, _INF)

    any_feas = feas.amax(dim=0) > 0.5
    vmin = vals.amin(dim=0)
    tied = vals == vmin[None]
    dist = torch.where(tied, (cands - xk[None]).abs(), _INF)
    dist = torch.where(torch.isnan(dist), _INF, dist)
    any_fin = dist.amin(dim=0) < _INF
    idx = torch.where(any_fin, torch.argmin(dist, dim=0),
                      torch.argmin(vals, dim=0))
    return torch.gather(cands, 0, idx[None])[0], any_feas


def _phase2_loop(ctx, x, num_iters, tol, viol_tol, work):
    """_phase2_loop with per-lane exits; x (n, R) is updated in place.
    work["lane_sweeps"] counts the sweeps run, summed over lanes."""
    n, R = x.shape
    slack_all = ctx.max_viol(ctx.refresh_F(x))
    counter = torch.where(slack_all < viol_tol, 0, n).to(torch.int64)
    for _ in range(num_iters):
        idx = torch.nonzero(counter < n).flatten()
        if idx.numel() == 0:
            break
        work["lane_sweeps"] += idx.numel()
        xa, c, slack = x[:, idx], counter[idx], slack_all[idx]
        F = ctx.refresh_F(xa)
        sb = slack[None]
        for k in range(n):
            xk, t2, t1, t0 = ctx.restriction(k, xa, F)
            t2c, t1c, t0c, act, (p2, q2, r2, act2) = ctx.rows(t2, t1, t0)
            blocks = [neutralize(canon_leq(t2c, t1c, t0c - sb, tol),
                                 act > 0)]
            if p2 is not None:
                blocks.append(neutralize(canon_leq(-p2, -q2, -r2 - sb, tol),
                                         act2 > 0))
            v, any_feas = _phase2_select(blocks, xk, t2[0].expand_as(xk),
                                         t1[0], t0[0])
            accept = (any_feas & ((v - xk).abs() > tol) & (v.abs() < _INF)
                      & ~torch.isnan(v) & (c < n))
            c = torch.where(accept, 0, c + 1)
            v = torch.where(accept, v, xk)
            F = t2 * (v * v) + t1 * v + t0
            xa[k] = v
        x[:, idx], counter[idx] = xa, c
    return x


def improve(form, xs, num_iters=1000, viol_tol=1e-2, tol=1e-4,
            n_bisect=N_BISECT, phase1=True):
    """The two-phase CD improve of the restart batch xs (R, n) in the
    form's dtype (form: reference.problem.Form); the phase-2 gate of
    qcqp.py:189-190 per lane.  Returns (x (R, n), work), work holding the
    restart-sweeps and the bisection probes, summed over lanes."""
    work = {"lane_sweeps": 0, "probes": 0}
    ctx = _Ctx(form.P, form.q, form.r, form.eq_idx)
    x = xs.T.clone()
    if phase1:
        _phase1_loop(ctx, x, int(num_iters), tol, viol_tol, int(n_bisect),
                     work)
    _phase2_loop(ctx, x, int(num_iters), tol, viol_tol, work)
    return x.T.contiguous(), {"lane_sweeps": int(work["lane_sweeps"]),
                              "probes": int(work["probes"])}
