"""K1: the whole two-phase coordinate-descent improve of a restart batch in
one kernel launch (JAX counterpart: qcqp_tpu/kernels/cd_sweep_pallas.py).

`two_phase_sweeps` and `phase1_sweeps` are the wrappers: on CUDA float32
tensors they launch the hand-written kernel in `csrc/cd_sweep.cu`; on CPU
tensors they run `two_phase_sweeps_ref` / `phase1_sweeps_ref`, the plain
PyTorch versions.  A CUDA tensor the kernel does not take raises; nothing
falls back from the GPU to the plain version.

Tensor contract (as in the JAX package): P (m+1, n, n) symmetric, q
(m+1, n), r (m+1,), eq_idx the static tuple of equality rows, xs (R, n).
Any R: the JAX wrapper pads R to the 128-lane tile; the CUDA kernel runs
one warp per restart, and its ragged last block has fewer warps.

A stack of S forms of one shape (the scenario axis that jax.vmap gives the
Pallas call in qcqp_tpu/parallel/scenarios.py) goes in the same call: P
(S, m+1, n, n), q (S, m+1, n), r (S, m+1), eq_idx a sequence of S tuples
(each scenario its own pattern, E may differ), xs (S, R, n).  The kernel
runs the S x R restarts in one launch, each warp on its own scenario's
form, so its lanes equal those of S single-form launches bit for bit; the
plain version runs the stack scenario by scenario.

Per-lane semantics.  The Pallas loops run while any lane of a 128-restart
tile is alive.  A lane that has stopped is left unchanged by the loop
bodies, except that phase 1 keeps re-deriving a stopped lane's violation
from the drifting closed-form F; in a rare lane at viol_tol within rounding
that could revive it.  The CUDA kernel (one warp per restart) and the
plain version here both stop each lane on its own state, so a lane's
result does not depend on which restarts share its batch: the plain
version runs each sweep only on the lanes that are still alive.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .onevar_kernel import (SMEM_BLOCK_MAX, bisect_accept, canon_leq,
                            feas_matrix_from_canon,
                            feasible_point_rows_split, neutralize,
                            viol_of_split, _check_cuda)

_INF = float("inf")
_NAN = float("nan")


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


def _phase1_loop(ctx, x, num_iters, tol, viol_tol, n_bisect):
    """_phase1_loop with per-lane exits; x (n, R) is updated in place.
    `_phase1_loop.lane_sweeps` counts the sweeps run, summed over lanes."""
    n, R = x.shape
    warm_lo = torch.full((n, R), _INF, dtype=x.dtype, device=x.device)
    warm_hi = torch.full((n, R), _INF, dtype=x.dtype, device=x.device)
    viol_last = torch.full((R,), _INF, dtype=x.dtype, device=x.device)
    changed = torch.ones(R, dtype=torch.bool, device=x.device)
    for _ in range(num_iters):
        idx = torch.nonzero((viol_last >= viol_tol) & changed).flatten()
        if idx.numel() == 0:
            break
        _phase1_loop.lane_sweeps += idx.numel()
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
                warm=(wl[k], wh[k]))
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


def _phase2_loop(ctx, x, num_iters, tol, viol_tol):
    """_phase2_loop with per-lane exits; x (n, R) is updated in place.
    `_phase2_loop.lane_sweeps` counts the sweeps run, summed over lanes."""
    n, R = x.shape
    slack_all = ctx.max_viol(ctx.refresh_F(x))
    counter = torch.where(slack_all < viol_tol, 0, n).to(torch.int64)
    for _ in range(num_iters):
        idx = torch.nonzero(counter < n).flatten()
        if idx.numel() == 0:
            break
        _phase2_loop.lane_sweeps += idx.numel()
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


_phase1_loop.lane_sweeps = 0
_phase2_loop.lane_sweeps = 0


def _per_scenario(fn, P, q, r, eq_idx, xs, *args):
    """fn on each form of a stack (P (S, m+1, n, n), eq_idx S tuples, xs
    (S, R, n)) in turn, the results stacked."""
    if len(eq_idx) != P.shape[0]:
        raise ValueError(f"a stack of {P.shape[0]} forms needs as many "
                         f"equality patterns, got {len(eq_idx)}")
    if P.shape[0] == 0:
        return xs.clone()
    return torch.stack([fn(P[s], q[s], r[s], eq_idx[s], xs[s], *args)
                        for s in range(P.shape[0])])


def two_phase_sweeps_ref(P, q, r, eq_idx, xs, num_iters=1000, viol_tol=1e-2,
                         tol=1e-4, n_bisect=40, phase1=True):
    """Plain PyTorch version of K1 (two-phase), in the inputs' dtype.
    xs (R, n) -> (R, n); a stack (S, R, n) -> (S, R, n), scenario by
    scenario."""
    if P.dim() == 4:
        return _per_scenario(two_phase_sweeps_ref, P, q, r, eq_idx, xs,
                             num_iters, viol_tol, tol, n_bisect, phase1)
    ctx = _Ctx(P, q, r, eq_idx)
    x = xs.T.clone()
    if phase1:
        _phase1_loop(ctx, x, int(num_iters), tol, viol_tol, int(n_bisect))
    _phase2_loop(ctx, x, int(num_iters), tol, viol_tol)
    return x.T.contiguous()


def phase1_sweeps_ref(P, q, r, eq_idx, xs, num_iters=1000, viol_tol=1e-2,
                      tol=1e-4, n_bisect=40):
    """Plain PyTorch version of K1 with phase 2 off (a stack as in
    two_phase_sweeps_ref)."""
    if P.dim() == 4:
        return _per_scenario(phase1_sweeps_ref, P, q, r, eq_idx, xs,
                             num_iters, viol_tol, tol, n_bisect)
    ctx = _Ctx(P, q, r, eq_idx)
    x = xs.T.clone()
    _phase1_loop(ctx, x, int(num_iters), tol, viol_tol, int(n_bisect))
    return x.T.contiguous()


# K1's launch geometry (csrc/cd_sweep.cu): one warp per restart, each with
# its state in its slice of the block's dynamic shared memory.
MAX_WARPS = 4                  # restarts a block (kMaxWarps in the source)
MAX_SCENARIOS = 65535          # forms a launch (the grid's y dimension)


def warp_floats(n, m, e):
    """Shared floats one restart's state takes at n, m, E: x (n), the warm
    brackets (2n), F, t2, t1, t0 (m+1 each) and five canonical fields of
    the m+E rows, rounded up to 16 bytes."""
    return -(-(3 * n + 4 * (m + 1) + 5 * (m + e)) // 4) * 4


def holds(n, m, e):
    """Does K1 hold one restart at n, m, E (for a stack, its largest E)?
    True when one warp's state fits in SMEM_BLOCK_MAX, K1's only limit on
    the shape; no card and no launch needed.  The CD route's rule
    (solvers/coord_descent_fused.py) and `launch_geometry` both read it.
    Under it the kernel's int offsets into Pt (up to n (m+1)) stay below
    2^31: 3n + 9m < 58,112 bounds n (m+1) by about 3.2e7."""
    return 4 * warp_floats(n, m, e) <= SMEM_BLOCK_MAX


def launch_geometry(n, m, e, R=None, sms=None):
    """(warps a block, shared floats a warp, shared bytes a block) for K1
    at n, m, E (for a stack: its largest E, and R = S x R restarts).  Up
    to MAX_WARPS warps within SMEM_BLOCK_MAX; given R and the card's SM
    count, fewer, so that a small batch spreads over the SMs.  Raises
    ValueError where K1 does not hold a restart (`holds`)."""
    floats = warp_floats(n, m, e)
    per_warp = 4 * floats
    if not holds(n, m, e):
        raise ValueError(
            f"cd_sweeps: one restart's state at n={n}, m={m}, E={e} takes "
            f"{per_warp} bytes of shared memory, above the {SMEM_BLOCK_MAX} "
            "a block may use")
    warps = min(MAX_WARPS, SMEM_BLOCK_MAX // per_warp)
    if R is not None and sms:
        warps = max(1, min(warps, R // sms))
    return warps, floats, warps * per_warp


def lane_layout(P, q):
    """P (..., m+1, n, n) and q (..., m+1, n) as K1 reads them, in one
    pass for a stack: Pt (..., n, n, m+1) with Pt[..., a, b, i] =
    P[..., i, a, b] and qt (..., n, m+1), so that the 32 lanes of a warp,
    one row each, read 32 adjacent words.  A layout only."""
    return P.movedim(-3, -1).contiguous(), q.transpose(-1, -2).contiguous()


def eq_arrays(eq_idx, m):
    """The stack's equality patterns as K1 reads them: the row masks
    (S, m) as float32, the index lists (S, E_max) as int32 padded with 0,
    and the counts (S,) as int32, on the host.  Each index must lie in
    [0, m)."""
    eqs = [tuple(int(i) for i in e) for e in eq_idx]
    e_max = max((len(e) for e in eqs), default=0)
    mask = np.zeros((len(eqs), m), np.float32)
    idx = np.zeros((len(eqs), e_max), np.int32)
    for s, e in enumerate(eqs):
        if any(i < 0 or i >= m for i in e):
            raise ValueError(f"cd_sweeps: equality rows {e} outside [0, {m})")
        mask[s, list(e)] = 1.0
        idx[s, :len(e)] = e
    return mask, idx, np.array([len(e) for e in eqs], np.int32)


def _launch(P, q, r, eq_idx, xs, num_iters, viol_tol, tol, n_bisect,
            phase1, phase2):
    single = P.dim() == 3
    if single:
        P, q, r, xs, eq_idx = P[None], q[None], r[None], xs[None], [eq_idx]
    S, k1, n = P.shape[0], P.shape[1], P.shape[-1]
    m = k1 - 1
    R = xs.shape[-2] if xs.dim() == 3 else -1
    _check_cuda("cd_sweeps", [P, q, r, xs],
                [(S, k1, n, n), (S, k1, n), (S, k1), (S, R, n)])
    if len(eq_idx) != S:
        raise ValueError(f"cd_sweeps: a stack of {S} forms needs as many "
                         f"equality patterns, got {len(eq_idx)}")
    if S > MAX_SCENARIOS:
        raise ValueError(f"cd_sweeps: {S} scenarios in one launch, above "
                         f"the grid's {MAX_SCENARIOS}")
    mask, idx, counts = eq_arrays(eq_idx, m)
    e_max = idx.shape[1]
    dev = P.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    warps, floats, _ = launch_geometry(n, m, e_max, S * R, sms)
    mask, idx, counts = (torch.from_numpy(a.reshape(-1) if a.size else
                                          np.zeros(1, a.dtype)).to(dev)
                         for a in (mask, idx, counts))
    Pt, qt = lane_layout(P, q)
    x = xs.clone()                                   # (S, R, n), in/out
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.qk_cd_sweeps(Pt.data_ptr(), qt.data_ptr(), r.data_ptr(),
                              mask.data_ptr(), idx.data_ptr(),
                              counts.data_ptr(), e_max, x.data_ptr(), n, m,
                              S, R, int(num_iters), float(tol),
                              float(viol_tol), int(n_bisect),
                              int(bool(phase1)), int(bool(phase2)), warps,
                              floats, stream)
    _build.check(rc, "qk_cd_sweeps")
    return x[0] if single else x


def two_phase_sweeps(P, q, r, eq_idx, xs, num_iters=1000, viol_tol=1e-2,
                     tol=1e-4, n_bisect=40, phase1=True):
    """The full two-phase CD improve for a restart batch in one launch
    (reference: qcqp/qcqp.py:181-192, the phase-2 gate of qcqp.py:189-190
    applied per lane).  phase1=False skips straight to phase 2.  A stack
    of forms with xs (S, R, n) is one launch too (module docstring).

    CPU tensors run the plain version; CUDA tensors launch K1 (float32
    only, counted in `two_phase_sweeps.launches`, one a launch)."""
    if not xs.is_cuda:
        return two_phase_sweeps_ref(P, q, r, eq_idx, xs, num_iters, viol_tol,
                                    tol, n_bisect, phase1)
    out = _launch(P, q, r, eq_idx, xs, num_iters, viol_tol, tol, n_bisect,
                  phase1, True)
    two_phase_sweeps.launches += 1
    return out


def phase1_sweeps(P, q, r, eq_idx, xs, num_iters=1000, viol_tol=1e-2,
                  tol=1e-4, n_bisect=40):
    """Phase 1 only, in one launch of K1 (counted in
    `phase1_sweeps.launches`)."""
    if not xs.is_cuda:
        return phase1_sweeps_ref(P, q, r, eq_idx, xs, num_iters, viol_tol,
                                 tol, n_bisect)
    out = _launch(P, q, r, eq_idx, xs, num_iters, viol_tol, tol, n_bisect,
                  True, False)
    phase1_sweeps.launches += 1
    return out


two_phase_sweeps.launches = 0
phase1_sweeps.launches = 0
