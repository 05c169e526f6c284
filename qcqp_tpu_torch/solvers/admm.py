"""Consensus ADMM improve, batched over restarts
(JAX counterpart: qcqp_tpu/solvers/admm.py).

Reference: qcqp/qcqp.py:195-285.  Phase 1 runs feasibility-only
consensus (z = mean of the per-constraint copies); phase 2 adds the
objective through a z-update factorized once per rho (a dense Cholesky of
2 (P0 + rho m I), the analog of the reference's cached SuperLU
factorization, qcqp.py:224-227).  The m per-constraint projections are one
batched call (kernels/projection.py).

The JAX package writes one restart as a `lax.while_loop` and vmaps it.
Here a restart batch xs (R, n) runs in one Python loop whose body updates
only the restarts whose own loop condition still holds, so every restart
follows the trajectory it would follow alone, as under vmap.  This is the
unfused route: the CPU (float64) and the CUDA shapes K3 does not take
(kernels/admm_kernel.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import QCQPForm, better_batch, max_violation_batch
from ..kernels.projection import ConstraintEigh, precompute_eigh, project_all


def _project(form: QCQPForm, eigh: ConstraintEigh, vs, proj_tol):
    """vs (R, m, n): row i of each restart onto constraint set i."""
    return project_all(vs, eigh, form.r[1:], form.is_eq, proj_tol)


def admm_phase1(form: QCQPForm, eigh: ConstraintEigh, x0, tol=1e-2,
                num_iters=1000, proj_tol=1e-6):
    """Feasibility consensus (reference: qcqp/qcqp.py:195-212).
    x0 (R, n) -> z (R, n)."""
    m = form.m
    R = x0.shape[0]
    xs = x0[:, None, :].expand(R, m, form.n).clone()
    us = torch.zeros_like(xs)
    z = x0.clone()
    t = torch.zeros(R, dtype=torch.long, device=x0.device)
    while True:
        go = (t < num_iters) & (max_violation_batch(form, z) >= tol)
        if not bool(go.any()):
            return z
        z_n = (xs.sum(1) - us.sum(1)) / m
        xs_n = _project(form, eigh, z_n[:, None, :] + us, proj_tol)
        us_n = us + z_n[:, None, :] - xs_n
        g2, g3 = go[:, None], go[:, None, None]
        z = torch.where(g2, z_n, z)
        xs = torch.where(g3, xs_n, xs)
        us = torch.where(g3, us_n, us)
        t = t + go.long()


def admm_phase2(form: QCQPForm, eigh: ConstraintEigh, x0, rho, tol=1e-2,
                num_iters=1000, viol_lim=1e4, proj_tol=1e-6,
                better_tol=1e-4):
    """Objective consensus (reference: qcqp/qcqp.py:215-251).
    x0 (R, n) -> best point (R, n).

    Iteration-ordering parity: the convergence / divergence breaks fire
    before the best-point tracker absorbs the current z (qcqp.py:241-250),
    so a converged final z is deliberately not folded into bestx."""
    m, n = form.m, form.n
    R = x0.shape[0]
    P0, q0 = form.P[0], form.q[0]
    lhs = 2.0 * (P0 + rho * m * torch.eye(n, dtype=x0.dtype,
                                           device=x0.device))
    chol = torch.linalg.cholesky(lhs)
    xs = x0[:, None, :].expand(R, m, n).clone()
    us = torch.zeros_like(xs)
    z, last_z, bestx = x0.clone(), x0.clone(), x0.clone()
    t = torch.zeros(R, dtype=torch.long, device=x0.device)
    done = torch.zeros(R, dtype=torch.bool, device=x0.device)
    while True:
        go = (t < num_iters) & ~done
        if not bool(go.any()):
            return bestx
        rhs = 2.0 * rho * (xs.sum(1) - us.sum(1)) - q0
        z_n = torch.cholesky_solve(rhs.T, chol).T
        xs_n = _project(form, eigh, z_n[:, None, :] + us, proj_tol)
        us_n = us + z_n[:, None, :] - xs_n

        converged = (t > 0) & (torch.linalg.vector_norm(last_z - z_n,
                                                        dim=1) < tol)
        diverged = max_violation_batch(form, z_n) > viol_lim
        take = go & ~(converged | diverged)
        g2, g3 = go[:, None], go[:, None, None]
        bestx = torch.where(take[:, None],
                            better_batch(form, z_n, bestx, better_tol), bestx)
        z = torch.where(g2, z_n, z)
        last_z = z
        xs = torch.where(g3, xs_n, xs)
        us = torch.where(g3, us_n, us)
        done = done | (go & (converged | diverged))
        t = t + go.long()


def _unconstrained_improve(form: QCQPForm, xs):
    """ADMM degenerates for m == 0 (the reference divides by m and crashes,
    qcqp.py:205,277; quirk not replicated): return the closed-form
    unconstrained minimum when P0 is convex, else the start unchanged.
    xs (R, n) -> (R, n)."""
    lmb, Q = torch.linalg.eigh(form.P[0])
    if not bool(lmb.min() > 1e-10):
        return xs.clone()
    xstar = -0.5 * (Q @ ((Q.T @ form.q[0]) / lmb))
    return better_batch(form, xs, xstar.expand_as(xs))


def auto_rho(form: QCQPForm) -> torch.Tensor:
    """Reference auto-rho heuristic (qcqp/qcqp.py:270-278)."""
    lmb_min = torch.linalg.eigvalsh(form.P[0]).min()
    rho = torch.where(lmb_min < 0, 2.0 * (1.0 - lmb_min) / form.m,
                      torch.ones_like(lmb_min) / form.m)
    return rho * 50.0


def min_valid_rho(form: QCQPForm) -> torch.Tensor:
    """Smallest rho keeping the z-update convex: lmb_min(P0) + m rho >= 0
    (reference validation: qcqp/qcqp.py:261-268)."""
    return -torch.linalg.eigvalsh(form.P[0]).min() / form.m


def improve_admm_batch(form: QCQPForm, xs, rho=None, num_iters=1000,
                       viol_lim=1e4, tol=1e-2, phase1=True,
                       eigh: Optional[ConstraintEigh] = None):
    """Full two-phase ADMM improve of a restart batch xs (R, n)
    (reference: qcqp/qcqp.py:254-285), with the reference's better-folds:
    x1 = better(x0, phase1(x0)); return better(x1, phase2(x1)).

    rho validation against min_valid_rho is the caller's (api layer's)."""
    if form.m == 0:
        return _unconstrained_improve(form, xs)
    if eigh is None:
        eigh = precompute_eigh(form)
    if rho is None:
        rho = auto_rho(form)
    rho = torch.as_tensor(rho, dtype=form.dtype, device=form.device)
    x1 = xs
    if phase1:
        x1 = better_batch(form, xs, admm_phase1(form, eigh, xs, tol,
                                                num_iters))
    return better_batch(form, x1, admm_phase2(form, eigh, x1, rho, tol,
                                              num_iters, viol_lim))


def improve_admm(form: QCQPForm, x0, rho=None, num_iters=1000, viol_lim=1e4,
                 tol=1e-2, phase1=True, eigh: Optional[ConstraintEigh] = None):
    """One restart x0 (n,): improve_admm_batch on a batch of one."""
    return improve_admm_batch(form, x0[None], rho, num_iters, viol_lim, tol,
                              phase1, eigh)[0]
