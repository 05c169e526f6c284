"""Augmented-Lagrangian NLP polish, the IPOPT improve, batched over restarts
(JAX counterpart: qcqp_tpu/solvers/nlp.py).

The reference hands the point to the IPOPT interior-point solver
(reference: qcqp/qcqp.py:325-364).  As in the JAX package, the improve is
a classic augmented-Lagrangian method on

    L_mu(x; lmb) = f0(x) + sum_eq [lmb_i f_i + (mu/2) f_i^2]
                 + sum_ineq (mu/2) [max(0, f_i + lmb_i/mu)^2 - (lmb_i/mu)^2]

in two stages: bb_outer_n x bb_inner Barzilai-Borwein steps with a
multiplier update after each sweep, then a num_outer x num_inner damped
semismooth Newton-CG tail, whose generalized Hessian is closed form,

    H = 2 sum_k w_k P_k + sum_i a_i g_i g_i^T,

solved by 25 fixed conjugate-gradient trips, with Levenberg-Marquardt
damping and Armijo backtracking on the AL value.  A diverged stage reverts
to its entry point and the result is folded through `better`, so the
polish cannot lose ground (qcqp.py:359-362).

Batch-explicit: x is (R, n).  The JAX package vmaps one restart's
`while_loop`s, which freezes a lane once its own condition fails while the
batch runs on.  Here each loop is a Python loop over the batch, and each
carry of a lane whose condition fails keeps its value (torch.where selects
the old value), so every lane follows the trajectory it would follow
alone.  Active lanes sit at the same trip of each loop, so the trip counts
are Python integers and the host reads "any lane active" once per outer
trip and once per Newton trip (counted in `improve_nlp.host_reads`); the
BB steps, the CG trips and the Armijo trials run with no read.  The products are plain large products, as in the JAX package (no
Pallas kernel there): Px for every lane as one (R, n) x (n, (m+1) n)
matmul, H as (R, m+1) x (m+1, n^2) plus a bmm for the Gram term, the CG
matvecs as bmm; float32 products run in full float32 (TF32 off).
"""

from __future__ import annotations

import torch

from ..core import QCQPForm, better_batch, eval_all_batch, max_violation_batch


def _layout(form: QCQPForm):
    """P as (n, (m+1) n), so that x @ Pt gives P_k x for every row k, and
    as (m+1, n^2) for the Hessian's weighted sum."""
    k, n = form.P.shape[0], form.n
    return (form.P.permute(2, 0, 1).reshape(n, k * n).contiguous(),
            form.P.reshape(k, n * n))


def _al_terms(form: QCQPForm, x, lmb, mu, Pt, value=True, grad=True):
    """Value, gradient, constraint gradients, t = c + lmb/mu and the
    multiplier coefficients of the AL at x (R, n); lmb (R, m), mu (R,).
    value=False or grad=False skip what the caller does not read (the BB
    steps need no value, the Armijo trials no gradient); the rest is
    computed as with both."""
    R, n = x.shape
    Px = (x @ Pt).view(R, form.m + 1, n)
    vals = ((Px + form.q) * x[:, None, :]).sum(-1) + form.r     # (R, m+1)
    c = vals[:, 1:]
    mu_ = mu[:, None]
    t = c + lmb / mu_
    val = g = gc = coef = None
    if value:
        w_eq = lmb * c + 0.5 * mu_ * c * c
        w_in = 0.5 * mu_ * (torch.clamp_min(t, 0.0) ** 2 - (lmb / mu_) ** 2)
        val = vals[:, 0] + torch.where(form.is_eq, w_eq, w_in).sum(-1)
    if grad:
        grads = 2.0 * Px + form.q                               # (R, m+1, n)
        gc = grads[:, 1:]
        coef = torch.where(form.is_eq, lmb + mu_ * c,
                           mu_ * torch.clamp_min(t, 0.0))
        g = grads[:, 0] + torch.bmm(coef[:, None, :], gc)[:, 0]
    return val, g, gc, t, coef


def _al_value_grad(form: QCQPForm, x, lmb, mu, Pt=None, value=True,
                   grad=True):
    """Value and gradient of the augmented Lagrangian, per lane (None for
    what value / grad turn off)."""
    if Pt is None:
        Pt = _layout(form)[0]
    val, g, _, _, _ = _al_terms(form, x, lmb, mu, Pt, value, grad)
    return val, g


def _al_newton_parts(form: QCQPForm, x, lmb, mu, layout=None):
    """Value, gradient and generalized Hessian (R, n, n) of the AL: the
    curvature weights on the P_k rows plus the Gram term of the equality
    and active-inequality constraint gradients."""
    Pt, Pflat = _layout(form) if layout is None else layout
    R, n = x.shape
    val, grad, gc, t, coef = _al_terms(form, x, lmb, mu, Pt)
    w_full = torch.cat([torch.ones((R, 1), dtype=x.dtype, device=x.device),
                        coef], dim=1)
    mu_ = mu[:, None]
    a = torch.where(form.is_eq, mu_, mu_ * (t > 0.0).to(x.dtype))
    H = 2.0 * (w_full @ Pflat).view(R, n, n) + \
        torch.bmm(gc.transpose(1, 2), gc * a[:, :, None])
    return val, grad, H


def _armijo(form, Pt, xi, p, val, gp, lmb, mu, act):
    """Armijo backtracking on the AL value for the lanes in `act`: the JAX
    loop's 16 halvings, each lane frozen once its test passes, run masked
    with no host read (on the bench form some lane backtracks all 16 times
    on nearly every Newton trip, so a read a trip saves no trial; chip_smoke
    phase nlp_path times both).  Returns (alpha, v_new, trips)."""
    alpha = torch.ones_like(val)
    v_new, _ = _al_value_grad(form, xi - p, lmb, mu, Pt, grad=False)
    trips = torch.zeros_like(val, dtype=torch.long)
    for _ in range(16):
        bt = act & ~(v_new <= val - 1e-4 * alpha * gp)
        alpha_n = alpha * 0.5
        vn, _ = _al_value_grad(form, xi - alpha_n[:, None] * p, lmb, mu, Pt,
                               grad=False)
        alpha = torch.where(bt, alpha_n, alpha)
        v_new = torch.where(bt, vn, v_new)
        trips = trips + bt.long()
    return alpha, v_new, trips


def _newton_step(form, layout, xi, damp, lmb, mu, act, eye):
    """One damped Newton-CG step of every lane (the JAX inner_step);
    returns the new (x, damp, gnorm), which the caller keeps for `act`."""
    val, g, H = _al_newton_parts(form, xi, lmb, mu, layout)
    scale = H.diagonal(dim1=-2, dim2=-1).abs().amax(-1) + 1.0
    Hd = H + (damp * scale)[:, None, None] * eye

    # inexact Newton direction: 25 fixed conjugate-gradient trips
    xcg = torch.zeros_like(g)
    rcg, pcg = g, g
    rs = (g * g).sum(-1)
    for _ in range(25):
        Hp = torch.bmm(Hd, pcg[:, :, None])[:, :, 0]
        denom = (pcg * Hp).sum(-1)
        ok = denom > 1e-30
        alpha = torch.where(ok, rs / torch.where(ok, denom, 1.0), 0.0)
        xcg = xcg + alpha[:, None] * pcg
        rcg = rcg - alpha[:, None] * Hp
        rs_new = (rcg * rcg).sum(-1)
        beta = torch.where(ok, rs_new / torch.clamp_min(rs, 1e-30), 0.0)
        pcg = rcg + beta[:, None] * pcg
        rs = rs_new
    p = xcg
    gp = (g * p).sum(-1)
    # indefinite or failed direction: a safe gradient step, more damping
    ok = torch.isfinite(gp) & (gp > 0.0) & torch.isfinite(p).all(-1)
    p = torch.where(ok[:, None], p, g / scale[:, None])
    gp = torch.where(ok, gp, (g * g).sum(-1) / scale)
    damp = torch.where(ok, damp, damp * 10.0)

    alpha, v_new, trips = _armijo(form, layout[0], xi, p, val, gp, lmb, mu,
                                  act)
    accepted = v_new <= val - 1e-4 * alpha * gp
    x_new = torch.where(accepted[:, None], xi - alpha[:, None] * p, xi)
    # LM damping: full steps relax it, backtracked ones grow it
    damp = torch.where(accepted & (trips == 0),
                       torch.clamp_min(damp / 3.0, 1e-10),
                       torch.where(trips > 0, damp * 3.0, damp))
    gnorm = torch.where(accepted, g.abs().amax(-1),
                        torch.zeros_like(val))     # stall => exit inner
    return x_new, damp, gnorm


def _multipliers(form, x, lmb, mu, bad):
    """First-order multiplier update at x; a diverged lane keeps lmb."""
    c = eval_all_batch(form, x)[:, 1:]
    upd = lmb + mu[:, None] * c
    return torch.where(form.is_eq & ~bad[:, None], upd,
                       torch.where(bad[:, None], lmb,
                                   torch.clamp_min(upd, 0.0)))


def improve_nlp(form: QCQPForm, x0, num_outer: int = 3, num_inner: int = 20,
                mu0: float = 10.0, grad_tol: float = 1e-8,
                feas_tol: float = 1e-8, bb_outer_n: int = 10,
                bb_inner: int = 80):
    """Augmented-Lagrangian improve (the reference's IPOPT method slot) of
    a restart batch x0 (R, n), with the JAX package's schedule and
    defaults.  The Newton loops exit early on the KKT residual; the
    tolerances are floored at 100 eps(dtype) so that float32 can reach
    them."""
    x0 = x0.to(form.dtype)
    dt, dev = x0.dtype, x0.device
    R, n = x0.shape
    eps100 = 100.0 * torch.finfo(dt).eps
    gtol = max(float(grad_tol), eps100)
    ftol = max(float(feas_tol), eps100)
    eye = torch.eye(n, dtype=dt, device=dev)
    layout = _layout(form)
    Pt = layout[0]

    # ---- stage 1: Barzilai-Borwein bulk descent (fixed trips) ----------
    x = x0
    lmb = torch.zeros((R, form.m), dtype=dt, device=dev)
    mu = torch.full((R,), float(mu0), dtype=dt, device=dev)
    viol = max_violation_batch(form, x0)
    for _ in range(bb_outer_n):
        x_in = x
        _, g_prev = _al_value_grad(form, x, lmb, mu, Pt, value=False)
        xi, x_prev = x - 1e-6 * g_prev, x
        for _ in range(bb_inner):
            _, g = _al_value_grad(form, xi, lmb, mu, Pt, value=False)
            sdx = xi - x_prev
            y = g - g_prev
            sy = (sdx * y).sum(-1)
            ss = (sdx * sdx).sum(-1)
            step = torch.where(sy > 1e-12, ss / torch.clamp_min(sy, 1e-12),
                               1e-3)
            step = torch.clamp(step, 1e-8, 1e2)
            xi, x_prev, g_prev = xi - step[:, None] * g, xi, g
        bad = ~torch.isfinite(xi).all(-1)
        x = torch.where(bad[:, None], x_in, xi)
        lmb = _multipliers(form, x, lmb, mu, bad)
        v = max_violation_batch(form, x)
        mu = torch.where(v > 0.5 * viol, torch.clamp_max(mu * 3.0, 1e8), mu)
        viol = v
    x1 = x

    # ---- stage 2: damped Newton-CG tail (early exits) -------------------
    done = torch.zeros(R, dtype=torch.bool, device=dev)
    for _ in range(num_outer):
        go = ~done
        improve_nlp.host_reads += 1
        if not bool(go.any()):
            break
        xi = x
        damp = torch.full((R,), 1e-6, dtype=dt, device=dev)
        gnorm = torch.full((R,), float("inf"), dtype=dt, device=dev)
        for _ in range(num_inner):
            act = go & (gnorm > gtol * (1.0 + xi.abs().amax(-1)))
            improve_nlp.host_reads += 1
            if not bool(act.any()):
                break
            improve_nlp.newton_trips += 1
            x_n, damp_n, gnorm_n = _newton_step(form, layout, xi, damp, lmb,
                                                mu, act, eye)
            xi = torch.where(act[:, None], x_n, xi)
            damp = torch.where(act, damp_n, damp)
            gnorm = torch.where(act, gnorm_n, gnorm)

        # a diverged inner solve reverts to the entry point and stops
        bad = ~torch.isfinite(xi).all(-1)
        x_n = torch.where(bad[:, None], x, xi)
        lmb_n = _multipliers(form, x_n, lmb, mu, bad)
        viol_n = max_violation_batch(form, x_n)
        # KKT exit: feasible and stationary at the updated multipliers
        xs = 1.0 + x_n.abs().amax(-1)
        done_n = bad | ((viol_n < ftol * xs) & (gnorm <= gtol * xs))
        mu_n = torch.where(viol_n > 0.5 * viol,
                           torch.clamp_max(mu * 3.0, 1e8), mu)
        x = torch.where(go[:, None], x_n, x)
        lmb = torch.where(go[:, None], lmb_n, lmb)
        mu = torch.where(go, mu_n, mu)
        viol = torch.where(go, viol_n, viol)
        done = torch.where(go, done_n, done)
    # the BB stage is folded in too: a diverged Newton tail cannot lose
    # the first-order progress
    return better_batch(form, x0, better_batch(form, x1, x))


improve_nlp.host_reads = 0
improve_nlp.newton_trips = 0
