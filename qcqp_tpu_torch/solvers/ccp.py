"""Penalty convex-concave procedure, the DCCP improve, batched over restarts
(JAX counterpart: qcqp_tpu/solvers/ccp.py).

Reference: qcqp/qcqp.py:288-322, which hands the problem to the DCCP
package.  Each CCP iteration linearizes the concave part of every row at
x_k (the split of core.dc_split) and solves

    minimize  fhat0(x) + tau * sum_b max(0, ghat_b(x))

by consensus proximal splitting over B = 2m + 1 blocks: the objective's
prox in closed form in the eigenbasis of P1_0, each hinge's prox by fixed-
trip safeguarded Newton on its multiplier.  An equality row gives two
hinge blocks (f1 - lin f2 <= 0 and f2 - lin f1 <= 0); an inequality row's
negative block is inert (g = -1).  tau grows by mu up to tau_max.

The JAX package writes one restart as nested `lax.while_loop`s and vmaps
it; jax.vmap of a while_loop freezes a lane once its own condition is
false.  Here a restart batch xs (R, n) runs in Python loops whose bodies
update only the restarts whose own outer (not finished, it < max_iter) and
inner (res > inner_tol, t < inner_iters) conditions hold, so every restart
follows the trajectory it would follow alone.  This is the unfused route:
the CPU (float64), use_eigen_split, and the CUDA shapes K4 does not take
(kernels/ccp_kernel.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import (QCQPForm, better_batch, dc_split, dc_split_eigen,
                    max_violation_batch)


class CCPData(NamedTuple):
    """Static per-form data: DC splits and eigenbases of every block."""
    P1: torch.Tensor      # (m+1, n, n) convex parts
    P2: torch.Tensor      # (m+1, n, n) concave parts (as PSD matrices)
    lam1: torch.Tensor    # (m+1, n) eigenvalues of P1, clipped at 0
    V1: torch.Tensor      # (m+1, n, n)
    lam2: torch.Tensor    # (m+1, n)
    V2: torch.Tensor      # (m+1, n, n)


def precompute_ccp(form: QCQPForm, use_eigen_split: bool = False) -> CCPData:
    P1, P2 = dc_split_eigen(form) if use_eigen_split else dc_split(form)
    lam1, V1 = torch.linalg.eigh(P1)
    lam2, V2 = torch.linalg.eigh(P2)
    return CCPData(P1, P2, lam1.clamp_min(0.0), V1, lam2.clamp_min(0.0), V2)


def _rot_in(V, v):
    """V^T v for a bank of blocks: V (C, n, n), v (R, C, n) -> (R, C, n)."""
    return torch.einsum("cij,rci->rcj", V, v)


def _rot_out(V, xt):
    return torch.einsum("cij,rcj->rci", V, xt)


def _hinge_prox(v, lam, V, qb, rb, weight, rho, n_newton=15):
    """argmin_x weight max(0, g(x)) + rho/2 ||x - v||^2 for each block, with
    g(x) = x' P x + qb' x + rb given in the eigenbasis (lam, V) of P.

    v, qb (R, C, n); lam (C, n); V (C, n, n); rb (R, C); weight, rho (R,).
    The multiplier root g(x(nu)) = 0 on (0, weight) by fixed-count
    safeguarded Newton: closed-interval acceptance, and a log-space
    midpoint (sqrt(s e), or e / 1024 while s == 0) when the step leaves
    the bracket (qcqp_tpu/solvers/ccp.py:65-125)."""
    w, rho = weight[:, None], rho[:, None, None]
    vt, qt = _rot_in(V, v), _rot_in(V, qb)

    def g_of(xt):
        return (lam * xt * xt).sum(-1) + (qt * xt).sum(-1) + rb

    def x_of(nu):
        return (rho * vt - nu[..., None] * qt) / (rho + 2.0 * nu[..., None]
                                                  * lam)

    g_v = g_of(vt)
    x_full = x_of(w.expand_as(rb))
    g_full = g_of(x_full)
    g0 = qt + 2.0 * lam * vt
    s = torch.zeros_like(rb)
    e = w.expand_as(rb).clone()
    nu = 0.5 * e
    for _ in range(n_newton):
        den = rho + 2.0 * nu[..., None] * lam
        den = torch.where(den == 0.0, 1e-30, den)
        x = (rho * vt - nu[..., None] * qt) / den
        g = (lam * x * x).sum(-1) + (qt * x).sum(-1) + rb
        dg = -rho[..., 0] * ((2.0 * lam * x + qt) * g0 / (den * den)).sum(-1)
        s = torch.where(g > 0, nu, s)
        e = torch.where(g <= 0, nu, e)
        cand = nu - g / dg
        inside = (cand >= s) & (cand <= e)      # closed; False for NaN
        mid = torch.where(s > 0.0, torch.sqrt(s * e), e * (1.0 / 1024.0))
        nu = torch.where(inside, cand, mid)
    x_root = x_of(nu)
    xt = torch.where((g_v <= 0)[..., None], vt,
                     torch.where((g_full >= 0)[..., None], x_full, x_root))
    return _rot_out(V, xt)


def _obj_prox(v, lam, V, qhat, rho):
    """argmin_x x'P1_0 x + qhat'x + rho/2 ||x - v||^2 (eigenbasis closed
    form); v, qhat (R, n), rho (R,)."""
    vt, qt = v @ V, qhat @ V
    rho = rho[:, None]
    return ((rho * vt - qt) / (rho + 2.0 * lam)) @ V.T


def improve_ccp_batch(form: QCQPForm, xs, tau=0.005, mu=1.4, tau_max=1e8,
                      max_iter=60, inner_iters=200, rho=1.0,
                      use_eigen_split=False, data: CCPData = None,
                      stall_tol=1e-6, inner_tol=1e-7, viol_exit_tol=1e-4):
    """Penalty CCP improve of a restart batch xs (R, n) (replaces the
    reference's DCCP, qcqp/qcqp.py:288-322), with the JAX package's early
    exits per restart: the outer loop stops once the iterate stalls and is
    feasible to viol_exit_tol (or tau has saturated), the inner splitting
    once its consensus residual is below inner_tol.  The result is folded
    with `better` (qcqp.py:318-319)."""
    if data is None:
        data = precompute_ccp(form, use_eigen_split)
    m, n = form.m, form.n
    R = xs.shape[0]
    dev, dt = xs.device, xs.dtype
    q_all, r_all, is_eq = form.q, form.r, form.is_eq
    B = 2 * m + 1
    # the hinge bank: m positive blocks, then m negative blocks (inert for
    # inequality rows: lam 0, q 0, r -1, so g == -1 and the prox is v)
    lam_h = torch.cat([data.lam1[1:],
                       torch.where(is_eq[:, None], data.lam2[1:], 0.0)])
    V_h = torch.cat([data.V1[1:], data.V2[1:]])

    xk = xs.clone()
    tau_k = torch.full((R,), float(tau), dtype=dt, device=dev)
    it = torch.zeros(R, dtype=torch.long, device=dev)
    done = torch.zeros(R, dtype=torch.bool, device=dev)
    while True:
        go = (it < max_iter) & ~done
        if not bool(go.any()):
            break
        rho_k = rho * torch.clamp_min(torch.sqrt(tau_k), 1.0)
        # linearize the concave parts at xk
        P2x = torch.einsum("kij,rj->rki", data.P2, xk)      # (R, m+1, n)
        P1x = torch.einsum("kij,rj->rki", data.P1, xk)
        xP2x = (P2x * xk[:, None]).sum(-1)                  # (R, m+1)
        xP1x = (P1x * xk[:, None]).sum(-1)
        q0_hat = q_all[0] - 2.0 * P2x[:, 0]
        # positive hinges g+ = x'P1 x + (q - 2 P2 xk)'x + (r + xk'P2 xk);
        # negative g- = x'P2 x + (-q - 2 P1 xk)'x + (-r + xk'P1 xk)
        q_h = torch.cat([q_all[1:] - 2.0 * P2x[:, 1:],
                         torch.where(is_eq[:, None],
                                     -q_all[1:] - 2.0 * P1x[:, 1:], 0.0)], 1)
        r_h = torch.cat([r_all[1:] + xP2x[:, 1:],
                         torch.where(is_eq, -r_all[1:] + xP1x[:, 1:], -1.0)],
                        1)

        z = xk.clone()
        us = torch.zeros((R, B, n), dtype=dt, device=dev)
        t = torch.zeros(R, dtype=torch.long, device=dev)
        res = torch.full((R,), float("inf"), dtype=dt, device=dev)
        while True:
            inner = go & (t < inner_iters) & (res > inner_tol)
            if not bool(inner.any()):
                break
            vs = z[:, None] - us
            x_obj = _obj_prox(vs[:, 0], data.lam1[0], data.V1[0], q0_hat,
                              rho_k)
            x_hin = _hinge_prox(vs[:, 1:], lam_h, V_h, q_h, r_h, tau_k, rho_k)
            xb_n = torch.cat([x_obj[:, None], x_hin], dim=1)
            z_n = (xb_n + us).mean(dim=1)
            us_n = us + xb_n - z_n[:, None]
            scale = 1.0 + z_n.abs().amax(-1)
            res_n = torch.maximum((xb_n - z_n[:, None]).abs().amax((1, 2)),
                                  (z_n - z).abs().amax(-1)) / scale
            z = torch.where(inner[:, None], z_n, z)
            us = torch.where(inner[:, None, None], us_n, us)
            res = torch.where(inner, res_n, res)
            t = t + inner.long()

        dx = torch.linalg.vector_norm(z - xk, dim=-1)
        stalled = dx < stall_tol * (1.0 + torch.linalg.vector_norm(xk, dim=-1))
        feas = max_violation_batch(form, z) < viol_exit_tol
        finished = stalled & (feas | (tau_k >= 0.999 * tau_max))
        xk = torch.where(go[:, None], z, xk)
        tau_k = torch.where(go, torch.clamp_max(tau_k * mu, tau_max), tau_k)
        done = done | (go & finished)
        it = it + go.long()
    return better_batch(form, xs, xk)


def improve_ccp(form: QCQPForm, x0, **kwargs):
    """One restart x0 (n,): improve_ccp_batch on a batch of one."""
    return improve_ccp_batch(form, x0[None], **kwargs)[0]
