"""The reference of the penalty-CCP improve (the DCCP chain that K4 runs):
a frozen copy, in plain PyTorch, of the penalty convex-concave procedure
of the reference package (qcqp/qcqp.py:288-322) in the fused form the
port's kernel computes: per tile of 64 restarts in lockstep, every block's
quadratic in its row's eigenbasis (the default diagonal DC split), the
consensus ADMM as the inner loop, safeguarded Newton trips for the hinge
prox, warm duals, and the final `better` fold (qcqp.py:318-319).  One
correctly rounded op per step, in a fixed order: rotations summed over k
in order, coordinate sums as a warp's shuffle tree over chunks of 32 then
the chunks in order, the consensus sum in bank order.

It imports nothing of the program.  `improve` returns the per-tile
outer steps and inner trips that the roofline of roofline/k4.py reads.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .problem import better_batch

L_TILE = 64        # restarts per tile
_NAN = float("nan")


def _nmax(a, b):
    """NaN-propagating max with the kernel's tie rule: a > b ? a : b."""
    out = torch.where(a > b, a, b)
    return torch.where(torch.isnan(a) | torch.isnan(b), _NAN, out)


def _nmin(a, b):
    out = torch.where(a < b, a, b)
    return torch.where(torch.isnan(a) | torch.isnan(b), _NAN, out)


def _tree_sum(v):
    """Sum over the last axis as the kernel's warp reduction does:
    coordinates zero-padded to a multiple of 32, a shuffle-down tree (16, 8,
    4, 2, 1) inside each chunk of 32, then the chunk sums added in
    order."""
    n = v.shape[-1]
    n_pad = -(-n // 32) * 32
    v = F.pad(v, (0, n_pad - n)).reshape(v.shape[:-1] + (n_pad // 32, 32))
    for h in (16, 8, 4, 2, 1):
        v = v[..., :h] + v[..., h:2 * h]
    v = v[..., 0]
    acc = v[..., 0]
    for w in range(1, v.shape[-1]):
        acc = acc + v[..., w]
    return acc


def _rowvec(x, M):
    """x (..., n) times M (..., n, n) -> (..., n), out_j = sum_k x_k M_kj
    summed over k = 0, 1, ... in order, one rounding per op."""
    acc = torch.zeros(torch.broadcast_shapes(x.shape, M.shape[:-1]),
                      dtype=x.dtype, device=x.device)
    for k in range(x.shape[-1]):
        acc = acc + x[..., k, None] * M[..., k, :]
    return acc


def _viol_chain(vals):
    """max over the constraint axis (last), from 0, NaN-propagating."""
    v = torch.zeros_like(vals[..., 0])
    for i in range(vals.shape[-1]):
        v = _nmax(v, vals[..., i])
    return v



def _f32(value, like):
    """A scalar as a float32 tensor of like's shape (a tensor divisor)."""
    return torch.full_like(like, float(np.float32(value)))



class FusedData:
    """The one-time per-form set-up of the penalty CCP in its
    eigenbases: host numpy float64 eigh of the float32 form's rows, then
    float32 on the form's device.
    Rows are permuted equality-first; row 0 is the objective.  VT holds
    each V_i transposed, so that both rotations read V coalesced."""

    def __init__(self, form):
        n, m = form.n, form.m
        P = form.P.detach().cpu().double().numpy()
        q = form.q.detach().cpu().double().numpy()
        r = form.r.detach().cpu().double().numpy()
        eq = form.is_eq.detach().cpu().numpy().astype(bool)

        perm = np.concatenate([np.where(eq)[0], np.where(~eq)[0]])
        self.E = int(eq.sum())
        P = np.concatenate([P[:1], P[1 + perm]])
        q = np.concatenate([q[:1], q[1 + perm]])
        r = np.concatenate([r[:1], r[1 + perm]])
        eqp = np.concatenate([[False], eq[perm]])

        lam, V = np.linalg.eigh(P)                   # (m+1, n), (m+1, n, n)
        shift = np.where(lam.min(axis=1) < 0.0, 1.0 - lam.min(axis=1), 0.0)
        lam1 = np.maximum(lam + shift[:, None], 0.0)
        qhat = np.einsum("kij,ki->kj", V, q)

        dev = form.device
        f32 = lambda a: torch.tensor(np.ascontiguousarray(a),
                                     dtype=torch.float32, device=dev)
        self.m, self.n = m, n
        self.V, self.VT = f32(V), f32(np.swapaxes(V, 1, 2))
        self.lam0, self.lam1 = f32(lam), f32(lam1)       # (m+1, n)
        self.qhat, self.q = f32(qhat), f32(q)
        self.shift, self.r = f32(shift), f32(r)          # (m+1,)
        self.eq = f32(eqp.astype(np.float64))



def _consts(tau, mu, tau_max, rho, stall_tol, inner_tol, viol_exit_tol):
    """The knobs as the float32 values both the kernel and the plain
    version use (the JAX kernel's weakly typed Python scalars)."""
    c = lambda v: float(np.float32(v))
    return dict(tau0=c(tau), mu=c(mu), tau_max=c(tau_max), rho0=c(rho),
                stall_tol=c(stall_tol), inner_tol=c(inner_tol),
                viol_exit_tol=c(viol_exit_tol),
                tau_sat=c(0.999 * float(tau_max)))



def _hinge(vh, lam, qt, rb, w, rho, trips):
    """The hinge prox of every block of a bank in its eigencoordinates
    (ccp_pallas.py:70-115).  vh, qt (Rp, C, n); lam (C, n) or (C, 1); rb
    (Rp, C); w = tau and rho (Rp,)."""
    w3, r3 = w[:, None, None], rho[:, None, None]

    def x_of(nu3):
        den = r3 + (2.0 * nu3) * lam
        den = torch.where(den == 0.0, 1e-30, den)
        return (r3 * vh - nu3 * qt) / den, den

    g_v = _tree_sum((lam * vh + qt) * vh) + rb
    x_full, _ = x_of(w3)
    g_full = _tree_sum((lam * x_full + qt) * x_full) + rb
    g0 = qt + (2.0 * lam) * vh
    s = torch.zeros_like(rb)
    e = w[:, None].expand_as(rb).clone()
    nu = 0.5 * e
    for _ in range(trips):
        x, den = x_of(nu[..., None])
        g = _tree_sum((lam * x + qt) * x) + rb
        dg = (-rho[:, None]) * _tree_sum(
            (((2.0 * lam) * x + qt) * g0) / (den * den))
        s = torch.where(g > 0.0, nu, s)
        e = torch.where(g <= 0.0, nu, e)
        cand = nu - g / dg
        inside = (cand >= s) & (cand <= e)          # closed; False for NaN
        mid = torch.where(s > 0.0, torch.sqrt(s * e), e * (1.0 / 1024.0))
        nu = torch.where(inside, cand, mid)
    x_root, _ = x_of(nu[..., None])
    return torch.where((g_v <= 0.0)[..., None], vh,
                       torch.where((g_full >= 0.0)[..., None], x_full,
                                   x_root))


def _linearize(d, x):
    """The per-outer caches at x (Rp, n): x in every eigenbasis (Rp, m+1,
    n); the negative hinges' linear terms qm (Rp, E, n) and constants rm
    (Rp, E); |x|^2; the violation from the rotated copies with the
    unshifted eigenvalues (ccp_pallas.py:167-222)."""
    E = d.E
    xkh = _rowvec(x[:, None, :], d.V)
    xc = xkh[:, 1:]
    fv = _tree_sum((d.lam0[1:] * xc + d.qhat[1:]) * xc) + d.r[1:]
    vi = torch.where(d.eq[1:] > 0.5, fv.abs(), _nmax(fv, torch.zeros_like(fv)))
    viol = _viol_chain(vi) if d.m else torch.zeros_like(x[:, 0])
    t = d.lam1[1:E + 1] * xkh[:, 1:E + 1]
    qm = (-d.q[1:E + 1]) - 2.0 * _rowvec(t, d.VT[1:E + 1])
    rm = (-d.r[1:E + 1]) + _tree_sum(t * xkh[:, 1:E + 1])
    return xkh, qm, rm, _tree_sum(x * x), viol


def _tiles(v):
    """A per-lane value broadcast from its tile: v (T,) -> (T * 64,)."""
    return v.repeat_interleave(L_TILE)


def _inner_step(d, z, zp, us, lin, tau, rho, trips):
    """One consensus trip of every lane: (z_new, us_new, res)."""
    m, E = d.m, d.E
    xkh, qm, rm, nxk2 = lin[:4]
    r2 = rho[:, None]
    # the objective block (bank row 0)
    u0 = us[:, 0]
    vh = _rowvec(z - u0, d.V[0])
    qt0 = d.qhat[0] - (2.0 * d.shift[0]) * xkh[:, 0]
    xh = (r2 * vh - qt0) / (r2 + 2.0 * d.lam1[0])
    xb = [_rowvec(xh, d.VT[0])]
    # the positive hinges (bank rows 1..m)
    u = us[:, 1:m + 1]
    vh = _rowvec(z[:, None] - u, d.V[1:])
    sh = d.shift[1:, None]
    qt = d.qhat[1:] - (2.0 * sh) * xkh[:, 1:]
    rb = d.r[1:] + d.shift[1:] * nxk2[:, None]
    xb.append(_rowvec(_hinge(vh, d.lam1[1:], qt, rb, tau, rho, trips),
                      d.VT[1:]))
    # the negative hinges of the equality rows (bank rows m+1..): diagonal
    v = z[:, None] - us[:, m + 1:]
    xb.append(_hinge(v, d.shift[1:E + 1, None], qm, rm, tau, rho, trips))
    xb = torch.cat([xb[0][:, None], xb[1], xb[2]], dim=1)     # (Rp, B, n)
    S = xb[:, 0] + u0
    for b in range(1, xb.shape[1]):
        S = S + (xb[:, b] + us[:, b])
    # the inert blocks add z each; the mean is over 2m + 1 blocks
    z_new = (S + float(m - E) * z) / _f32(2 * m + 1, S)
    dev = xb - z_new[:, None]
    pr = dev.abs().amax(dim=(1, 2))
    if m > E:
        pr = _nmax(pr, ((2.0 * z - zp) - z_new).abs().amax(dim=1))
    scale = 1.0 + z_new.abs().amax(dim=1)
    res = _nmax(pr, (z_new - z).abs().amax(dim=1)) / scale
    return z_new, us + dev, res


def ccp_improve_ref(d: FusedData, xs, tau=0.005, mu=1.4, tau_max=1e8,
                    max_iter=60, inner_iters=10, rho=1.0, stall_tol=1e-6,
                    inner_tol=1e-5, viol_exit_tol=1e-4, warm_inner=True,
                    n_newton=5):
    """Plain PyTorch version of K4: the raw improve (no better-fold) of xs
    (R, n) float32, R padded with zero rows to a multiple of 64 that take
    part in their tile's lockstep -> ((R, n), trips): trips (tiles, 2)
    holds the outer steps and the inner trips each tile ran."""
    k = _consts(tau, mu, tau_max, rho, stall_tol, inner_tol, viol_exit_tol)
    R, n = xs.shape
    Rp = -(-R // L_TILE) * L_TILE
    T = Rp // L_TILE
    B = 1 + d.m + d.E
    out = F.pad(xs, (0, 0, 0, Rp - R))
    tau_l = torch.full((Rp,), k["tau0"], dtype=xs.dtype, device=xs.device)
    done = torch.ones(Rp, dtype=xs.dtype, device=xs.device)  # 1 - finished
    us = torch.zeros((Rp, B, n), dtype=xs.dtype, device=xs.device)
    trips = torch.zeros((T, 2), dtype=torch.int32, device=xs.device)
    lin = None
    for it in range(int(max_iter)):
        live_t = done.view(T, L_TILE).amax(dim=1) > 0.5
        if not bool(live_t.any()):
            break
        trips[:, 0] += live_t
        live = _tiles(live_t)
        xk = out
        rho_l = k["rho0"] * _nmax(torch.ones_like(tau_l), torch.sqrt(tau_l))
        if lin is None:
            lin = _linearize(d, xk)
        if it == 0 or not warm_inner:
            us = torch.where(live[:, None, None], 0.0, us)
        z, zp = xk, xk
        go = live
        for _ in range(int(inner_iters)):
            if not bool(go.any()):
                break
            trips[:, 1] += go.view(T, L_TILE)[:, 0]
            z_n, us_n, res = _inner_step(d, z, zp, us, lin, tau_l, rho_l,
                                         n_newton)
            zp = torch.where(go[:, None], z, zp)
            z = torch.where(go[:, None], z_n, z)
            us = torch.where(go[:, None, None], us_n, us)
            # amax propagates NaN, and NaN > tol is False, as jnp.max
            go = go & _tiles(res.view(T, L_TILE).amax(dim=1) > k["inner_tol"])
        nxk = torch.sqrt(lin[3])
        lin = _linearize(d, z)
        dz = z - xk
        dx = torch.sqrt(_tree_sum(dz * dz))
        stalled = dx < k["stall_tol"] * (1.0 + nxk)
        feas = lin[4] < k["viol_exit_tol"]
        finished = stalled & (feas | (tau_l >= k["tau_sat"]))
        out = torch.where(live[:, None], z, out)
        tau_l = torch.where(live, _nmin(tau_l * k["mu"],
                                        torch.full_like(tau_l, k["tau_max"])),
                            tau_l)
        done = torch.where(live, 1.0 - finished.to(xs.dtype), done)
    return out[:R], trips



def improve(form, xs, tau=0.005, mu=1.4, tau_max=1e8, max_iter=60,
            inner_iters=None, rho=1.0, stall_tol=1e-6, inner_tol=1e-5,
            viol_exit_tol=1e-4, warm_inner=True, n_newton=5):
    """The DCCP improve of xs (R, n) at the fused defaults (inner_iters 10,
    20 with warm_inner=False), float32, with the `better` fold of the
    result against its start.  Returns (x (R, n), work): work["trips"] is
    the (tiles, 2) list of outer steps and inner trips, work["E"] the
    equality count."""
    if inner_iters is None:
        inner_iters = 10 if warm_inner else 20
    d = FusedData(form)
    x0 = xs.to(torch.float32).contiguous()
    out, trips = ccp_improve_ref(
        d, x0, tau=tau, mu=mu, tau_max=tau_max, max_iter=max_iter,
        inner_iters=inner_iters, rho=rho, stall_tol=stall_tol,
        inner_tol=inner_tol, viol_exit_tol=viol_exit_tol,
        warm_inner=warm_inner, n_newton=n_newton)
    return (better_batch(form, x0, out),
            {"trips": trips.cpu().tolist(), "E": d.E})
