"""K4: the whole penalty-CCP improve of a restart batch in one kernel launch
(JAX counterpart: qcqp_tpu/kernels/ccp_pallas.py).

`ccp_improve` is the wrapper: on CUDA float32 tensors it launches the
hand-written kernel in `csrc/ccp_impl.cuh`; on CPU tensors it runs
`ccp_improve_ref`, the plain PyTorch version.  A CUDA tensor the kernel
does not take raises; nothing falls back from the GPU to the plain version.
`improve_ccp_fused` is the improve around it, with the reference's final
better-fold (qcqp.py:318-319), as plain PyTorch.

Routing rule, decided before any launch (`takes`): K4 runs for
n <= MAX_N = 256, the widest n its two instantiations take (csrc/
ccp_impl.cuh: 4 groups of 32 coordinates a thread up to n = 128, 8 up to
256).  Its block keeps three (64, NP) float32 arrays in shared memory (z,
the previous z, a staging row for the rotations; NP is n rounded up to 32;
`shared_bytes`): 192 KB at NP = 256, within the 227 KB a block can have.
Wider problems, and use_eigen_split, run the unfused path (solvers/ccp.py).

What the TPU kernel computes, per tile of L_TILE = 64 restarts, in
lockstep: with the default diagonal split every block's quadratic has the
eigenbasis V_i of its row (rows permuted equality-first), so the bank is
B = 1 + m + E blocks: the objective, the m positive hinges, the E negative
hinges of the equality rows (diagonal, lam = shift_i); the m - E inert
negative blocks of inequality rows enter in closed form (they add z to the
consensus sum, |2 z - z_prev - z_new| to the residual, and the mean divides
by 2m + 1).  An outer loop of max_iter penalty steps (tau <- min(mu tau,
tau_max), rho_k = rho0 max(1, sqrt(tau))) skips its body once every lane of
the tile has finished; its inner consensus loop runs at least once and
while any lane's residual exceeds inner_tol; every lane of a running tile
is updated.  The hinge prox is n_newton safeguarded Newton trips.  The
exit's violation is evaluated in the eigenbasis with the unshifted
eigenvalues.  The duals stay warm across outer iterations (warm_inner).

Left out on purpose, as TPU artefacts: the block chunks of 5, the VMEM
budget `ccp_fused_fits` and the fallback to the vmapped path inside the
improve.  The linearization at the end of an outer iteration serves the
next one, whose own linearization at the same point the JAX kernel
recomputes (the same bits).

Exactness.  The kernel is built with -fmad=false, and the plain version
runs one correctly rounded PyTorch op per kernel op, in the kernel's order:
rotations sum over k in order (`_rowvec`), sums over the coordinates are
the kernel's warp reduction in the same order (`_tree_sum`: a tree in each
group of 32 coordinates, then the groups in order), the consensus sum adds
the blocks in bank order, maxima are exact in any order.  So K4 equals its
plain version bit for bit on the card.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F

from ..core import QCQPForm, better_batch
from ..diagnostics import span
from . import _build
from .admm_kernel import _f32, _nmax, _nmin, _rowvec, _tree_sum, _viol_chain
from .onevar_kernel import _check_cuda

logger = logging.getLogger("qcqp_tpu_torch")

L_TILE = 64        # restarts per tile (one CUDA block)
MAX_N = 256        # the widest n an instantiation of K4 takes


def shared_bytes(n: int) -> int:
    """K4's dynamic shared memory at width n (csrc/ccp_impl.cuh, launch):
    z, the previous z and the staging rows, (64, NP) float32 each."""
    NP = -(-n // 32) * 32
    return 4 * 3 * L_TILE * NP


def takes(form: QCQPForm) -> bool:
    """The routing rule, decided before any launch: K4 takes n <= MAX_N."""
    return 0 < form.n <= MAX_N


class CCPFusedData:
    """One-time per-form setup: host numpy float64 eigh with the same calls
    as the JAX package's CCPFusedData (ccp_pallas.py:408-438), then float32
    on the form's device, so both packages' tensors are equal bit for bit.
    Rows are permuted equality-first; row 0 is the objective.  VT holds
    each V_i transposed, so that both rotations read V coalesced."""

    def __init__(self, form: QCQPForm):
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
        self.form32 = QCQPForm(form.P.float(), form.q.float(),
                               form.r.float(), form.is_eq)


def _consts(tau, mu, tau_max, rho, stall_tol, inner_tol, viol_exit_tol):
    """The knobs as the float32 values both the kernel and the plain
    version use (the JAX kernel's weakly typed Python scalars)."""
    c = lambda v: float(np.float32(v))
    return dict(tau0=c(tau), mu=c(mu), tau_max=c(tau_max), rho0=c(rho),
                stall_tol=c(stall_tol), inner_tol=c(inner_tol),
                viol_exit_tol=c(viol_exit_tol),
                tau_sat=c(0.999 * float(tau_max)))


# ---------------------------------------------------------------------------
# The plain version: one PyTorch op per kernel op, in the kernel's order.
# ---------------------------------------------------------------------------

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


def ccp_improve_ref(d: CCPFusedData, xs, tau=0.005, mu=1.4, tau_max=1e8,
                    max_iter=60, inner_iters=10, rho=1.0, stall_tol=1e-6,
                    inner_tol=1e-5, viol_exit_tol=1e-4, warm_inner=True,
                    n_newton=5):
    """Plain PyTorch version of K4: the raw improve (no better-fold) of xs
    (R, n) float32, R padded with zero rows to a multiple of 64 that take
    part in their tile's lockstep -> (R, n).  `ccp_improve_ref.trips` gets
    the (tiles, 2) outer steps and inner trips each tile ran, as K4's
    wrapper keeps them in `ccp_improve.trips`."""
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
    ccp_improve_ref.trips = trips
    return out[:R]


# ---------------------------------------------------------------------------
# The kernel's wrapper.
# ---------------------------------------------------------------------------

def _launch(d, xs, tau, mu, tau_max, max_iter, inner_iters, rho, stall_tol,
            inner_tol, viol_exit_tol, warm_inner, n_newton):
    m, n, E = d.m, d.n, d.E
    R = xs.shape[0]
    _check_cuda("ccp_improve",
                [d.V, d.VT, d.lam0, d.lam1, d.qhat, d.q, d.shift, d.r, d.eq,
                 xs],
                [(m + 1, n, n), (m + 1, n, n), (m + 1, n), (m + 1, n),
                 (m + 1, n), (m + 1, n), (m + 1,), (m + 1,), (m + 1,),
                 (R, n)])
    if not 0 < n <= MAX_N:
        raise ValueError(f"ccp_improve: K4 takes 0 < n <= {MAX_N}, got {n}")
    k = _consts(tau, mu, tau_max, rho, stall_tol, inner_tol, viol_exit_tol)
    Rp = -(-R // L_TILE) * L_TILE
    x0 = F.pad(xs, (0, 0, 0, Rp - R)).contiguous()
    out = torch.empty_like(x0)
    B = 1 + m + E
    f = dict(dtype=torch.float32, device=xs.device)
    banks = torch.empty((2, max(Rp, 1), B, n), **f)          # xs, us
    xkh = torch.empty((max(Rp, 1), m + 1, n), **f)
    qm = torch.empty((max(Rp, 1), max(E, 1), n), **f)
    rm = torch.empty((max(Rp, 1), max(E, 1)), **f)
    trips = torch.zeros((Rp // L_TILE, 2), dtype=torch.int32,
                        device=xs.device)
    lib = _build.library()
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = lib.qk_ccp_improve(
            d.V.data_ptr(), d.VT.data_ptr(), d.lam0.data_ptr(),
            d.lam1.data_ptr(), d.qhat.data_ptr(), d.q.data_ptr(),
            d.shift.data_ptr(), d.r.data_ptr(), d.eq.data_ptr(),
            x0.data_ptr(), out.data_ptr(), banks[0].data_ptr(),
            banks[1].data_ptr(), xkh.data_ptr(), qm.data_ptr(),
            rm.data_ptr(), trips.data_ptr(), n, m, E, Rp, int(max_iter),
            int(inner_iters), int(bool(warm_inner)), int(n_newton),
            k["tau0"], k["mu"], k["tau_max"], k["tau_sat"], k["rho0"],
            k["stall_tol"], k["inner_tol"], k["viol_exit_tol"], stream)
    _build.check(rc, "qk_ccp_improve")
    ccp_improve.trips = trips
    return out[:R]


def ccp_improve(d: CCPFusedData, xs, tau=0.005, mu=1.4, tau_max=1e8,
                max_iter=60, inner_iters=10, rho=1.0, stall_tol=1e-6,
                inner_tol=1e-5, viol_exit_tol=1e-4, warm_inner=True,
                n_newton=5):
    """The raw whole-CCP improve of the restart batch xs (R, n) float32.

    CPU tensors run the plain version; CUDA tensors launch K4 (float32,
    contiguous; counted in `ccp_improve.launches`, with the last launch's
    per-tile trip counts in `ccp_improve.trips`), the host's part of the
    launch in the span `qcqp.k4.host` (diagnostics.span)."""
    args = (d, xs, tau, mu, tau_max, max_iter, inner_iters, rho, stall_tol,
            inner_tol, viol_exit_tol, warm_inner, n_newton)
    if not xs.is_cuda:
        return ccp_improve_ref(*args)
    with span("qcqp.k4.host"):
        out = _launch(*args)
    ccp_improve.launches += 1
    return out


ccp_improve.launches = 0
ccp_improve.trips = None
ccp_improve_ref.trips = None


def _improve(improve_fn, form, xs, tau, mu, tau_max, max_iter, inner_iters,
             rho, stall_tol, inner_tol, viol_exit_tol, warm_inner, n_newton,
             data):
    if inner_iters is None:
        inner_iters = 10 if warm_inner else 20
    if not takes(form):
        from ..solvers.ccp import improve_ccp_batch
        logger.info("DCCP: n = %d > %d, the unfused path", form.n, MAX_N)
        return improve_ccp_batch(form, xs.to(form.dtype), tau=tau, mu=mu,
                                 tau_max=tau_max, max_iter=max_iter,
                                 inner_iters=inner_iters, rho=rho)
    if data is None:
        data = CCPFusedData(form)
    x0 = xs.to(torch.float32).contiguous()
    out = improve_fn(data, x0, tau=tau, mu=mu, tau_max=tau_max,
                     max_iter=max_iter, inner_iters=inner_iters, rho=rho,
                     stall_tol=stall_tol, inner_tol=inner_tol,
                     viol_exit_tol=viol_exit_tol, warm_inner=warm_inner,
                     n_newton=n_newton)
    # the reference folds the DCCP result with `better` (qcqp.py:318-319)
    return better_batch(data.form32, x0, out)


def improve_ccp_fused(form: QCQPForm, xs, tau=0.005, mu=1.4, tau_max=1e8,
                      max_iter=60, inner_iters=None, rho=1.0, stall_tol=1e-6,
                      inner_tol=1e-5, viol_exit_tol=1e-4, warm_inner=True,
                      n_newton=5, data: CCPFusedData = None):
    """Batched whole-improve penalty CCP through K4 (replaces the
    reference's DCCP, qcqp/qcqp.py:288-322), at the JAX kernel's fused
    defaults (ccp_pallas.py:502-525): inner_iters 10 (20 with
    warm_inner=False), inner_tol 1e-5, warm duals, 5 Newton trips.
    xs (R, n) -> (R, n) float32.  Pass a precomputed `data` to reuse the
    one-time setup across calls on the same problem."""
    return _improve(ccp_improve, form, xs, tau, mu, tau_max, max_iter,
                    inner_iters, rho, stall_tol, inner_tol, viol_exit_tol,
                    warm_inner, n_newton, data)


def improve_ccp_fused_ref(form: QCQPForm, xs, tau=0.005, mu=1.4,
                          tau_max=1e8, max_iter=60, inner_iters=None,
                          rho=1.0, stall_tol=1e-6, inner_tol=1e-5,
                          viol_exit_tol=1e-4, warm_inner=True, n_newton=5,
                          data: CCPFusedData = None):
    """improve_ccp_fused with the plain version of K4 on any device."""
    return _improve(ccp_improve_ref, form, xs, tau, mu, tau_max, max_iter,
                    inner_iters, rho, stall_tol, inner_tol, viol_exit_tol,
                    warm_inner, n_newton, data)
