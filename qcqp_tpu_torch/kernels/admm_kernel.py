"""K3: one whole consensus-ADMM phase of a restart batch in one kernel
launch (JAX counterpart: qcqp_tpu/kernels/admm_pallas.py).

`admm_phase` is the wrapper: on CUDA float32 tensors it launches the
hand-written kernel in `csrc/admm_impl.cuh` (entry `csrc/admm.cu`); on
CPU tensors it runs `admm_phase_ref`, the plain PyTorch version.  A CUDA
tensor the kernel does not take raises; nothing falls back from the GPU
to the plain version.  `improve_admm_fused` is the two-phase improve
around it, with the reference's better-folds between the phases
(qcqp.py:281,284-285), as plain PyTorch, as they are plain XLA in the JAX
package.

Routing rule, decided before any launch: K3 runs for m > 0 and n <= MAX_N;
m == 0 and wider problems run the unfused path (solvers/admm.py), as the
JAX package routes n > 1,024 to its vmapped path.  Inside K3,
`launch_geometry` picks the storage from n alone: up to WHOLE_MAX_N the
whole Q_i is one shared-memory slab and a lane keeps its coordinates in
registers; above it Q_i is streamed in CHUNK_ROWS-row and -column chunks
and the lane vectors live in shared memory.  Nothing falls back at run
time.

What the TPU kernel computes, per restart: the primal and dual copies xh,
uh (m, n) in per-constraint eigencoordinates; the z-update (the consensus
mean in phase 1, rhs W in phase 2, W = inv(2 (P0 + rho m I))); each
constraint's projection by the secular equation, bracketed by 10 doublings
and three x1024 jumps where some row is one-side unbounded (`need_dbl`) and
solved by `nw` safeguarded Newton trips; the inequality fast path; phase
2's best point under the bucketised `better`.  Every gate is per restart,
so a restart's result does not depend on which restarts share its block.

Left out on purpose, as TPU artefacts: the constraint chunks of 5 and the
inert pad rows (and their `- pad z_old` correction), the VMEM budget
`admm_fused_fits`, the try/except fallback to the vmapped path and the
ADMM_* environment knobs.

Exactness.  The kernel is built with -fmad=false, and the plain version
runs one correctly rounded PyTorch op per kernel op, in the kernel's order:
the products with Q, W and P0 sum over k in order (`_rowvec`), and every
sum over the eigencoordinates j is the kernel's warp reduction (`_tree_sum`:
a shuffle tree inside each chunk of 32 zero-padded coordinates, then the
chunks in order).  Divisions take a tensor divisor, since PyTorch's CUDA
division by a Python scalar multiplies by its reciprocal.  So K3 equals its
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
from .onevar_kernel import SMEM_BLOCK_MAX, _check_cuda, _sm_count, tally

logger = logging.getLogger("qcqp_tpu_torch")

MAX_N = 1024       # the widest form K3 takes (the JAX package's limit)
NW_TRIPS = 6       # secular Newton trips (admm_pallas.py:74)
_DBL_TRIPS = ((2.0, 10), (1024.0, 3))   # doublings, then the x1024 jumps
_NAN = float("nan")


def takes(form: QCQPForm) -> bool:
    """The routing rule, decided before any launch: K3 takes m > 0 and
    n <= MAX_N."""
    return form.m > 0 and form.n <= MAX_N


class ADMMFusedData:
    """One-time per-(form, rho) setup, the analog of the reference's caches:
    per-constraint eighs on `f.eigh` (qcqp/utilities.py:160-162) and the
    z-update factorization keyed on rho (qcqp/qcqp.py:224-227).

    Computed on the host in numpy float64 with the same calls as the JAX
    package's ADMMFusedData (admm_pallas.py:458-506), then cast to float32
    on the form's device, so both packages' tensors are equal on the real
    rows."""

    def __init__(self, form: QCQPForm, rho=None):
        n, m = form.n, form.m
        P = form.P.detach().cpu().double().numpy()
        q = form.q.detach().cpu().double().numpy()
        r = form.r.detach().cpu().double().numpy()
        eq = form.is_eq.detach().cpu().numpy().astype(bool)

        lam, Q = np.linalg.eigh(P[1:])
        qhat = np.einsum("mij,mi->mj", Q, q[1:])
        if rho is None:
            lmb_min = float(np.linalg.eigvalsh(P[0]).min())
            rho = 50.0 * (2.0 * (1.0 - lmb_min) / m if lmb_min < 0
                          else 1.0 / m)
        rho = float(rho)
        W = np.linalg.inv(2.0 * (P[0] + rho * m * np.eye(n)))

        dev = form.device
        f32 = lambda a: torch.tensor(np.ascontiguousarray(a),
                                     dtype=torch.float32, device=dev)
        # r0 as the float32 value both kernels add
        self.m, self.n, self.rho = m, n, rho
        self.r0 = float(np.float32(r[0]))
        self.need_dbl = bool(np.any(lam.max(axis=1) <= 0.0)
                             or np.any(lam.min(axis=1) >= 0.0))
        self.Q = f32(Q)                                  # (m, n, n)
        self.lam, self.qhat = f32(lam), f32(qhat)        # (m, n)
        self.r = f32(r[1:])                              # (m,)
        self.eq = f32(eq.astype(np.float64))
        self.lmax, self.lmin = f32(lam.max(axis=1)), f32(lam.min(axis=1))
        self.W, self.P0, self.q0 = f32(W), f32(P[0]), f32(q[0])
        self.rho32 = f32(rho)
        self.form32 = QCQPForm(form.P.float(), form.q.float(),
                               form.r.float(), form.is_eq)


# ---------------------------------------------------------------------------
# The plain version: one PyTorch op per kernel op, in the kernel's order.
# ---------------------------------------------------------------------------

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


def _viols(d, f):
    """Per-constraint violations of f (R, m)."""
    return torch.where(d.eq > 0.5, f.abs(), _nmax(f, torch.zeros_like(f)))


def _fvals(d, pts):
    """f_i at eigencoordinate points pts (R, m, n) -> (R, m)."""
    return _tree_sum((d.lam * pts + d.qhat) * pts) + d.r


def _consensus(d, xh, uh):
    """sum_i (xh_i - uh_i) Q_i^T -> (R, n), the per-i products summed over
    i in order (Q_i^T as a view: the kernel reads Q_i by columns)."""
    part = _rowvec(xh - uh, d.Q.transpose(-1, -2))       # (R, m, n)
    acc = torch.zeros_like(part[:, 0])
    for i in range(part.shape[1]):
        acc = acc + part[:, i]
    return acc


def _objective(d, z):
    Pz = _rowvec(z, d.P0)
    return (_tree_sum(z * Pz) + _tree_sum(d.q0 * z)) + d.r0


def _project_all(d, z, xh, uh, live, nw):
    """Project every constraint at z (R, n), updating the live restarts'
    xh, uh (R, m, n) in place; returns the max violation of z (R,)."""
    lam, qh, rr = d.lam, d.qhat, d.r
    zh = _rowvec(z[:, None, :], d.Q)                     # (R, m, n)
    viol = _viol_chain(_viols(d, _fvals(d, zh)))
    vh = zh + uh
    fv = _fvals(d, vh)
    skip = (d.eq < 0.5) & (fv <= 0.0)    # fast path (utilities.py:157-158)

    def xhat_of(nu):
        den = 2.0 * (1.0 + nu[..., None] * lam)
        den = torch.where(den == 0.0, 1e-30, den)
        return (2.0 * vh - nu[..., None] * qh) / den

    def phi(nu):
        x = xhat_of(nu)
        return _tree_sum((lam * x + qh) * x) + rr

    s_bnd, e_bnd = d.lmax > 0.0, d.lmin < 0.0
    s = torch.where(s_bnd, torch.full_like(d.lmax, -1.0) / d.lmax, -1.0)
    e = torch.where(e_bnd, torch.full_like(d.lmin, -1.0) / d.lmin, 1.0)
    s, e = s.expand_as(fv), e.expand_as(fv)
    if d.need_dbl:
        s_unb, e_unb = ~s_bnd & ~skip, ~e_bnd & ~skip
        for factor, trips in _DBL_TRIPS:
            for _ in range(trips):
                s = torch.where(s_unb & (phi(s) <= 0.0), s * factor, s)
                e = torch.where(e_unb & (phi(e) >= 0.0), e * factor, e)
    g0 = qh + 2.0 * lam * vh                             # nu-independent
    zero = torch.zeros_like(fv)
    s = torch.where(fv > 0.0, _nmax(s, zero), s)
    e = torch.where(fv < 0.0, _nmin(e, zero), e)
    nu = 0.5 * (s + e)
    for _ in range(nw):
        den = 2.0 * (1.0 + nu[..., None] * lam)
        den = torch.where(den == 0.0, 1e-30, den)
        inv = torch.ones_like(den) / den
        x = (2.0 * vh - nu[..., None] * qh) * inv
        p = _tree_sum((lam * x + qh) * x) + rr
        dp = -2.0 * _tree_sum((2.0 * lam * x + qh) * g0 * inv * inv)
        s = torch.where(p >= 0.0, nu, s)
        e = torch.where(p <= 0.0, nu, e)
        cand = nu - p / dp
        inside = (cand > s) & (cand < e)                 # False for NaN
        nu = torch.where(inside, cand, 0.5 * (s + e))
    xc = torch.where(skip[..., None], vh, xhat_of(nu))
    live3 = live[:, None, None]
    uh.copy_(torch.where(live3, uh + zh - xc, uh))
    xh.copy_(torch.where(live3, xc, xh))
    return viol


def _f32(value, like):
    """A scalar as a float32 tensor of like's shape (a tensor divisor)."""
    return torch.full_like(like, float(np.float32(value)))


def admm_phase_ref(d: ADMMFusedData, xs, phase, num_iters=1000, tol=1e-2,
                   viol_lim=1e4, better_tol=1e-4, nw=NW_TRIPS):
    """Plain PyTorch version of K3: one ADMM phase (1 = feasibility
    consensus, reference qcqp.py:195-212; 2 = objective consensus with the
    best-point tracker, qcqp.py:215-251) of xs (R, n) float32 -> (R, n).
    `admm_phase_ref.lane_iters[phase]` counts the iterations run, summed
    over lanes (a tensor after the first call)."""
    tol = float(np.float32(tol))
    viol_lim = float(np.float32(viol_lim))
    R = xs.shape[0]
    xh = _rowvec(xs[:, None, :], d.Q)                    # (R, m, n)
    uh = torch.zeros_like(xh)
    z = xs.clone()
    viol0 = _viol_chain(_viols(d, _fvals(d, xh)))
    if phase == 1:
        viol = viol0
        for _ in range(int(num_iters)):
            live = viol >= tol
            if not bool(live.any()):
                break
            admm_phase_ref.lane_iters[1] = tally(
                admm_phase_ref.lane_iters[1], live.sum())
            total = _consensus(d, xh, uh)
            z = torch.where(live[:, None], total / _f32(d.m, total), z)
            v_new = _project_all(d, z, xh, uh, live, nw)
            viol = torch.where(live, v_new, viol)
        return z

    z_last, out = xs.clone(), xs.clone()
    bb = torch.floor(viol0 / _f32(better_tol, viol0))
    bf = _objective(d, xs)
    done = torch.zeros(R, dtype=torch.bool, device=xs.device)
    two_rho = 2.0 * d.rho32
    for t in range(int(num_iters)):
        live = ~done
        if not bool(live.any()):
            break
        admm_phase_ref.lane_iters[2] = tally(
            admm_phase_ref.lane_iters[2], live.sum())
        rhs = two_rho * _consensus(d, xh, uh) - d.q0
        z = torch.where(live[:, None], _rowvec(rhs, d.W), z)
        v_new = _project_all(d, z, xh, uh, live, nw)
        # the breaks fire before the tracker absorbs z (qcqp.py:241-250)
        dz = z - z_last
        nrm = torch.sqrt(_tree_sum(dz * dz))
        converged = (nrm < tol) if t > 0 else torch.zeros_like(live)
        b = torch.floor(v_new / _f32(better_tol, v_new))
        f = _objective(d, z)
        diverged = v_new > viol_lim
        stop = converged | diverged
        win = live & ~stop & ((b < bb) | ((b == bb) & (f < bf)))
        out = torch.where(win[:, None], z, out)
        bb = torch.where(win, b, bb)
        bf = torch.where(win, f, bf)
        done = done | (live & stop)
        z_last = torch.where(live[:, None], z, z_last)
    return out


admm_phase_ref.lane_iters = {1: 0, 2: 0}


# ---------------------------------------------------------------------------
# The kernel's wrapper.
# ---------------------------------------------------------------------------

# K3's launch geometry (csrc/admm_impl.cuh): one warp per restart, up to
# MAX_WARPS a block, every slab staged once per block in shared memory.
MAX_WARPS = 16          # restarts a block (kMaxWarps in the source)
WHOLE_MAX_N = 160       # the whole Q_i a slab, 5 coordinates a lane at most
CHUNK_ROWS = 16         # rows (or columns) of Q_i a slab above WHOLE_MAX_N


def launch_geometry(n, m, R=None, sms=None):
    """(warps a block, chunk rows, shared bytes a block) for K3 at n
    eigencoordinates and m constraints.  Chunk rows 0 means the whole Q_i
    is one slab (n <= WHOLE_MAX_N, a lane's C = ceil(n / 32) coordinates in
    registers); else Q_i is streamed CHUNK_ROWS rows, then columns, at a
    time, and a lane's vectors live in shared memory.  A block holds two
    slabs of rows x S floats (S: n rounded up to 4, then to 4 mod 8), 32
    floats past them and a slice a warp of 4 (whole) or 5 vectors of 32 C
    floats.  Up to MAX_WARPS warps within SMEM_BLOCK_MAX; given R and the
    card's SM count, at most R / sms rounded up, so that a small batch
    spreads over the SMs.  m sets no shared memory (uh lives in a global
    scratch); K3 needs m >= 1."""
    if not 0 < n <= MAX_N or m < 1:
        raise ValueError(f"K3 takes 0 < n <= {MAX_N} and m >= 1, got "
                         f"n = {n}, m = {m}")
    whole = n <= WHOLE_MAX_N
    rows = n if whole else CHUNK_ROWS
    S = -(-n // 4) * 4
    slab = rows * (S if S // 4 % 2 else S + 4)
    warp = (4 if whole else 5) * 32 * -(-n // 32)
    fixed = 4 * (2 * slab + 32)
    warps = min(MAX_WARPS, (SMEM_BLOCK_MAX - fixed) // (4 * warp))
    if R is not None and sms:
        warps = max(1, min(warps, -(-R // sms)))
    return warps, 0 if whole else CHUNK_ROWS, fixed + 4 * warps * warp


def _launch(d, xs, phase, num_iters, tol, viol_lim, better_tol, nw,
            geometry=None):
    """One launch of K3.  geometry: (warps, chunk rows, _) in place of
    launch_geometry's, as the checks that force a full block or the
    chunked storage pass it; the C entry refuses one that does not fit."""
    m, n = d.m, d.n
    R = xs.shape[0]
    _check_cuda("admm_phase",
                [d.Q, d.lam, d.qhat, d.r, d.eq, d.lmax, d.lmin, d.W, d.P0,
                 d.q0, xs],
                [(m, n, n), (m, n), (m, n), (m,), (m,), (m,), (m,), (n, n),
                 (n, n), (n,), (R, n)])
    if not 0 < n <= MAX_N:
        raise ValueError(f"admm_phase: K3 takes 0 < n <= {MAX_N}, got {n}")
    warps, chunk_rows, _ = geometry or launch_geometry(
        n, m, R, _sm_count(xs.device))
    out = torch.empty_like(xs)
    uh = torch.empty((max(R, 1), m, n), dtype=torch.float32,
                     device=xs.device)
    lib = _build.library()
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = lib.qk_admm_phase(
            d.Q.data_ptr(), d.lam.data_ptr(), d.qhat.data_ptr(),
            d.r.data_ptr(), d.eq.data_ptr(), d.lmax.data_ptr(),
            d.lmin.data_ptr(), d.W.data_ptr(), d.P0.data_ptr(),
            d.q0.data_ptr(), xs.data_ptr(), out.data_ptr(), uh.data_ptr(),
            n, m, R, int(phase), int(num_iters), float(tol),
            float(viol_lim), float(better_tol), float(d.rho32),
            float(d.r0), int(d.need_dbl), int(nw), int(warps),
            int(chunk_rows), stream)
    _build.check(rc, "qk_admm_phase")
    return out


def admm_phase(d: ADMMFusedData, xs, phase, num_iters=1000, tol=1e-2,
               viol_lim=1e4, better_tol=1e-4, nw=NW_TRIPS):
    """One whole ADMM phase of the restart batch xs (R, n) float32.

    CPU tensors run the plain version; CUDA tensors launch K3 (float32,
    contiguous; counted in `admm_phase.launches`), the host's part of each
    launch in the span `qcqp.k3.host` (diagnostics.span)."""
    if not xs.is_cuda:
        return admm_phase_ref(d, xs, phase, num_iters, tol, viol_lim,
                              better_tol, nw)
    with span("qcqp.k3.host"):
        out = _launch(d, xs, phase, num_iters, tol, viol_lim, better_tol,
                      nw)
    admm_phase.launches += 1
    return out


admm_phase.launches = 0


def _improve(phase_fn, form, xs, rho, num_iters, viol_lim, tol, phase1,
             better_tol, nw_trips, data):
    if not takes(form):
        from ..solvers.admm import improve_admm_batch
        if form.m:
            logger.info("ADMM: n = %d > %d, the unfused path", form.n, MAX_N)
        return improve_admm_batch(form, xs.to(form.dtype), rho,
                                  num_iters=num_iters, viol_lim=viol_lim,
                                  tol=tol, phase1=phase1)
    if data is None:
        data = ADMMFusedData(form, rho)
    kw = dict(num_iters=num_iters, tol=tol, viol_lim=viol_lim,
              better_tol=better_tol, nw=nw_trips)
    x0 = xs.to(torch.float32).contiguous()
    x1 = x0
    if phase1:
        x1 = better_batch(data.form32, x0, phase_fn(data, x0, 1, **kw),
                          better_tol)
    x2 = phase_fn(data, x1, 2, **kw)
    return better_batch(data.form32, x1, x2, better_tol)


def improve_admm_fused(form: QCQPForm, xs, rho=None, num_iters=1000,
                       viol_lim=1e4, tol=1e-2, phase1=True, better_tol=1e-4,
                       nw_trips=NW_TRIPS, data: ADMMFusedData = None):
    """Batched two-phase ADMM improve through K3 (reference:
    qcqp/qcqp.py:254-285), with the reference's better-folds between the
    stages: x1 = better(x0, phase1(x0)); return better(x1, phase2(x1)).
    xs (R, n) -> (R, n) float32.  Pass a precomputed `data` to reuse the
    one-time setup across calls on the same problem and rho."""
    return _improve(admm_phase, form, xs, rho, num_iters, viol_lim, tol,
                    phase1, better_tol, nw_trips, data)


def improve_admm_fused_ref(form: QCQPForm, xs, rho=None, num_iters=1000,
                           viol_lim=1e4, tol=1e-2, phase1=True,
                           better_tol=1e-4, nw_trips=NW_TRIPS,
                           data: ADMMFusedData = None):
    """improve_admm_fused with the plain version of K3 on any device."""
    return _improve(admm_phase_ref, form, xs, rho, num_iters, viol_lim, tol,
                    phase1, better_tol, nw_trips, data)
