"""Projection onto one (nonconvex) quadratic constraint set, the ADMM
x-update (JAX counterpart: qcqp_tpu/kernels/projection.py).

Solves  argmin ||x - z||^2  s.t.  x^T P x + q^T x + r (relop) 0  exactly,
via the eigendecomposition of P and a bisection on the secular equation
(reference: qcqp/utilities.py:149-196): rotate into the eigenbasis, where
the KKT stationarity gives xhat(nu) = (2 zhat - nu qhat) / (2 (1 + nu lmb))
and phi(nu) = sum lmb xhat^2 + qhat xhat + r decreases monotonically on the
bracket (-1/lmb_max, -1/lmb_min).  Unbounded bracket sides use the
reference's doubling search, capped at _MAX_DOUBLINGS.

The JAX package vmaps the single-constraint `project_onecons` over
constraints and restarts; here every function takes any leading batch
shape, and each loop carries a mask, so each (restart, constraint) pair
follows the trajectory it would follow alone (the doubling while-loops stop
per element, as a vmapped while_loop does).  Plain PyTorch, as the JAX
version is plain XLA; the fused ADMM route uses K3 instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import QCQPForm

DEFAULT_TOL = 1e-6  # bisection tolerance (reference: utilities.py:149)
_MAX_DOUBLINGS = 60


class ConstraintEigh(NamedTuple):
    """Per-constraint eigendecompositions and rotated linear terms.

    lam:  (m, n) eigenvalues of P_i (ascending)
    Q:    (m, n, n) eigenvectors (columns)
    qhat: (m, n) Q_i^T q_i
    """
    lam: torch.Tensor
    Q: torch.Tensor
    qhat: torch.Tensor


def precompute_eigh(form: QCQPForm) -> ConstraintEigh:
    """Batched eigh of all constraint P_i, once per problem."""
    lam, Q = torch.linalg.eigh(form.P[1:])
    qhat = torch.einsum("mij,mi->mj", Q, form.q[1:])
    return ConstraintEigh(lam, Q, qhat)


def _phi(nu, lam, qhat, zhat, r):
    """phi(nu) (...,) and xhat(nu) (..., n); nu, r (...,)."""
    xhat = (2.0 * zhat - nu[..., None] * qhat) / (
        2.0 * (1.0 + nu[..., None] * lam))
    return (lam * xhat * xhat + qhat * xhat).sum(-1) + r, xhat


def project_onecons(z, lam, Q, qhat, r, is_eq, tol=DEFAULT_TOL,
                    max_bisect=100):
    """Project points z (..., n) onto {x : x^T P x + q^T x + r (relop) 0}.

    lam, qhat (..., n), Q (..., n, n), r and is_eq (...,) broadcast against
    z's batch shape; the JAX function is this one at batch shape ()."""
    z, lam, qhat = torch.broadcast_tensors(z, lam, qhat)
    shape = z.shape[:-1]
    r = torch.as_tensor(r, dtype=z.dtype, device=z.device).expand(shape)
    is_eq = torch.as_tensor(is_eq, device=z.device).expand(shape)
    zhat = (Q.transpose(-1, -2) @ z[..., None])[..., 0]

    fz = (lam * zhat * zhat).sum(-1) + (qhat * zhat).sum(-1) + r
    skip = ~is_eq & (fz <= 0)  # fast path (reference: utilities.py:157-158)

    lmb_max = lam.amax(-1)
    lmb_min = lam.amin(-1)

    # Bracket: phi > 0 at s+, phi < 0 at e-.
    s_bounded = lmb_max > 0
    e_bounded = lmb_min < 0
    one = torch.ones_like(lmb_max)
    s = torch.where(s_bounded, -1.0 / torch.where(s_bounded, lmb_max, one),
                    -one)
    e = torch.where(e_bounded, -1.0 / torch.where(e_bounded, lmb_min, -one),
                    one)

    for _ in range(_MAX_DOUBLINGS):
        go = ~s_bounded & (_phi(s, lam, qhat, zhat, r)[0] <= 0)
        if not bool(go.any()):
            break
        s = torch.where(go, s * 2.0, s)
    for _ in range(_MAX_DOUBLINGS):
        go = ~e_bounded & (_phi(e, lam, qhat, zhat, r)[0] >= 0)
        if not bool(go.any()):
            break
        e = torch.where(go, e * 2.0, e)

    for _ in range(max_bisect):
        do = (e - s) > tol  # reference stops at tol (utilities.py:187)
        if not bool(do.any()):
            break
        mid = 0.5 * (s + e)
        p, _ = _phi(mid, lam, qhat, zhat, r)
        s = torch.where(do & (p >= 0), mid, s)
        e = torch.where(do & (p <= 0), mid, e)
    nu = 0.5 * (s + e)
    _, xhat = _phi(nu, lam, qhat, zhat, r)
    x = (Q @ xhat[..., None])[..., 0]
    return torch.where(skip[..., None], z, x)


def project_all(zs, eigh: ConstraintEigh, r, is_eq, tol=DEFAULT_TOL):
    """Projection of zs (..., m, n) onto the m constraint sets, row i onto
    set i."""
    return project_onecons(zs, eigh.lam, eigh.Q, eigh.qhat, r, is_eq, tol)
