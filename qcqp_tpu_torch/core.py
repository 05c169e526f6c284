"""Canonical batched QCQP representation and its evaluators, in PyTorch
(JAX counterpart: qcqp_tpu/core.py).

    P : (m+1, n, n)  symmetric; row 0 is the objective, rows 1..m constraints
    q : (m+1, n)
    r : (m+1,)
    is_eq : (m,) bool   relop per constraint (True for '==', False for '<=')

Single-point evaluators take x (n,); the `*_batch` evaluators take a restart
batch xs (R, n) and return one value per restart, the batch dimension that
the JAX package gets from vmap.  torch has no global x64 switch, so the
dtype is explicit: `default_dtype` keeps the JAX package's choice of float64
on the CPU and float32 on an accelerator (qcqp_tpu/api.py:63-66).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def default_device(device=None) -> torch.device:
    """The device a form lands on when the caller names none: the current
    CUDA device (torch.cuda.current_device(), which launch.initialize sets
    to the process' own card), as the JAX package puts a form on the
    process' own accelerator by default.  Without a card this raises
    instead of falling back to the CPU; a caller that wants the CPU says so
    (device="cpu")."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "qcqp_tpu_torch: no CUDA device is available; pass "
                "device=\"cpu\" to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def default_dtype(device) -> torch.dtype:
    """float64 for CPU tensors (parity with the reference's numpy), float32
    for CUDA tensors (the kernels' working type)."""
    return torch.float64 if torch.device(device).type == "cpu" else torch.float32


class QCQPForm(NamedTuple):
    """Batched canonical form of `minimize f0(x) s.t. f_i(x) <= / == 0`."""

    P: torch.Tensor      # (m+1, n, n)
    q: torch.Tensor      # (m+1, n)
    r: torch.Tensor      # (m+1,)
    is_eq: torch.Tensor  # (m,) bool

    @property
    def n(self) -> int:
        return self.P.shape[-1]

    @property
    def m(self) -> int:
        return self.P.shape[0] - 1

    @property
    def dtype(self) -> torch.dtype:
        return self.P.dtype

    @property
    def device(self) -> torch.device:
        return self.P.device

    def eq_idx(self) -> tuple:
        """The static equality pattern: indices of the '==' rows."""
        return tuple(int(i) for i in
                     torch.nonzero(self.is_eq.cpu()).flatten().tolist())


def make_form(P, q, r, is_eq, device=None, dtype=None) -> QCQPForm:
    """Build a QCQPForm from array-likes, symmetrizing P rows
    (reference: qcqp/utilities.py:333,345).  device: default_device()."""
    device = default_device(device)
    dtype = default_dtype(device) if dtype is None else dtype
    P = torch.as_tensor(np.asarray(P), dtype=dtype, device=device)
    P = 0.5 * (P + P.transpose(-1, -2))
    q = torch.as_tensor(np.asarray(q), dtype=dtype, device=device)
    r = torch.as_tensor(np.asarray(r), dtype=dtype, device=device)
    is_eq = torch.as_tensor(np.asarray(is_eq, dtype=bool), device=device)
    if P.ndim != 3 or q.ndim != 2 or r.ndim != 1:
        raise ValueError("expected P (m+1,n,n), q (m+1,n), r (m+1,)")
    if P.shape[0] != q.shape[0] or P.shape[0] != r.shape[0]:
        raise ValueError("inconsistent leading (m+1) dims")
    if is_eq.shape[0] != P.shape[0] - 1:
        raise ValueError("is_eq must have m entries")
    return QCQPForm(P, q, r, is_eq)


# ---------------------------------------------------------------------------
# Single-point evaluators, x (n,)
# ---------------------------------------------------------------------------

def eval_all(form: QCQPForm, x: torch.Tensor) -> torch.Tensor:
    """f_i(x) = x^T P_i x + q_i^T x + r_i for all rows i -> (m+1,)."""
    k, n = form.P.shape[0], form.P.shape[-1]
    Px = (form.P.reshape(k * n, n) @ x).reshape(k, n)
    return (Px + form.q) @ x + form.r


def eval_objective(form: QCQPForm, x: torch.Tensor) -> torch.Tensor:
    return x @ (form.P[0] @ x + form.q[0]) + form.r[0]


def _viol_rows(is_eq, vals):
    return torch.where(is_eq, vals.abs(), vals.clamp_min(0.0))


def violations(form: QCQPForm, x: torch.Tensor) -> torch.Tensor:
    """Per-constraint violations: |f_i| for '==', max(0, f_i) for '<='
    (reference: qcqp/utilities.py:56-62,133-134)."""
    return _viol_rows(form.is_eq, eval_all(form, x)[1:])


def max_violation(form: QCQPForm, x: torch.Tensor) -> torch.Tensor:
    v = violations(form, x)
    # m == 0 has violation 0 (jnp.max(..., initial=0) in the JAX package)
    if v.numel() == 0:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    return v.max().clamp_min(0.0)


def violation_bucket(v: torch.Tensor, tol: float = 1e-4) -> torch.Tensor:
    """floor(v / tol), the first key of the `better` order, with a NaN
    violation ranked last.  A float32 point far enough out (|x| ~ 1e19)
    overflows x'P_i x; summed here as +inf + -inf it gives NaN, where the
    JAX package's dot gives +-inf, so the point ranks last there."""
    b = torch.floor(v / tol)
    return torch.where(torch.isnan(b), float("inf"), b)


def better_key(form: QCQPForm, x: torch.Tensor, tol: float = 1e-4):
    """Lexicographic comparison key (violation bucket, objective)
    (reference: qcqp/utilities.py:135-146)."""
    return (violation_bucket(max_violation(form, x), tol),
            eval_objective(form, x))


def better(form: QCQPForm, x1, x2, tol: float = 1e-4) -> torch.Tensor:
    """The better of two points; equal keys prefer x2
    (reference: qcqp/utilities.py:143-146)."""
    v1, f1 = better_key(form, x1, tol)
    v2, f2 = better_key(form, x2, tol)
    take1 = (v1 < v2) | ((v1 == v2) & (f1 < f2))
    return torch.where(take1, x1, x2)


# ---------------------------------------------------------------------------
# Batched evaluators, xs (R, n)
# ---------------------------------------------------------------------------

def eval_all_batch(form: QCQPForm, xs: torch.Tensor) -> torch.Tensor:
    """f_i(x_r) for every restart r and row i -> (R, m+1)."""
    k, n = form.P.shape[0], form.P.shape[-1]
    G = (form.P.reshape(k * n, n) @ xs.T).reshape(k, n, -1)   # (m+1, n, R)
    F = ((G + form.q[:, :, None]) * xs.T[None]).sum(dim=1) + form.r[:, None]
    return F.T


def eval_objective_batch(form: QCQPForm, xs: torch.Tensor) -> torch.Tensor:
    return ((xs @ form.P[0]) * xs).sum(dim=1) + xs @ form.q[0] + form.r[0]


def max_violation_batch(form: QCQPForm, xs: torch.Tensor) -> torch.Tensor:
    v = _viol_rows(form.is_eq[None, :], eval_all_batch(form, xs)[:, 1:])
    if v.shape[1] == 0:
        return torch.zeros(xs.shape[0], dtype=xs.dtype, device=xs.device)
    return v.max(dim=1).values.clamp_min(0.0)


def better_batch(form: QCQPForm, x1, x2, tol: float = 1e-4) -> torch.Tensor:
    """`better` row by row for restart batches x1, x2 (R, n); equal keys
    prefer x2."""
    v1 = violation_bucket(max_violation_batch(form, x1), tol)
    v2 = violation_bucket(max_violation_batch(form, x2), tol)
    f1, f2 = eval_objective_batch(form, x1), eval_objective_batch(form, x2)
    take1 = (v1 < v2) | ((v1 == v2) & (f1 < f2))
    return torch.where(take1[:, None], x1, x2)


def homogeneous_forms(form: QCQPForm) -> torch.Tensor:
    """Stacked homogeneous forms M_i = [[P_i, q_i/2], [q_i^T/2, r_i]], so
    that (x,1)^T M_i (x,1) == f_i(x) (reference: qcqp/utilities.py:64-67).
    Leading batch axes of the form carry through: (..., m+1, n+1, n+1)."""
    P, q, r = form.P, form.q, form.r
    n = P.shape[-1]
    M = P.new_zeros(P.shape[:-2] + (n + 1, n + 1))
    M[..., :n, :n] = P
    M[..., :n, n] = q / 2
    M[..., n, :n] = q / 2
    M[..., n, n] = r
    return M


def dc_split(form: QCQPForm):
    """Difference-of-convex split of every row, P_i = P1_i - P2_i, both PSD,
    in the reference's default diagonal-shift mode (qcqp/utilities.py:82-89):
    if lambda_min(P) < 0, P2 = (1 - lambda_min) I and P1 = P + P2;
    otherwise P1 = P, P2 = 0.  Returns (P1, P2), each (m+1, n, n)."""
    lmb_min = torch.linalg.eigvalsh(form.P).min(dim=-1).values     # (m+1,)
    shift = torch.where(lmb_min < 0, 1.0 - lmb_min,
                        torch.zeros_like(lmb_min))
    eye = torch.eye(form.n, dtype=form.dtype, device=form.device)
    P2 = shift[:, None, None] * eye
    return form.P + P2, P2


def dc_split_eigen(form: QCQPForm):
    """Eigen-split mode (reference: qcqp/utilities.py:77-81): P1 keeps the
    positive eigenspace, P2 the negated negative eigenspace."""
    lmb, Q = torch.linalg.eigh(form.P)
    pos, neg = lmb.clamp_min(0.0), (-lmb).clamp_min(0.0)
    P1 = torch.einsum("kij,kj,klj->kil", Q, pos, Q)
    P2 = torch.einsum("kij,kj,klj->kil", Q, neg, Q)
    return P1, P2


# ---------------------------------------------------------------------------
# Host-side helpers (numpy): random problem generators used by tests/bench.
# ---------------------------------------------------------------------------

def random_form(rng: np.random.Generator, n: int, m: int,
                eq_frac: float = 0.5, device=None, dtype=None) -> QCQPForm:
    """Dense random QCQP instance (all tensors O(1) scale); the same draws
    as qcqp_tpu.core.random_form for the same generator state."""
    A = rng.standard_normal((m + 1, n, n))
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    q = rng.standard_normal((m + 1, n))
    r = rng.standard_normal(m + 1)
    is_eq = rng.random(m) < eq_frac
    return make_form(P, q, r, is_eq, device=device, dtype=dtype)
