"""The reference's problem and best point: plain PyTorch and NumPy,
importing nothing of the program (a suggest's draw is in
reference/suggest_<name>.py).

A problem is `minimize f_0(x) s.t. f_i(x) <= 0 or == 0`, f_i(x) = x'P_i x
+ q_i'x + r_i, as the harness makes it in NumPy (problems/<config>.py).
`Form` holds it as tensors of one dtype on one device; the evaluators
and the best point are frozen copies of the reference package's
lexicographic `better` order (qcqp/utilities.py:135-146: the violation
bucket floor(v / tol), then the objective, ties to the lowest restart),
batched over restarts; `host_f_v` evaluates a point in float64 on the
host, which is what the comparison judges a claimed (f, v) against.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Form(NamedTuple):
    P: torch.Tensor      # (m+1, n, n), row 0 the objective
    q: torch.Tensor      # (m+1, n)
    r: torch.Tensor      # (m+1,)
    is_eq: torch.Tensor  # (m,) bool
    eq_idx: tuple        # the indices of the equality rows

    @property
    def n(self) -> int:
        return self.P.shape[-1]

    @property
    def m(self) -> int:
        return self.P.shape[0] - 1

    @property
    def device(self):
        return self.P.device


def make_form(arrays, dtype, device) -> Form:
    """The problem's NumPy arrays (P, q, r, is_eq) as a Form: each array
    rounded once to dtype (float32: what the program is handed)."""
    P, q, r, is_eq = arrays
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    eq = np.asarray(is_eq, dtype=bool)
    return Form(t(P), t(q), t(r), torch.tensor(eq, device=device),
                tuple(int(i) for i in np.nonzero(eq)[0]))


def eval_all_batch(form: Form, xs):
    """f_i(x_r) for every restart r and row i -> (R, m+1)."""
    k, n = form.P.shape[0], form.P.shape[-1]
    G = (form.P.reshape(k * n, n) @ xs.T).reshape(k, n, -1)
    F = ((G + form.q[:, :, None]) * xs.T[None]).sum(dim=1) + form.r[:, None]
    return F.T


def eval_objective_batch(form: Form, xs):
    return ((xs @ form.P[0]) * xs).sum(dim=1) + xs @ form.q[0] + form.r[0]


def max_violation_batch(form: Form, xs):
    vals = eval_all_batch(form, xs)[:, 1:]
    v = torch.where(form.is_eq[None, :], vals.abs(), vals.clamp_min(0.0))
    if v.shape[1] == 0:
        return torch.zeros(xs.shape[0], dtype=xs.dtype, device=xs.device)
    return v.max(dim=1).values.clamp_min(0.0)


def violation_bucket(v, tol: float = 1e-4):
    """floor(v / tol), a NaN violation ranked last."""
    b = torch.floor(v / tol)
    return torch.where(torch.isnan(b), float("inf"), b)


def better_batch(form: Form, x1, x2, tol: float = 1e-4):
    """`better` row by row of two restart batches; equal keys prefer x2."""
    v1 = violation_bucket(max_violation_batch(form, x1), tol)
    v2 = violation_bucket(max_violation_batch(form, x2), tol)
    f1, f2 = eval_objective_batch(form, x1), eval_objective_batch(form, x2)
    take1 = (v1 < v2) | ((v1 == v2) & (f1 < f2))
    return torch.where(take1[:, None], x1, x2)


def candidate(form: Form, xs, tol: float = 1e-4):
    """The best restart of xs (R, n) by the `better` order, as
    (bucket, f, v, x) on the host: the first minimal index wins."""
    viols = max_violation_batch(form, xs)
    buckets = violation_bucket(viols, tol)
    fs = eval_objective_batch(form, xs)
    fs_masked = torch.where(buckets == buckets.min(), fs, float("inf"))
    i = int(torch.argmin(fs_masked))
    return (float(buckets[i]), float(fs[i]), float(viols[i]),
            xs[i].double().cpu().numpy())


def pick(cands):
    """The best of per-block candidates (in the blocks' order): the least
    bucket, then the least f, then the first block, which is the first
    minimal restart of the whole batch."""
    b_min = min(c[0] for c in cands)
    j = min((c[1], k) for k, c in enumerate(cands) if c[0] == b_min)[1]
    return cands[j]


def host_f_v(arrays, x):
    """(f_0(x), max violation) of a point x (n,) in float64 on the host,
    from the problem's float32 arrays: |f_i| for an equality, max(f_i, 0)
    for an inequality, 0 when there is no constraint."""
    P, q, r = (np.asarray(a, np.float64) for a in arrays[:3])
    is_eq = np.asarray(arrays[3], bool)
    x = np.asarray(x, np.float64)
    f = (P @ x) @ x + q @ x + r
    vals = f[1:]
    viol = np.where(is_eq, np.abs(vals), np.maximum(vals, 0.0))
    return float(f[0]), float(viol.max(initial=0.0))
