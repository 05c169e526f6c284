"""Batch-level two-phase coordinate descent through the CD kernels
(JAX counterpart: qcqp_tpu/solvers/coord_descent_fused.py).

Two routes, chosen by the same rule as the JAX package:

  * K1 (kernels/cd_sweep_kernel.two_phase_sweeps): the whole two-phase
    improve in one launch, when the equality pattern is static and
    `_mega_fits` holds (n <= 128);
  * otherwise phase 1 at the batch level with K2
    (kernels/onevar_kernel.phase1_coordinate_update) once per coordinate,
    carrying the gradient cache G (R, m+1, n) and F (R, m+1) between
    launches, then the unfused phase 2 (solvers/coord_descent.py) on the
    restarts that are viol_tol-feasible.

A stack of S forms of one shape (the scenario axis; parallel/scenarios.py)
takes the same rule in `improve_coord_descent_fused_stack`: one K1 launch
for all S x R restarts, or the K2 route one scenario at a time.

`_mega_fits` is the JAX package's TPU VMEM budget, kept as it is so both
packages route alike; deciding the rule for the H100 is a measurement for a
later change.  In PyTorch the form is always concrete, so the equality
pattern is always static; `coord_descent_phase1_fused(eq_idx=None)` runs
the generic K2 variant (data-dependent equality mask), which the JAX
package uses under an outer trace.
"""

from __future__ import annotations

import torch

from ..core import QCQPForm, max_violation_batch
from ..kernels.cd_sweep_kernel import two_phase_sweeps
from ..kernels.onevar_kernel import phase1_coordinate_update
from .coord_descent import _refresh, _viol_from_F, coord_descent_phase2

N_BISECT = 40


def coord_descent_phase1_fused(form: QCQPForm, xs, num_iters=1000,
                               viol_tol=1e-2, tol=1e-4, eq_idx=None):
    """Batched phase 1 (reference: qcqp/qcqp.py:101-148) with K2 per
    coordinate.  xs (R, n) -> (R, n).  Lockstep over the batch, as in the
    JAX package: sweeps run while any restart is alive; the others keep
    their point."""
    R, n = xs.shape
    m = form.m
    x = xs.clone()
    Pdiag = torch.diagonal(form.P, dim1=1, dim2=2)       # (m+1, n)
    eq_rows = form.is_eq[:, None].expand(m, R)
    viol_last = torch.full((R,), float("inf"), dtype=xs.dtype,
                           device=xs.device)
    changed = torch.ones(R, dtype=torch.bool, device=xs.device)
    for _ in range(num_iters):
        alive = (viol_last >= viol_tol) & changed
        if not bool(alive.any()):
            break
        G, F = _refresh(form, x)                   # drift control
        changed_new = torch.zeros_like(changed)
        for k in range(n):
            xk = x[:, k].clone()
            t2 = Pdiag[:, k]
            Gk = G[:, :, k]
            qk = form.q[:, k]
            xc = xk[:, None]
            t1 = 2.0 * (Gk - t2[None, :] * xc) + qk[None, :]
            t0 = (F - xc * (2.0 * Gk + qk[None, :])
                  + t2[None, :] * (xc * xc))
            t1c = t1[:, 1:].T.contiguous()
            t0c = t0[:, 1:].T.contiguous()
            t2c = t2[1:, None].expand(m, R).contiguous()
            active = (t2c != 0) | (t1c != 0)
            vals = F[:, 1:].T
            viol_i = torch.where(eq_rows, vals.abs(),
                                 torch.clamp_min(vals, 0.0))
            viol = (torch.where(active, viol_i, 0.0).amax(dim=0) if m
                    else torch.zeros_like(xk)).contiguous()
            v = phase1_coordinate_update(
                t2c, t1c, t0c, eq_rows, active, xk, viol, tol=tol,
                viol_tol=viol_tol, n_bisect=N_BISECT, eq_idx=eq_idx)
            v = torch.where(alive, v.to(x.dtype), xk)
            changed_new |= v != xk
            G = G + (v - xk)[:, None, None] * form.P[:, :, k][None]
            vc = v[:, None]
            F = t2[None, :] * (vc * vc) + t1 * vc + t0
            x[:, k] = v
        viol_last = _viol_from_F(form, F)
        changed = torch.where(alive, changed_new, changed)
    return x


# VMEM budget of the JAX mega-kernel (a TPU figure, kept as the routing
# rule; see the module docstring).
_MEGA_VMEM_BUDGET = 10 * 2**20


def _mega_fits(form: QCQPForm) -> bool:
    k1, n = form.P.shape[0], form.P.shape[-1]
    npad = -(-n // 8) * 8
    return 2 * k1 * npad * 128 * 4 < _MEGA_VMEM_BUDGET if n <= 128 else False


def improve_coord_descent_fused(form: QCQPForm, xs, num_iters=1000,
                                viol_tol=1e-2, tol=1e-4, phase1=True,
                                eq_idx=None, mega=None):
    """Batched two-phase CD through the kernels.  xs (R, n) -> (R, n).

    eq_idx: the static equality rows (default: read from form.is_eq).
    mega: run K1 (default: whenever `_mega_fits`).
    """
    if eq_idx is None:
        eq_idx = form.eq_idx()
    if mega is None:
        mega = _mega_fits(form)
    if mega:
        return two_phase_sweeps(form.P, form.q, form.r, eq_idx, xs,
                                num_iters=num_iters, viol_tol=viol_tol,
                                tol=tol, n_bisect=N_BISECT,
                                phase1=phase1).to(xs.dtype)
    x = xs.clone()
    if phase1:
        x = coord_descent_phase1_fused(form, x, num_iters, viol_tol, tol,
                                       eq_idx)
    # phase-2 gate (reference: qcqp/qcqp.py:189-190), per restart
    idx = torch.nonzero(max_violation_batch(form, x) < viol_tol).flatten()
    if idx.numel():
        x[idx] = coord_descent_phase2(form, x[idx], num_iters, viol_tol, tol)
    return x


def improve_coord_descent_fused_stack(stacked: QCQPForm, xs, num_iters=1000,
                                      viol_tol=1e-2, tol=1e-4, phase1=True,
                                      eq_idx=None, mega=None):
    """The same improve for S stacked forms of one shape (P (S, m+1, n, n),
    ...), xs (S, R, n) -> (S, R, n): where K1 runs (`mega`, default
    `_mega_fits` of the shape), one K1 launch for all S x R restarts, each
    scenario with its own equality pattern (eq_idx, when given, for every
    scenario, as the JAX package applies it under vmap); otherwise the K2
    route one scenario at a time."""
    S = stacked.P.shape[0]
    forms = [QCQPForm(*(a[i] for a in stacked)) for i in range(S)]
    if mega is None:
        mega = bool(forms) and _mega_fits(forms[0])
    if not mega:
        out = xs.clone()
        for i, form in enumerate(forms):
            out[i] = improve_coord_descent_fused(
                form, xs[i], num_iters, viol_tol, tol, phase1, eq_idx,
                mega=False)
        return out
    if eq_idx is None:
        eqs = [tuple(int(j) for j in row.nonzero()[0])
               for row in stacked.is_eq.cpu().numpy()]
    else:
        eqs = [eq_idx] * S
    return two_phase_sweeps(stacked.P, stacked.q, stacked.r, eqs, xs,
                            num_iters=num_iters, viol_tol=viol_tol, tol=tol,
                            n_bisect=N_BISECT, phase1=phase1).to(xs.dtype)
