"""Batch-level two-phase coordinate descent through the CD kernels
(JAX counterpart: qcqp_tpu/solvers/coord_descent_fused.py).

Two routes:

  * K1 (kernels/cd_sweep_kernel.two_phase_sweeps): the whole two-phase
    improve in one launch, wherever K1 holds a restart
    (`cd_sweep_kernel.holds`: one warp's state, 3n + 4(m+1) + 5(m+E)
    floats, within a block's shared memory);
  * otherwise, or with mega=False, phase 1 at the batch level with K2
    (kernels/onevar_kernel.phase1_coordinate_update) once per coordinate,
    carrying the gradient cache G (R, m+1, n) and F (R, m+1) between
    launches, then the unfused phase 2 (solvers/coord_descent.py) on the
    restarts that are viol_tol-feasible.

A stack of S forms of one shape (the scenario axis; parallel/scenarios.py)
takes the same rule in `improve_coord_descent_fused_stack`, at the stack's
largest E: one K1 launch for all S x R restarts, or the K2 route one
scenario at a time.

The rule is a stated deviation from the JAX routing.  The JAX package's
`_mega_fits` is a budget of 10 MiB of TPU VMEM, which sends every n > 128
(and m > 78 at n = 128) to its K2 route.  K1 on the H100 keeps only a
restart's state in shared memory and streams P from L2 or memory, so its
one limit is `holds`, and it computes what the JAX route computes there
(statistical parity, tests/test_torch_cd_route.py).  The numbers that set
it (benchmarks/cd_routes.py on an NVIDIA H100 80GB HBM3, 700 W power
limit; R = 10,240, bench.py's form, 2 sweeps each): at n = 256, m = 20
(P 5.5 MB, inside the 50 MB L2) K1 took 87.9-97.9 ms a solve against
2,367 ms for the K2 route; at n = 512, m = 50 (P 53.5 MB, past the L2)
584.3-592.8 ms against 4,713 ms.  K1 wins past the L2 as well, so the
rule has no bound on P's bytes.

In PyTorch the form is always concrete, so the equality pattern is always
static; `coord_descent_phase1_fused(eq_idx=None)` runs the generic K2
variant (data-dependent equality mask), which the JAX package uses under
an outer trace.
"""

from __future__ import annotations

import torch

from ..core import QCQPForm, max_violation_batch
from ..diagnostics import span
from ..kernels.cd_sweep_kernel import holds, two_phase_sweeps
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


def _use_k1(mega, n, m, e) -> bool:
    """`mega` resolved at n, m and E (a stack: its largest E): None takes
    K1 wherever it holds a restart (`cd_sweep_kernel.holds`; module
    docstring); True where K1 cannot hold one raises."""
    if mega is None:
        return holds(n, m, e)
    if mega and not holds(n, m, e):
        raise ValueError(f"mega=True: K1 does not hold a restart at n={n}, "
                         f"m={m}, E={e}")
    return bool(mega)


def improve_coord_descent_fused(form: QCQPForm, xs, num_iters=1000,
                                viol_tol=1e-2, tol=1e-4, phase1=True,
                                eq_idx=None, mega=None):
    """Batched two-phase CD through the kernels.  xs (R, n) -> (R, n).

    eq_idx: the static equality rows (default: read from form.is_eq).
    mega: run K1 (default: wherever `cd_sweep_kernel.holds`, that is
    wherever a restart's state fits a block's shared memory, at any n;
    the JAX package stops at n = 128, a TPU budget: a stated deviation,
    whose H100 numbers the module docstring gives); mega=False runs
    phase 1 through K2 and the unfused phase 2.  mega=True on a shape K1
    cannot hold raises, on the CPU too.

    The span `qcqp.k1.host` holds the host's part of a K1 launch: the
    equality rows read back, then two_phase_sweeps up to the launch (on
    CPU tensors the plain version too).  On the K2 route it holds only the
    read-back.
    """
    with span("qcqp.k1.host"):
        if eq_idx is None:
            eq_idx = form.eq_idx()
        if _use_k1(mega, form.n, form.m, len(eq_idx)):
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
    `cd_sweep_kernel.holds` at the stack's largest E), one K1 launch for
    all S x R restarts, each scenario with its own equality pattern
    (eq_idx, when given, for every scenario, as the JAX package applies
    it under vmap); otherwise the K2 route one scenario at a time.  The
    span `qcqp.k1.host` as in improve_coord_descent_fused."""
    S = stacked.P.shape[0]
    forms = [QCQPForm(*(a[i] for a in stacked)) for i in range(S)]
    with span("qcqp.k1.host"):
        if eq_idx is None:
            eqs = [tuple(int(j) for j in row.nonzero()[0])
                   for row in stacked.is_eq.cpu().numpy()]
        else:
            eqs = [eq_idx] * S
        if forms and _use_k1(mega, stacked.P.shape[-1],
                             stacked.P.shape[1] - 1,
                             max(len(e) for e in eqs)):
            return two_phase_sweeps(stacked.P, stacked.q, stacked.r, eqs,
                                    xs, num_iters=num_iters,
                                    viol_tol=viol_tol, tol=tol,
                                    n_bisect=N_BISECT,
                                    phase1=phase1).to(xs.dtype)
    out = xs.clone()
    for i, form in enumerate(forms):
        out[i] = improve_coord_descent_fused(
            form, xs[i], num_iters, viol_tol, tol, phase1, eq_idx,
            mega=False)
    return out
