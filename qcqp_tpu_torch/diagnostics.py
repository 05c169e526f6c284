"""Iteration-level tracing and profiling helpers
(JAX counterpart: qcqp_tpu/diagnostics.py).

The reference's only observability is INFO-level violation lines appended to
`qcqp.log` (reference: qcqp/qcqp.py:39,143,246).  The solvers' loops keep no
history, so tracing is a separate replay that steps the method one
iteration (sweep, outer step) at a time, keeps each step's values as
tensors on the form's device and stacks them after the loop: the whole
history comes back in one transfer, with no host read a step beyond what
the stepped solver itself does.  Convergence curves for dashboards,
regression tests and rho/tau tuning; plus a context manager over
torch.profiler for device traces, the named spans the restart driver and
the kernels' launch wrappers emit into those traces (`span`), and a timer
that waits for the card.

Every trace runs on the form's device and in its dtype; a start given as
numpy goes there first.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch

from .core import QCQPForm, eval_objective, max_violation
from .kernels.projection import precompute_eigh
from .solvers.admm import _project, auto_rho


def _on_form(form: QCQPForm, x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=form.dtype, device=form.device)


def cd_trace(form: QCQPForm, x0, sweeps: int = 50, viol_tol: float = 1e-2,
             tol: float = 1e-4) -> Dict[str, torch.Tensor]:
    """Per-sweep (objective, max violation) history of CD phase 1 + phase 2:
    each step is one phase-1 sweep, then one phase-2 sweep where the point
    is viol_tol-feasible (solvers/coord_descent.improve_coord_descent_batch
    at num_iters=1, which reads that gate on the host, as it always does)."""
    from .solvers.coord_descent import improve_coord_descent_batch
    x = _on_form(form, x0)[None]
    objs, viols = [], []
    for _ in range(sweeps):
        x = improve_coord_descent_batch(form, x, 1, viol_tol, tol)
        objs.append(eval_objective(form, x[0]))
        viols.append(max_violation(form, x[0]))
    return {"x": x[0], "objective": torch.stack(objs),
            "violation": torch.stack(viols)}


def admm_trace(form: QCQPForm, x0, iters: int = 200, rho=None,
               proj_tol: float = 1e-6) -> Dict[str, torch.Tensor]:
    """Per-iteration history of ADMM phase 2 (z-residual, violation, obj):
    the z-update through one Cholesky factor of 2 (P0 + rho m I), the m
    projections through solvers/admm._project."""
    x0 = _on_form(form, x0)
    eigh = precompute_eigh(form)
    if rho is None:
        rho = auto_rho(form)
    m, n = form.m, form.n
    lhs = 2.0 * (form.P[0] + rho * m * torch.eye(n, dtype=x0.dtype,
                                                 device=x0.device))
    chol = torch.linalg.cholesky(lhs)
    z = x0
    xs = x0.expand(m, n).clone()
    us = torch.zeros_like(xs)
    dzs, viols, objs = [], [], []
    for _ in range(iters):
        rhs = 2.0 * rho * (xs.sum(0) - us.sum(0)) - form.q[0]
        z_new = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
        xs = _project(form, eigh, (z_new + us)[None], proj_tol)[0]
        us = us + z_new - xs
        dzs.append(torch.linalg.vector_norm(z_new - z))
        viols.append(max_violation(form, z_new))
        objs.append(eval_objective(form, z_new))
        z = z_new
    return {"z": z, "z_residual": torch.stack(dzs),
            "violation": torch.stack(viols), "objective": torch.stack(objs)}


def ccp_trace(form: QCQPForm, x0, outers: int = 40, tau: float = 0.005,
              mu: float = 1.4, tau_max: float = 1e8,
              inner_iters: int = 40) -> Dict[str, torch.Tensor]:
    """Per-outer-iteration history of the penalty CCP improve
    (tau, objective, max violation): the replay view of
    solvers/ccp.improve_ccp (reference behavior: qcqp/qcqp.py:288-322).
    Each step is one outer step at the carried tau (max_iter=1, mu=1
    freezes the inner schedule, and improve_ccp's `better` fold applies);
    tau then advances as min(tau mu, tau_max), in Python floats, so no
    step reads the card."""
    from .solvers.ccp import improve_ccp, precompute_ccp
    x = _on_form(form, x0)
    data = precompute_ccp(form)
    taus, objs, viols = [], [], []
    tau_k = float(tau)
    for _ in range(outers):
        x = improve_ccp(form, x, tau=tau_k, mu=1.0, tau_max=tau_max,
                        max_iter=1, inner_iters=inner_iters, data=data)
        taus.append(tau_k)
        objs.append(eval_objective(form, x))
        viols.append(max_violation(form, x))
        tau_k = min(tau_k * mu, tau_max)
    return {"x": x, "tau": torch.tensor(taus, dtype=form.dtype,
                                        device=form.device),
            "objective": torch.stack(objs), "violation": torch.stack(viols)}


def sdp_trace(form: QCQPForm, iters: int = 2000, rho0: float = 1.0,
              alpha: float = 1.6) -> Dict[str, torch.Tensor]:
    """Residual curves of the SDR splitting solver (fixed-iteration replay:
    the affine prox, over-relaxation by alpha, the exact PSD projection by
    eigh, the dual updates; no rho balancing, no acceleration)."""
    from .solvers.sdp import _affine_prox, _cone_proj, _sdr_data
    data = _sdr_data(form)
    N = data.W0.shape[-1]
    k = data.b.shape[-1]
    dt, dev = data.W0.dtype, data.W0.device
    rho = torch.tensor(rho0, dtype=dt, device=dev)
    Y, t = torch.eye(N, dtype=dt, device=dev), torch.zeros(k, dtype=dt,
                                                          device=dev)
    U, v = torch.zeros((N, N), dtype=dt, device=dev), torch.zeros_like(t)
    rps, objs = [], []
    for _ in range(iters):
        X1, s1, _ = _affine_prox(data, Y - U, t - v, rho)
        Xr = alpha * X1 + (1 - alpha) * Y
        sr = alpha * s1 + (1 - alpha) * t
        Y, t = _cone_proj(Xr + U, sr + v)
        U = U + Xr - Y
        v = v + sr - t
        rps.append(torch.sqrt(((X1 - Y) ** 2).sum() + ((s1 - t) ** 2).sum()))
        objs.append((data.W0 * Y).sum() * data.obj_scale)
    return {"X": Y, "primal_residual": torch.stack(rps),
            "objective": torch.stack(objs)}


@contextlib.contextmanager
def torch_profile(logdir: str):
    """Capture a host and device trace of the enclosed code, viewable in
    Perfetto or chrome://tracing (the counterpart of the JAX package's
    `xla_profile`, which wraps jax.profiler).  Yields the
    torch.profiler.profile object; on exit waits for the card and writes
    the trace as `<logdir>/trace.json` (the path is the profile object's
    `trace_path`)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.trace_path = os.path.join(logdir, "trace.json")
    with prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
    prof.export_chrome_trace(prof.trace_path)


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named span of the program in torch.profiler's timeline: a
    `user_annotation` event beside the device's kernels and copies, so a
    trace (`torch_profile`, or any torch.profiler.profile the caller
    runs) shows which step of the program left the card idle.  Use it as
    `with span("qcqp.best"): ...`.  The names the program emits are listed
    in README.md (the port's section).

    Where no profiler records, it returns one shared no-op context manager
    and costs a flag read; it allocates nothing and calls no
    record_function op.  There is no other switch."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def timed(label: str, results: dict = None):
    """Wall-clock timer that waits for the card: a CUDA synchronize on
    entry and on exit when CUDA is initialized (the JAX package's `timed`
    promises to block on device completion but reads the clock only)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    yield
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if results is not None:
        results[label] = dt
    else:
        print(f"[qcqp_tpu_torch] {label}: {dt:.3f}s")
