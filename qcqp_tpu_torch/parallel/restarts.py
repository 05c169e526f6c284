"""Restart parallelism on one device: suggest -> improve chain -> best point
(JAX counterpart: qcqp_tpu/parallel/restarts.py, without the mesh).

The reference runs suggest/improve chains one at a time (reference:
examples/boolean_least_squares.py:19-38).  Here a whole batch of restarts
(R, n) goes through the chain together and the best point is chosen by the
reference's lexicographic `better` order (violation bucket, then
objective; qcqp/utilities.py:135-146), ties to the lowest restart index.

Suggest methods: RANDOM, SDR (samples of the Shor relaxation's Gaussian)
and SPECTRAL (the spectral relaxation's point, the same for every
restart); a relaxation is taken from `handler=` when it has one, else
solved once per solve_restarts call.

Improve methods: COORD_DESCENT, ADMM, DCCP and IPOPT.  On a CUDA float32
form the first three go through the kernels by default (K1 or K2 for CD,
K3 for ADMM, K4 for DCCP); the caller can pass use_fused to choose.
IPOPT (solvers/nlp.py) is plain batched tensor code, as in the JAX
package.

Randomness is an explicit torch.Generator on the form's device.  Its
normal draws are not jax.random's: tests hand both packages the same numpy
starts instead.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from .. import settings as s
from ..core import (QCQPForm, eval_objective_batch, max_violation_batch,
                    violation_bucket)
from ..solvers.coord_descent import improve_coord_descent_batch
from ..solvers.coord_descent_fused import improve_coord_descent_fused
from ..solvers import ccp as ccp_solver
from ..solvers.admm import improve_admm_batch
from ..solvers.nlp import improve_nlp
from ..solvers.sdp import solve_sdr, solve_spectral
from ..kernels import admm_kernel, ccp_kernel


def _fused_default(form: QCQPForm) -> bool:
    """Whether solve_restarts routes CD, ADMM and DCCP through the kernels
    when the caller did not choose: a CUDA form in float32."""
    return form.P.is_cuda and form.P.dtype == torch.float32


def best_point(form: QCQPForm, xs: torch.Tensor, tol: float = 1e-4):
    """Lexicographic (viol bucket, objective) argmin over the restarts.
    Returns (x_best (n,), f_best, viol_best) as tensors."""
    viols = max_violation_batch(form, xs)
    buckets = violation_bucket(viols, tol)
    fs = eval_objective_batch(form, xs)
    bmin = buckets.min()
    fs_masked = torch.where(buckets == bmin, fs, float("inf"))
    i = torch.argmin(fs_masked)          # first minimal index (tie-break)
    return xs[i], fs[i], viols[i]


def sdr_sampler(X: torch.Tensor, eps: float = 1e-8):
    """(mu, L) with x = mu + L xi ~ N(mu, Sigma) from the SDR's lifted
    solution X: mu = X[:-1, -1], Sigma = X[:-1, :-1] - mu mu^T + eps I,
    L = Q sqrt(max(lam, 0)) from its eigh, the spectrum clamped at 0
    (reference: qcqp/qcqp.py:383-396)."""
    n = X.shape[-1] - 1
    mu = X[:-1, -1]
    Sigma = X[:-1, :-1] - torch.outer(mu, mu)
    Sigma = Sigma + eps * torch.eye(n, dtype=X.dtype, device=X.device)
    lam, Q = torch.linalg.eigh(Sigma)
    return mu, Q * torch.sqrt(torch.clamp_min(lam, 0.0))


def suggest_batch(form: QCQPForm, num: int,
                  generator: Optional[torch.Generator] = None,
                  method: str = s.RANDOM, sdr_sampler=None,
                  spectral_sol=None) -> torch.Tensor:
    """Batched suggest: (num, n) starting points.
    RANDOM: iid standard normal (reference: qcqp/qcqp.py:381-382).
    SDR: x ~ N(mu, Sigma) through sdr_sampler=(mu, L) (qcqp.py:394-396).
    SPECTRAL: spectral_sol in every row, as a contiguous (num, n) tensor
    (the kernels take raw pointers to rows; expand's stride-0 view would
    hand them one row)."""
    if method == s.RANDOM:
        return torch.randn((num, form.n), generator=generator,
                           dtype=form.dtype, device=form.device)
    if method == s.SDR:
        if sdr_sampler is None:
            raise ValueError("SDR suggest_batch needs sdr_sampler=(mu, L)")
        mu, L = sdr_sampler
        xi = torch.randn((num, form.n), generator=generator,
                         dtype=form.dtype, device=form.device)
        return mu[None, :] + xi @ L.T
    if method == s.SPECTRAL:
        if spectral_sol is None:
            raise ValueError("SPECTRAL suggest_batch needs spectral_sol")
        return spectral_sol.to(form.dtype).expand(num, form.n).contiguous()
    raise ValueError(f"Unknown suggest method: {method}")


def improve_chain(form: QCQPForm, xs: torch.Tensor,
                  methods: Union[str, List[str]], **kwargs) -> torch.Tensor:
    """Apply improve methods in sequence to every restart; like the
    reference's improve(method_list), the same kwargs go to every stage
    (reference: qcqp/qcqp.py:430-431)."""
    if isinstance(methods, str):
        methods = [methods]
    for method in methods:
        if method == s.COORD_DESCENT:
            common = dict(num_iters=kwargs.get("num_iters", 1000),
                          viol_tol=kwargs.get("viol_tol", 1e-2),
                          tol=kwargs.get("tol", 1e-4),
                          phase1=kwargs.get("phase1", True))
            if kwargs.get("use_fused", False):
                xs = improve_coord_descent_fused(
                    form, xs, eq_idx=kwargs.get("eq_idx", None),
                    mega=kwargs.get("mega", None), **common)
            else:
                xs = improve_coord_descent_batch(form, xs, **common)
        elif method == s.ADMM:
            common = dict(num_iters=kwargs.get("num_iters", 1000),
                          viol_lim=kwargs.get("viol_lim", 1e4),
                          tol=kwargs.get("admm_tol", kwargs.get("tol", 1e-2)),
                          phase1=kwargs.get("phase1", True))
            if kwargs.get("use_fused", False):
                # K3 (kernels/admm_kernel.py); the one-time setup comes in
                # admm_data when solve_restarts built it
                xs = admm_kernel.improve_admm_fused(
                    form, xs, rho=kwargs.get("rho", None),
                    better_tol=kwargs.get("better_tol", 1e-4),
                    data=kwargs.get("admm_data", None),
                    **common).to(xs.dtype)
            else:
                xs = improve_admm_batch(form, xs, kwargs.get("rho", None),
                                        **common)
        elif method == s.DCCP:
            tau = kwargs.get("tau", 0.005)
            if (kwargs.get("use_fused", False)
                    and not kwargs.get("use_eigen_split", False)):
                # K4 (kernels/ccp_kernel.py); the one-time setup comes in
                # ccp_data when solve_restarts built it
                ccp_kw = {k: v for k, v in kwargs.items()
                          if k in ("max_iter", "mu", "tau_max",
                                   "inner_iters", "warm_inner")}
                xs = ccp_kernel.improve_ccp_fused(
                    form, xs, tau=tau, data=kwargs.get("ccp_data", None),
                    **ccp_kw).to(xs.dtype)
            else:
                # the same filtered forwarding as QCQP._improve_one
                ccp_kw = {k: v for k, v in kwargs.items()
                          if k in ("max_iter", "mu", "tau_max",
                                   "inner_iters", "use_eigen_split")}
                xs = ccp_solver.improve_ccp_batch(form, xs, tau=tau,
                                                  **ccp_kw)
        elif method == s.IPOPT:
            xs = improve_nlp(form, xs, **{
                k: v for k, v in kwargs.items()
                if k in ("num_outer", "num_inner", "mu0")})
        else:
            raise ValueError(f"Unknown improve method: {method}")
    return xs


def fused_setups(form: QCQPForm, improve: Union[str, List[str]],
                 kwargs: dict) -> dict:
    """kwargs with the one-time set-ups of the fused ADMM and CCP
    (kernels/admm_kernel.ADMMFusedData, kernels/ccp_kernel.CCPFusedData)
    added for `form`, where the chain runs them through the kernels and
    the caller passed none."""
    methods = improve if isinstance(improve, list) else [improve]
    kwargs = dict(kwargs)
    if (kwargs.get("use_fused", False) and s.ADMM in methods
            and "admm_data" not in kwargs and admm_kernel.takes(form)):
        kwargs["admm_data"] = admm_kernel.ADMMFusedData(
            form, kwargs.get("rho", None))
    if (kwargs.get("use_fused", False) and s.DCCP in methods
            and "ccp_data" not in kwargs
            and not kwargs.get("use_eigen_split", False)
            and ccp_kernel.takes(form)):
        kwargs["ccp_data"] = ccp_kernel.CCPFusedData(form)
    return kwargs


def solve_restarts(form: QCQPForm, num_restarts: int,
                   generator: Optional[torch.Generator] = None,
                   suggest: str = s.RANDOM,
                   improve: Union[str, List[str]] = s.COORD_DESCENT,
                   mesh=None, handler=None, better_tol: float = 1e-4,
                   **kwargs):
    """Full pipeline: suggest -> improve chain -> best-of reduction.

    generator: a torch.Generator on the form's device (default: seed 0).
    SDR and SPECTRAL take the relaxation cached on `handler` (a QCQP) when
    it has one, else solve it here (solve_sdr, solve_spectral).
    On a CUDA float32 form CD, ADMM and DCCP run through the kernels unless
    the caller passes use_fused; the one-time setups of the fused ADMM and
    CCP (kernels/admm_kernel.ADMMFusedData, kernels/ccp_kernel.CCPFusedData)
    are built here once.  Returns (x_best, f_best, viol_best) as tensors.
    """
    if mesh is not None:
        raise NotImplementedError(
            "solve_restarts(mesh=...) is not ported to qcqp_tpu_torch yet: "
            "it comes with the distributed module")
    if generator is None:
        generator = torch.Generator(device=form.device).manual_seed(0)
    if "use_fused" not in kwargs and _fused_default(form):
        kwargs["use_fused"] = True
    kwargs = fused_setups(form, improve, kwargs)
    sampler = spectral_sol = None
    if suggest == s.SDR:
        if handler is not None and getattr(handler, "mu", None) is not None:
            sampler = (handler.mu, handler._sigma_chol)
        else:
            sampler = sdr_sampler(solve_sdr(form)[0])
    elif suggest == s.SPECTRAL:
        spectral_sol = getattr(handler, "spectral_sol", None)
        if spectral_sol is None:
            spectral_sol = solve_spectral(form)[0]
    xs = suggest_batch(form, num_restarts, generator, suggest,
                       sdr_sampler=sampler, spectral_sol=spectral_sol)
    xs = improve_chain(form, xs, improve, **kwargs)
    return best_point(form, xs, better_tol)
