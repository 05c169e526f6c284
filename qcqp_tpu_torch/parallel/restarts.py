"""Restart parallelism: suggest -> improve chain -> best point, on one device
or sharded over a mesh of processes (JAX counterpart:
qcqp_tpu/parallel/restarts.py).

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

With a mesh (parallel/mesh.Mesh, one process per device) the restarts
shard over the mesh's first axis, as the JAX package's shard_map maps the
chain per device.  Every rank draws the whole padded batch from its
generator (the same seed on every rank) and keeps its contiguous block,
so the starts are those of the one-process run; the kernels run per rank
at their own defaults; then each rank takes its best point and one
all_gather of (n + 3) numbers a rank picks the winner, the lowest global
restart index on a tie, as the one-process best_point does.  An SDR or
SPECTRAL relaxation is solved (or read from `handler`) on the mesh's
first rank only and broadcast, so that every rank samples from the same
bits.

Each step emits a named span into a running torch.profiler trace
(diagnostics.span; nothing where no profiler records): the whole call
`qcqp.solve_restarts`, the fused set-ups `qcqp.setup`, the relaxation and
the draw `qcqp.suggest`, each improve stage `qcqp.improve.<method>`, the
best point `qcqp.best` and the cross-rank pick `qcqp.gather`.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from .. import settings as s
from ..core import (QCQPForm, eval_objective_batch, max_violation_batch,
                    violation_bucket)
from ..diagnostics import span
from ..solvers.coord_descent import improve_coord_descent_batch
from ..solvers.coord_descent_fused import improve_coord_descent_fused
from ..solvers import ccp as ccp_solver
from ..solvers.admm import improve_admm_batch
from ..solvers.nlp import improve_nlp
from ..solvers.sdp import solve_sdr, solve_spectral
from ..kernels import admm_kernel, ccp_kernel
from .mesh import Mesh, block


def make_mesh(ranks: Optional[Sequence[int]] = None,
              axis: str = "r") -> Mesh:
    """1-D mesh over the processes of the world (default: all of them),
    named `axis`: the restart axis.  Without a process group it is this
    process alone."""
    if ranks is None:
        ranks = range(dist.get_world_size() if dist.is_initialized() else 1)
    ranks = list(ranks)
    return Mesh([(axis, len(ranks))], ranks)


def _fused_default(form: QCQPForm) -> bool:
    """Whether solve_restarts routes CD, ADMM and DCCP through the kernels
    when the caller did not choose: a CUDA form in float32."""
    return form.P.is_cuda and form.P.dtype == torch.float32


def best_point(form: QCQPForm, xs: torch.Tensor, tol: float = 1e-4):
    """Lexicographic (viol bucket, objective) argmin over the restarts.
    Returns (x_best (n,), f_best, viol_best) as tensors."""
    with span("qcqp.best"):
        return _argmin(form, xs, tol)


def _argmin(form: QCQPForm, xs: torch.Tensor, tol: float):
    viols = max_violation_batch(form, xs)
    buckets = violation_bucket(viols, tol)
    fs = eval_objective_batch(form, xs)
    bmin = buckets.min()
    fs_masked = torch.where(buckets == bmin, fs, float("inf"))
    i = torch.argmin(fs_masked)          # first minimal index (tie-break)
    return xs[i], fs[i], viols[i]


def candidate(form: QCQPForm, xs: torch.Tensor, tol: float = 1e-4):
    """best_point of xs (R, n), R >= 1, as one row (bucket, f, v, x) of
    n + 3 numbers: what a rank sends for the cross-rank best point."""
    with span("qcqp.best"):
        x, f, v = _argmin(form, xs, tol)
        return torch.cat([torch.stack([violation_bucket(v, tol), f, v]), x])


def pick_across(cand: torch.Tensor, mesh: Mesh, axis: str, total: int):
    """best_point of a batch of `total` restarts split into contiguous
    blocks along `axis` (mesh.block), from each rank's candidate of its
    block (cand (n + 3,), or (S, n + 3) for S batches at once; anything
    where the block is empty): one all_gather over `axis`, then the least
    bucket, the least f and the first block, which is best_point's argmin
    over the whole batch, since its winner is its own block's winner.
    Returns (x, f, v), the same on every rank of the axis."""
    with span("qcqp.gather"):
        # blocks total, total + 1, ... are the empty ones
        cands = mesh.all_gather(cand, axis)[:total]
        b, f = cands[..., 0], cands[..., 1]
        bmin = b.min(dim=0, keepdim=True).values
        j = torch.argmin(torch.where(b == bmin, f, float("inf")), dim=0)
        win = torch.take_along_dim(cands, j[None, ..., None], dim=0)[0]
        return win[..., 3:], win[..., 1], win[..., 2]


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
        with span(f"qcqp.improve.{method}"):
            xs = _improve_stage(form, xs, method, kwargs)
    return xs


def _improve_stage(form: QCQPForm, xs: torch.Tensor, method: str,
                   kwargs: dict) -> torch.Tensor:
    """One stage of improve_chain."""
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
        with span("qcqp.setup"):
            kwargs["admm_data"] = admm_kernel.ADMMFusedData(
                form, kwargs.get("rho", None))
    if (kwargs.get("use_fused", False) and s.DCCP in methods
            and "ccp_data" not in kwargs
            and not kwargs.get("use_eigen_split", False)
            and ccp_kernel.takes(form)):
        with span("qcqp.setup"):
            kwargs["ccp_data"] = ccp_kernel.CCPFusedData(form)
    return kwargs


def _relaxation(form: QCQPForm, suggest: str, handler):
    """(sdr_sampler, spectral_sol) for the suggest: the relaxation cached
    on `handler` when it has one, else solved here."""
    if suggest == s.SDR:
        if handler is not None and getattr(handler, "mu", None) is not None:
            return (handler.mu, handler._sigma_chol), None
        return sdr_sampler(solve_sdr(form)[0]), None
    if suggest == s.SPECTRAL:
        spectral_sol = getattr(handler, "spectral_sol", None)
        if spectral_sol is None:
            spectral_sol = solve_spectral(form)[0]
        return None, spectral_sol
    return None, None


def _from_first_rank(mesh: Mesh, parts, shapes, device):
    """`parts` (tensors of one float dtype) of the mesh's first rank, on
    every rank; the other ranks pass None and the shapes.  Sent as float64
    with a flag for float32, so both dtypes arrive bit for bit."""
    size = sum(math.prod(sh) for sh in shapes)
    buf = torch.zeros(1 + size, dtype=torch.float64, device=device)
    if parts is not None:
        buf[0] = float(parts[0].dtype == torch.float32)
        buf[1:] = torch.cat([t.reshape(-1).to(buf) for t in parts])
    buf = mesh.broadcast(buf)
    dtype = torch.float32 if bool(buf[0] == 1) else torch.float64
    out, i = [], 1
    for sh in shapes:
        out.append(buf[i:i + math.prod(sh)].reshape(sh).to(dtype))
        i += math.prod(sh)
    return out


def solve_restarts(form: QCQPForm, num_restarts: int,
                   generator: Optional[torch.Generator] = None,
                   suggest: str = s.RANDOM,
                   improve: Union[str, List[str]] = s.COORD_DESCENT,
                   mesh: Optional[Mesh] = None, handler=None,
                   better_tol: float = 1e-4, **kwargs):
    """Full pipeline: suggest -> improve chain -> best-of reduction.

    generator: a torch.Generator on the form's device (default: seed 0).
    SDR and SPECTRAL take the relaxation cached on `handler` (a QCQP) when
    it has one, else solve it here (solve_sdr, solve_spectral).
    On a CUDA float32 form CD, ADMM and DCCP run through the kernels unless
    the caller passes use_fused; the one-time setups of the fused ADMM and
    CCP (kernels/admm_kernel.ADMMFusedData, kernels/ccp_kernel.CCPFusedData)
    are built here once.

    mesh: shard the restarts over the mesh's first axis (module
    docstring).  Every rank of the mesh calls this with the same arguments
    and its own copy of the form on its device; the restart count pads to
    a multiple of the mesh's size, as in the JAX package.  Returns
    (x_best, f_best, viol_best) as tensors, on every rank of a mesh.
    """
    with span("qcqp.solve_restarts"):
        if generator is None:
            generator = torch.Generator(device=form.device).manual_seed(0)
        if "use_fused" not in kwargs and _fused_default(form):
            kwargs["use_fused"] = True
        kwargs = fused_setups(form, improve, kwargs)
        with span("qcqp.suggest"):
            xs = _starts(form, num_restarts, generator, suggest, mesh,
                         handler)
        if mesh is None:
            return best_point(form, improve_chain(form, xs, improve,
                                                  **kwargs), better_tol)
        return _solve_sharded(form, xs, improve, mesh, better_tol, **kwargs)


def _starts(form: QCQPForm, num_restarts: int, generator, suggest: str,
            mesh: Optional[Mesh], handler) -> torch.Tensor:
    """solve_restarts's starts: the relaxation where the suggest takes
    one, then the draw; with a mesh the whole padded batch, from the
    relaxation of the mesh's first rank."""
    if mesh is None:
        sampler, spectral_sol = _relaxation(form, suggest, handler)
        return suggest_batch(form, num_restarts, generator, suggest,
                             sdr_sampler=sampler, spectral_sol=spectral_sol)
    sampler = spectral_sol = None
    if suggest in (s.SDR, s.SPECTRAL):
        # the mesh's first rank solves (or reads) the relaxation; every
        # rank samples from its bits
        n, parts = form.n, None
        if mesh.grid.flat[0] == mesh.rank:
            sampler, spectral_sol = _relaxation(form, suggest, handler)
            parts = list(sampler) if suggest == s.SDR else [spectral_sol]
        shapes = [(n,), (n, n)] if suggest == s.SDR else [(n,)]
        parts = _from_first_rank(mesh, parts, shapes, form.device)
        if suggest == s.SDR:
            sampler = tuple(parts)
        else:
            spectral_sol, = parts
    num_padded = -(-num_restarts // mesh.size) * mesh.size
    return suggest_batch(form, num_padded, generator, suggest,
                         sdr_sampler=sampler, spectral_sol=spectral_sol)


def _solve_sharded(form: QCQPForm, xs: torch.Tensor,
                  improve: Union[str, List[str]], mesh: Mesh,
                  better_tol: float = 1e-4, **kwargs):
    """solve_restarts(mesh=...) after the draw: from the whole batch xs
    (R, n), this rank's block over the mesh's first axis through the
    improve chain, then the best point across the axis."""
    axis = mesh.axis_names[0]
    R = xs.shape[0]
    lo, hi = block(R, mesh.shape[axis], mesh.index(axis))
    if hi > lo:
        cand = candidate(form, improve_chain(form, xs[lo:hi], improve,
                                             **kwargs), better_tol)
    else:
        cand = xs.new_zeros(form.n + 3)
    return pick_across(cand, mesh, axis, R)
