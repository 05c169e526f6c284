"""Scenario parallelism on one device: S independent instances of one shape
(n, m), stacked along a leading scenario axis, R restarts each, solved
together (JAX counterpart: qcqp_tpu/parallel/scenarios.py, without the
mesh).

This is the production serving path: instances stream from the threaded
binary problem bank (native.bank_load) onto the card, and every scenario
runs suggest -> improve chain -> best point.  Where the JAX package vmaps
one compiled program over the scenarios, so that the Pallas CD kernel runs
one call over the whole (S, R) grid, the port launches K1 once for all
S x R restarts (solvers/coord_descent_fused.improve_coord_descent_fused_stack);
the other improves (ADMM through K3, DCCP through K4, IPOPT, and CD on
shapes K1 does not take) run one scenario at a time, each with its own
one-time set-up.

Deviations from the JAX package, on purpose:

  * The JAX solve_scenarios passes use_fused through unset, so on the TPU
    it runs the XLA path unless asked.  On the card the plain batched CD is
    only the kernels' plain version, so a CUDA float32 stack defaults to
    the kernels, as solve_restarts does (the caller can pass use_fused).
  * Under vmap the JAX package sees is_eq as a tracer and runs the generic
    K2 route unless the caller passes eq_idx
    (qcqp_tpu/solvers/coord_descent_fused.py:159-166).  The port's forms
    are concrete, so every scenario runs K1 with its own static equality
    pattern; a caller's eq_idx= applies to every scenario, as in JAX.
  * Randomness is one explicit torch.Generator on the stack's device
    (default: seed 0).  It draws the S x R starts in scenario order:
    scenario s gets the (R, n) draw that follows those of scenarios
    0, ..., s-1, which is what solve_restarts draws for that form from a
    generator in the same state.  torch cannot replay jax.random.split
    (qcqp_tpu/parallel/scenarios.py:70), so tests feed both packages the
    same starts through `_solve_from_starts`.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from .. import native
from .. import settings as s
from ..convert import form_from_numpy
from ..core import QCQPForm, default_device
from ..solvers.coord_descent_fused import improve_coord_descent_fused_stack
from .restarts import (_fused_default, best_point, fused_setups,
                       improve_chain, suggest_batch)


def stack_forms(forms: List[QCQPForm]) -> QCQPForm:
    """Stack same-shape instances along a leading scenario axis."""
    return QCQPForm(
        torch.stack([f.P for f in forms]),
        torch.stack([f.q for f in forms]),
        torch.stack([f.r for f in forms]),
        torch.stack([f.is_eq for f in forms]),
    )


def scenario(stacked: QCQPForm, i: int) -> QCQPForm:
    """Instance i of a stack, as a form (views, no copy)."""
    return QCQPForm(stacked.P[i], stacked.q[i], stacked.r[i],
                    stacked.is_eq[i])


def forms_from_bank(path: str, start: int = 0, batch: Optional[int] = None,
                    dtype=None, device=None) -> QCQPForm:
    """Load a stacked scenario batch, instances [start, start + batch), from
    a native problem bank (either package's; native.bank_load reads it on
    the host).  device: core.default_device() (the card; without one the
    caller must name the CPU); dtype: float64 on the CPU and float32 on
    CUDA unless given."""
    device = default_device(device)
    count, _, _ = native.bank_info(path)
    if batch is None:
        batch = count - start
    return form_from_numpy(*native.bank_load(path, start, batch),
                           device=device, dtype=dtype)


def solve_scenarios(stacked: QCQPForm, num_restarts: int,
                    generator: Optional[torch.Generator] = None,
                    suggest: str = s.RANDOM,
                    improve: Union[str, List[str]] = s.COORD_DESCENT,
                    mesh=None, better_tol: float = 1e-4, **kwargs):
    """Solve S stacked instances with R = num_restarts restarts each.

    generator: a torch.Generator on the stack's device (default: seed 0);
    it draws the starts in scenario order (module docstring).  suggest:
    RANDOM; SDR and SPECTRAL raise ValueError, as in the JAX package,
    whose suggest_batch gets no relaxation here
    (qcqp_tpu/parallel/restarts.py:83-93).  improve and kwargs as in
    solve_restarts; on a CUDA float32 stack the kernels run unless the
    caller passes use_fused.  Returns (xs (S, n), fs (S,), viols (S,)).
    """
    if mesh is not None:
        raise NotImplementedError(
            "solve_scenarios(mesh=...) is not ported to qcqp_tpu_torch yet: "
            "it comes with the distributed module")
    if generator is None:
        generator = torch.Generator(device=stacked.device).manual_seed(0)
    S, n = stacked.P.shape[0], stacked.n
    xs = torch.empty((S, num_restarts, n), dtype=stacked.dtype,
                     device=stacked.device)
    for i in range(S):
        xs[i] = suggest_batch(scenario(stacked, i), num_restarts, generator,
                              suggest)
    return _solve_from_starts(stacked, xs, improve, better_tol, **kwargs)


def _solve_from_starts(stacked: QCQPForm, xs: torch.Tensor,
                       improve: Union[str, List[str]] = s.COORD_DESCENT,
                       better_tol: float = 1e-4, **kwargs):
    """solve_scenarios after the draw: the improve chain and the best point
    of every scenario from the starts xs (S, R, n)."""
    if "use_fused" not in kwargs and _fused_default(stacked):
        kwargs["use_fused"] = True
    forms = [scenario(stacked, i) for i in range(stacked.P.shape[0])]
    per_form = [fused_setups(f, improve, kwargs) for f in forms]
    for method in improve if isinstance(improve, list) else [improve]:
        if method == s.COORD_DESCENT and kwargs.get("use_fused", False):
            xs = improve_coord_descent_fused_stack(
                stacked, xs, num_iters=kwargs.get("num_iters", 1000),
                viol_tol=kwargs.get("viol_tol", 1e-2),
                tol=kwargs.get("tol", 1e-4),
                phase1=kwargs.get("phase1", True),
                eq_idx=kwargs.get("eq_idx", None),
                mega=kwargs.get("mega", None))
            continue
        out = xs.clone()
        for i, (form, kw) in enumerate(zip(forms, per_form)):
            out[i] = improve_chain(form, xs[i], method, **kw)
        xs = out
    best = [best_point(f, xs[i], better_tol) for i, f in enumerate(forms)]
    return tuple(torch.stack(col) for col in zip(*best))


def solve_scenarios_sharded(stacked: QCQPForm, num_restarts: int,
                            generator=None, mesh=None, **kwargs):
    """The scenario axis sharded over a 2-D mesh
    (qcqp_tpu/parallel/scenarios.py:76): not ported yet."""
    raise NotImplementedError(
        "solve_scenarios_sharded is not ported to qcqp_tpu_torch yet: it "
        "comes with the distributed module")
