"""Scenario parallelism: S independent instances of one shape (n, m),
stacked along a leading scenario axis, R restarts each, solved together,
on one device or over a mesh of processes (JAX counterpart:
qcqp_tpu/parallel/scenarios.py).

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
    same starts through `_solve_from_starts`.  Over a mesh every rank
    draws all S x R starts in that order and keeps its block, so a
    sharded solve starts from the starts of the one-process solve.

Over a mesh (parallel/mesh.Mesh, one process per device): in
solve_scenarios(mesh=...) the restarts shard over `axis` and every rank
returns every scenario's best point; in solve_scenarios_sharded the
scenarios shard over `s_axis` too, each rank solves its S / s_size
scenarios (one stacked K1 launch where CD runs through K1), the best
point is reduced over `r_axis` only (one all_gather of S / s_size
candidates of n + 3 numbers), and one all_gather over `s_axis` hands
every rank all S results, as the JAX package's global array reads in
one process.  A rank may load only its own scenarios from a bank
(`scenario_block`, then forms_from_bank(path, start, batch)).

Both solves emit `qcqp.solve_scenarios` into a running torch.profiler
trace, around the spans of parallel/restarts.py: `qcqp.suggest` around
the draw, `qcqp.setup` for each scenario's fused set-ups,
`qcqp.improve.<method>` for each stage (the stacked K1 launch's one span,
or each scenario's), `qcqp.best` and `qcqp.gather`.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from .. import native
from .. import settings as s
from ..convert import form_from_numpy
from ..core import QCQPForm, default_device
from ..diagnostics import span
from ..solvers.coord_descent_fused import improve_coord_descent_fused_stack
from .mesh import Mesh, block
from .restarts import (_fused_default, best_point, candidate, fused_setups,
                       improve_chain, pick_across, suggest_batch)


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
    the host).  device: core.default_device() (the current CUDA device;
    without a card the caller must name the CPU); dtype: float64 on the
    CPU and float32 on CUDA unless given."""
    device = default_device(device)
    count, _, _ = native.bank_info(path)
    if batch is None:
        batch = count - start
    return form_from_numpy(*native.bank_load(path, start, batch),
                           device=device, dtype=dtype)


def _draw(form: QCQPForm, S: int, R: int, generator, suggest, keep=None,
          rows=slice(None)):
    """The S x R starts in scenario order (scenario s gets the (R, n)
    draw after those of the scenarios before it), of which the scenarios
    in `keep` (default: all) and the restarts in `rows` are returned.
    `form` gives the shape, dtype and device (the scenarios share them)."""
    out = []
    for i in range(S):
        xs = suggest_batch(form, R, generator, suggest)
        if keep is None or i in keep:
            out.append(xs[rows])
    return torch.stack(out)


def solve_scenarios(stacked: QCQPForm, num_restarts: int,
                    generator: Optional[torch.Generator] = None,
                    suggest: str = s.RANDOM,
                    improve: Union[str, List[str]] = s.COORD_DESCENT,
                    mesh: Optional[Mesh] = None, axis: str = "r",
                    better_tol: float = 1e-4, **kwargs):
    """Solve S stacked instances with R = num_restarts restarts each.

    generator: a torch.Generator on the stack's device (default: seed 0);
    it draws the starts in scenario order (module docstring).  suggest:
    RANDOM; SDR and SPECTRAL raise ValueError, as in the JAX package,
    whose suggest_batch gets no relaxation here
    (qcqp_tpu/parallel/restarts.py:83-93).  improve and kwargs as in
    solve_restarts; on a CUDA float32 stack the kernels run unless the
    caller passes use_fused.  mesh: the restarts shard over `axis` in
    contiguous blocks (no padding, as in the JAX package), every rank
    holds the whole stack.  Returns (xs (S, n), fs (S,), viols (S,)), on
    every rank of a mesh.
    """
    with span("qcqp.solve_scenarios"):
        if generator is None:
            generator = torch.Generator(
                device=stacked.device).manual_seed(0)
        S = stacked.P.shape[0]
        rows = slice(None)
        if mesh is not None:
            rows = slice(*block(num_restarts, mesh.shape[axis],
                                mesh.index(axis)))
        with span("qcqp.suggest"):
            xs = _draw(scenario(stacked, 0), S, num_restarts, generator,
                       suggest, rows=rows)
        if mesh is None:
            return _solve_from_starts(stacked, xs, improve, better_tol,
                                      **kwargs)
        return _best_across(stacked, xs, improve, mesh, axis, num_restarts,
                            better_tol, **kwargs)


def _improve_from_starts(stacked: QCQPForm, xs: torch.Tensor,
                         improve: Union[str, List[str]] = s.COORD_DESCENT,
                         **kwargs):
    """The improve chain of every scenario from the starts xs (S, R, n):
    CD as one stacked K1 launch where it runs through K1, every other
    stage one scenario at a time with its own set-up."""
    if "use_fused" not in kwargs and _fused_default(stacked):
        kwargs["use_fused"] = True
    forms = [scenario(stacked, i) for i in range(stacked.P.shape[0])]
    per_form = [fused_setups(f, improve, kwargs) for f in forms]
    for method in improve if isinstance(improve, list) else [improve]:
        if method == s.COORD_DESCENT and kwargs.get("use_fused", False):
            with span(f"qcqp.improve.{method}"):
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
    return xs


def _solve_from_starts(stacked: QCQPForm, xs: torch.Tensor,
                       improve: Union[str, List[str]] = s.COORD_DESCENT,
                       better_tol: float = 1e-4, **kwargs):
    """solve_scenarios after the draw: the improve chain and the best point
    of every scenario from the starts xs (S, R, n)."""
    xs = _improve_from_starts(stacked, xs, improve, **kwargs)
    best = [best_point(scenario(stacked, i), xs[i], better_tol)
            for i in range(stacked.P.shape[0])]
    return tuple(torch.stack(col) for col in zip(*best))


def _best_across(stacked: QCQPForm, xs: torch.Tensor, improve, mesh: Mesh,
                 axis: str, total: int, better_tol: float, **kwargs):
    """This rank's block xs (S, Rl, n) of each scenario's `total` restarts
    through the improve chain, then each scenario's best point across
    `axis` (one all_gather of S candidates)."""
    S, n = stacked.P.shape[0], stacked.n
    if xs.shape[1]:
        xs = _improve_from_starts(stacked, xs.contiguous(), improve,
                                  **kwargs)
        cand = torch.stack([candidate(scenario(stacked, i), xs[i],
                                      better_tol) for i in range(S)])
    else:
        cand = xs.new_zeros((S, n + 3))
    return pick_across(cand, mesh, axis, total)


def scenario_block(num_scenarios: int, mesh: Mesh, s_axis: str = "s"):
    """(start, batch): the scenarios this rank solves in
    solve_scenarios_sharded, for forms_from_bank(path, start, batch)."""
    s_size = mesh.shape[s_axis]
    if num_scenarios % s_size:
        raise ValueError(f"S={num_scenarios} not a multiple of the "
                         f"{s_axis} axis ({s_size})")
    lo, hi = block(num_scenarios, s_size, mesh.index(s_axis))
    return lo, hi - lo


def solve_scenarios_sharded(stacked: QCQPForm, num_restarts: int,
                            generator: Optional[torch.Generator],
                            mesh: Mesh, s_axis: str = "s", r_axis: str = "r",
                            suggest: str = s.RANDOM,
                            improve: Union[str, List[str]] = s.COORD_DESCENT,
                            better_tol: float = 1e-4,
                            num_scenarios: Optional[int] = None, **kwargs):
    """Solve S stacked instances with the scenario axis sharded too
    (module docstring): scenarios over `s_axis`, restarts over `r_axis`.

    stacked: all S instances, or (with num_scenarios=S) only this rank's
    block of them (`scenario_block`).  S must be a multiple of the s-axis
    size (ValueError otherwise); num_restarts pads to a multiple of the
    r-axis size.  generator: as in solve_scenarios, the same seed on every
    rank.  Returns (xs (S, n), fs (S,), viols (S,)) on every rank.
    """
    with span("qcqp.solve_scenarios"):
        S = stacked.P.shape[0] if num_scenarios is None else num_scenarios
        start, batch = scenario_block(S, mesh, s_axis)
        if num_scenarios is None:
            stacked = QCQPForm(*(a[start:start + batch] for a in stacked))
        elif stacked.P.shape[0] != batch:
            raise ValueError(f"this rank's block holds {batch} of the {S} "
                             f"scenarios, the stack {stacked.P.shape[0]}")
        r_size = mesh.shape[r_axis]
        R = -(-num_restarts // r_size) * r_size
        if generator is None:
            generator = torch.Generator(
                device=stacked.device).manual_seed(0)
        lo, hi = block(R, r_size, mesh.index(r_axis))
        with span("qcqp.suggest"):
            xs = _draw(scenario(stacked, 0), S, R, generator, suggest,
                       keep=range(start, start + batch), rows=slice(lo, hi))
        return _sharded_from_starts(stacked, xs, mesh, s_axis, r_axis, R,
                                    improve, better_tol, **kwargs)


def _sharded_from_starts(local: QCQPForm, xs: torch.Tensor, mesh: Mesh,
                         s_axis: str, r_axis: str, total: int,
                         improve=s.COORD_DESCENT, better_tol: float = 1e-4,
                         **kwargs):
    """solve_scenarios_sharded after the draw: this rank's scenarios
    `local` and its block xs (S / s_size, R / r_size, n) of their starts;
    the best points reduced over `r_axis`, then gathered over `s_axis`."""
    x, f, v = _best_across(local, xs, improve, mesh, r_axis, total,
                           better_tol, **kwargs)
    with span("qcqp.gather"):
        res = mesh.all_gather(torch.cat([x, f[:, None], v[:, None]], 1),
                              s_axis)
    res = res.reshape(-1, local.n + 2)
    return res[:, :-2], res[:, -2], res[:, -1]
