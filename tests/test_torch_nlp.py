"""qcqp_tpu_torch's augmented-Lagrangian improve (the IPOPT slot) against
qcqp_tpu's, on the CPU in float64, from the same numpy starts: the tests
of tests/test_nlp.py (the convex oracle instances, held against
jax.vmap(improve_nlp) and against scipy SLSQP; the early exit; the
nonconvex instance; explicit tolerances), a batch whose lanes stop at
different trips, and the kwarg filter of improve_chain([DCCP, IPOPT]).

The nonconvex instance is chaotic at round-off: its trajectories, the
JAX package's own among them, amplify a difference in the last bit until
lanes part by order 1 (at the default schedule the JAX package gives the
same (f, v) for few-ulp perturbations of the starts on 2 of the 32
lanes).  The port is therefore held lane for lane on the lanes that the
JAX package itself determines: those on which JAX gives the same (f, v)
to 1e-9 for starts perturbed by a few ulps.  The other lanes are listed
in ROADMAP.md Queue 3."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from qcqp_tpu.core import make_form as jax_make_form
from qcqp_tpu.solvers.nlp import improve_nlp as jax_improve_nlp

import qcqp_tpu_torch as tqt
from qcqp_tpu_torch.core import (better_key, eval_objective_batch,
                                 max_violation_batch)
from qcqp_tpu_torch.convert import form_from_numpy
from qcqp_tpu_torch.parallel import restarts as trestarts
from qcqp_tpu_torch.solvers import ccp as ccp_solver
from qcqp_tpu_torch.solvers.nlp import improve_nlp

from .test_nlp import _convex_instance, _slsqp_solve

torch.set_num_threads(1)


def _port_form(jform):
    return form_from_numpy(np.asarray(jform.P), np.asarray(jform.q),
                           np.asarray(jform.r), np.asarray(jform.is_eq),
                           device="cpu", dtype=torch.float64)


def _jax_batch(jform, X, **kw):
    return np.asarray(jax.jit(jax.vmap(
        lambda x: jax_improve_nlp(jform, x, **kw)))(jnp.asarray(X)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nlp_matches_jax_on_convex_instances(seed):
    """The convex oracle instances (n = 8): the port's x within 1e-7 of
    jax.vmap(improve_nlp)'s, from the same start."""
    jform = _convex_instance(seed)
    x0 = np.random.default_rng(100 + seed).standard_normal((1, jform.n))
    xj = _jax_batch(jform, x0)
    xt = improve_nlp(_port_form(jform), torch.from_numpy(x0)).numpy()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nlp_matches_slsqp_oracle(seed):
    """tests/test_nlp.py:70-86 on the port: feasible to 1e-6 and the SQP
    oracle's objective to 1e-4."""
    jform = _convex_instance(seed)
    form = _port_form(jform)
    x0 = np.random.default_rng(100 + seed).standard_normal(jform.n)
    res = _slsqp_solve(jform, x0)
    assert res.success
    x = improve_nlp(form, torch.from_numpy(x0)[None])
    f = float(eval_objective_batch(form, x)[0])
    v = float(max_violation_batch(form, x)[0])
    assert v < 1e-6
    assert abs(f - res.fun) <= 1e-4 * (1.0 + abs(res.fun))


def _rel(a, b):
    return np.abs(a - b) / (1.0 + np.abs(b))


def _jax_spread(jform, X0, xj, fv=None, **kw):
    """Per lane, how far the JAX package's own result moves when the
    starts are perturbed by a few ulps (3 draws): in x, or in (f, v)
    relative when fv is given."""
    spread = np.zeros(len(X0))
    for s in range(3):
        Xp = X0 * (1.0 + 4e-16 * np.random.default_rng(50 + s)
                   .standard_normal(X0.shape))
        xp = _jax_batch(jform, Xp, **kw)
        if fv is None:
            d = np.abs(xp - xj).max(axis=1)
        else:
            (fp, vp), (fj, vj) = fv(xp), fv(xj)
            d = np.maximum(_rel(fp, fj), _rel(vp, vj))
        spread = np.maximum(spread, d)
    return spread


def test_nlp_batch_lanes_stop_independently():
    """16 starts of one convex oracle instance in one batch: the lanes
    stop on their own exits, and every lane the JAX package determines
    (x moves by less than 1e-9 when its starts move by a few ulps; where
    the schedule ends before the iterates settle it moves by up to 1e-5
    here) equals jax.vmap's lane to 1e-7."""
    jform = _convex_instance(1)
    X0 = np.random.default_rng(40).standard_normal((16, jform.n))
    xj = _jax_batch(jform, X0)
    determined = _jax_spread(jform, X0, xj) < 1e-9
    assert determined.sum() >= 8
    xt = improve_nlp(_port_form(jform), torch.from_numpy(X0)).numpy()
    np.testing.assert_allclose(xt[determined], xj[determined], rtol=0,
                               atol=1e-7)


def test_nlp_early_exit_iterations():
    """tests/test_nlp.py:88-99: caps of 100 x 600 give the default caps'
    point (atol 1e-9), and the Newton loop really exits early: it runs
    the same trips under both caps, far below the 60,000 of the large
    one."""
    jform = _convex_instance(7)
    form = _port_form(jform)
    x0 = torch.from_numpy(
        np.random.default_rng(7).standard_normal(form.n))[None]
    improve_nlp.newton_trips = 0
    x_a = improve_nlp(form, x0)
    trips_a = improve_nlp.newton_trips
    improve_nlp.newton_trips = 0
    x_b = improve_nlp(form, x0, num_outer=100, num_inner=600)
    trips_b = improve_nlp.newton_trips
    np.testing.assert_allclose(x_a.numpy(), x_b.numpy(), rtol=0, atol=1e-9)
    assert trips_b == trips_a < 60


def _nonconvex_instance():
    """tests/test_nlp.py:102-118's instance (n = 10, m = 6, seed 3)."""
    rng = np.random.default_rng(3)
    n, m = 10, 6
    A = rng.standard_normal((m + 1, n, n))
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    q = rng.standard_normal((m + 1, n))
    r = rng.standard_normal(m + 1)
    return P, q, r, np.zeros(m, bool)


@pytest.mark.parametrize("schedule", [{}, {"bb_outer_n": 0}],
                         ids=["default", "newton_only"])
def test_nlp_nonconvex_batch_matches_jax(schedule):
    """The nonconvex instance over 32 starts, at the default schedule and
    with the Newton tail alone: every lane is finite and no worse than its
    start under `better` (tests/test_nlp.py:117-118's guarantee, per
    lane), and every lane that the JAX package determines (the same
    (f, v) to 1e-9 for starts perturbed by a few ulps) has the JAX lane's
    (f, v) to 1e-6 relative."""
    arrays = _nonconvex_instance()
    jform = jax_make_form(*arrays)
    form = form_from_numpy(*(np.asarray(a) for a in jform), device="cpu",
                           dtype=torch.float64)
    X0 = np.random.default_rng(11).standard_normal((32, form.n))
    xt = improve_nlp(form, torch.from_numpy(X0), **schedule)
    assert torch.isfinite(xt).all()
    x0t = torch.from_numpy(X0)
    for i in range(32):
        vb0, f0 = better_key(form, x0t[i])
        vb, f = better_key(form, xt[i])
        assert vb < vb0 or (vb == vb0 and f <= f0)

    def fv(x):
        x = torch.from_numpy(np.array(x))
        return (eval_objective_batch(form, x).numpy(),
                max_violation_batch(form, x).numpy())
    xj = _jax_batch(jform, X0, **schedule)
    fj, vj = fv(xj)
    determined = _jax_spread(jform, X0, xj, fv, **schedule) < 1e-9
    assert determined.sum() >= 2
    ft, vt = fv(xt)
    parted = np.maximum(_rel(ft, fj), _rel(vt, vj))
    assert (parted[determined] < 1e-6).all(), (
        np.nonzero(determined)[0], parted[determined])


def test_nlp_explicit_tolerance_kwargs():
    """tests/test_nlp.py:121-128: explicit grad_tol / feas_tol run and give
    a finite point."""
    form = _port_form(_convex_instance(5, n=6, m_in=3))
    x0 = torch.from_numpy(np.random.default_rng(5).standard_normal(6))[None]
    x = improve_nlp(form, x0, grad_tol=1e-6, feas_tol=1e-6)
    assert torch.isfinite(x).all()


def test_improve_chain_forwards_stage_kwargs(monkeypatch):
    """tests/test_parallel.py:195-225 on the port: improve_chain([DCCP,
    IPOPT]) forwards the filtered kwargs to each stage."""
    form = _port_form(_convex_instance(0, n=4, m_in=2))
    xs = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 4)))
    seen = {}

    def fake_ccp(form, x, **kw):
        seen.setdefault("ccp", kw)
        return x

    def fake_nlp(form, x, **kw):
        seen.setdefault("nlp", kw)
        return x

    monkeypatch.setattr(ccp_solver, "improve_ccp_batch", fake_ccp)
    monkeypatch.setattr(trestarts, "improve_nlp", fake_nlp)
    trestarts.improve_chain(form, xs, [tqt.DCCP, tqt.IPOPT],
                            max_iter=7, tau=0.1, inner_iters=11,
                            num_outer=3, mu0=2.0, rho=99.0)
    assert seen["ccp"]["max_iter"] == 7
    assert seen["ccp"]["tau"] == 0.1
    assert seen["ccp"]["inner_iters"] == 11
    assert "rho" not in seen["ccp"]          # foreign kwargs filtered out
    assert seen["nlp"] == {"num_outer": 3, "mu0": 2.0}
