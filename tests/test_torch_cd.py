"""The unfused coordinate descent of qcqp_tpu_torch (kernels/onevar.py,
solvers/coord_descent.py) against qcqp_tpu, in float64 on the CPU, from the
same numpy inputs.

The one-variable solvers agree pointwise at 1e-12.  The CD trajectories
agree per restart wherever no probe lands at an ulp-level tangency; there the
two packages' different summation orders (a batched torch matmul against
XLA's) may pick a different witness and the restart's trajectory forks, so
the batch tests require most restarts to agree exactly and the rest to match
in aggregate quality (feasible fraction, best feasible objective).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import qcqp_tpu  # noqa: F401  (turns on x64)
from qcqp_tpu import core as jcore
from qcqp_tpu.kernels import onevar as jov
from qcqp_tpu.solvers import coord_descent as jcd

from qcqp_tpu_torch import core as tcore
from qcqp_tpu_torch.kernels import onevar as tov
from qcqp_tpu_torch.solvers import coord_descent as tcd

torch.set_num_threads(1)


def _rows(seed, B, m):
    """A batch of B one-variable problems with m constraints, including
    |p| <= tol and |q| <= tol rows and inactive rows."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((B, m))
    q = rng.standard_normal((B, m))
    r = rng.standard_normal((B, m))
    p[rng.random((B, m)) < 0.15] = 0.5e-4         # linear branch
    q[rng.random((B, m)) < 0.05] = 0.0
    eq = rng.random((B, m)) < 0.4
    act = rng.random((B, m)) < 0.9
    p0, q0, r0 = rng.standard_normal((3, B))
    p0[rng.random(B) < 0.2] = 0.0
    s = np.abs(rng.standard_normal(B))
    xc = rng.standard_normal(B)
    return p, q, r, eq, act, p0, q0, r0, s, xc


def _jcon(p, q, r, eq, act):
    return jov.OneVarConstraints(*map(jnp.asarray, (p, q, r, eq, act)))


def _tcon(p, q, r, eq, act):
    return tov.OneVarConstraints(*map(torch.from_numpy, (p, q, r, eq, act)))


def _same(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("proximal", [True, False])
def test_onevar_qcqp_impl_pointwise(seed, proximal):
    p, q, r, eq, act, p0, q0, r0, s, xc = _rows(seed, 64, 6)
    fn = lambda a, b, c, con, ss, x: jov.onevar_qcqp_impl(  # noqa: E731
        a, b, c, con, ss, x_cur=x if proximal else None)
    xj, fj = jax.vmap(fn)(*map(jnp.asarray, (p0, q0, r0)),
                          _jcon(p, q, r, eq, act), jnp.asarray(s),
                          jnp.asarray(xc))
    xt, ft = tov.onevar_qcqp_impl(
        *map(torch.from_numpy, (p0, q0, r0)), _tcon(p, q, r, eq, act),
        torch.from_numpy(s), x_cur=torch.from_numpy(xc) if proximal else None)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    feas = ft.numpy()
    _same(xt.numpy()[feas], np.asarray(xj)[feas])


@pytest.mark.parametrize("seed", range(3))
def test_phase1_feasible_point_pointwise(seed):
    p, q, r, eq, act, _, _, _, s, xc = _rows(10 + seed, 64, 6)
    xj, ej = jax.vmap(jov.phase1_feasible_point)(
        _jcon(p, q, r, eq, act), jnp.asarray(s), jnp.asarray(xc))
    xt, et = tov.phase1_feasible_point(
        _tcon(p, q, r, eq, act), torch.from_numpy(s), torch.from_numpy(xc))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    ex = et.numpy()
    _same(xt.numpy()[ex], np.asarray(xj)[ex])


def test_qeval_ext_and_feasible_ineq_branches():
    x = torch.tensor([np.inf, np.inf, -np.inf, np.inf], dtype=torch.float64)
    got = tov.qeval_ext(torch.tensor([1.0, -1.0, 0.0, 0.0]).double(),
                        torch.tensor([-5.0, 5.0, 2.0, 0.0]).double(),
                        torch.tensor([2.0, 2.0, 1.0, 7.0]).double(), x)
    np.testing.assert_array_equal(got.numpy(), [np.inf, -np.inf, -np.inf, 7.0])
    pts = torch.tensor([0.0, 1.0, 1.01, 3.0], dtype=torch.float64)
    one = torch.ones_like(pts)
    assert tov.feasible_ineq(pts, one, 0 * one, -one).tolist() == \
        [True, True, False, False]
    # tiny p and q: always feasible (the reference's quirk)
    assert bool(tov.feasible_ineq(torch.tensor(3.0).double(),
                                  torch.tensor(1e-6).double(),
                                  torch.tensor(1e-6).double(),
                                  torch.tensor(5.0).double()))


def _boolean_ls(n=10, m=15, seed=1):
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n)
    b = rng.randn(m)
    P = np.zeros((n + 1, n, n))
    P[0] = A.T @ A
    q = np.zeros((n + 1, n))
    q[0] = -2.0 * A.T @ b
    r = np.zeros(n + 1)
    r[0] = b @ b
    for i in range(n):
        P[1 + i, i, i] = 1.0
    r[1:] = -1.0
    return P, q, r, np.ones(n, bool)


def _both(P, q, r, is_eq):
    return (jcore.make_form(P, q, r, is_eq),
            tcore.make_form(P, q, r, is_eq, device="cpu"))


def _quality(form, xs):
    v = np.array([float(jcore.max_violation(form, jnp.asarray(x)))
                  for x in xs])
    f = np.array([float(jcore.eval_objective(form, jnp.asarray(x)))
                  for x in xs])
    return v, f


@pytest.mark.parametrize("phase1", [True, False])
def test_single_restart_improve_matches(phase1):
    jform, tform = _both(*_boolean_ls())
    x0 = np.random.default_rng(0).standard_normal(10)
    if not phase1:
        x0 = np.sign(x0) * (1.0 + 1e-3 * x0)
    xj = np.asarray(jcd.improve_coord_descent(jform, jnp.asarray(x0),
                                              phase1=phase1))
    xt = tcd.improve_coord_descent(tform, torch.from_numpy(x0),
                                   phase1=phase1).numpy()
    np.testing.assert_allclose(xt, xj, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("n,m,eq_frac,seed",
                         [(8, 5, 0.5, 0), (6, 4, 0.0, 1), (7, 3, 1.0, 2)])
def test_batch_improve_matches_per_restart(n, m, eq_frac, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    P[0] += 2.0 * np.eye(n)                       # bounded phase 2
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
    r = rng.standard_normal(m + 1)
    is_eq = rng.random(m) < eq_frac
    jform, tform = _both(P, q, r, is_eq)
    xs = rng.standard_normal((32, n))
    xj = np.asarray(jcd.improve_coord_descent_batch(jform, jnp.asarray(xs),
                                                    num_iters=20))
    xt = tcd.improve_coord_descent_batch(tform, torch.from_numpy(xs),
                                         num_iters=20).numpy()
    same = np.all(np.abs(xt - xj) <= 1e-8 * (1 + np.abs(xj)), axis=1)
    assert same.mean() >= 0.85, same.mean()
    vj, fj = _quality(jform, xj)
    vt, ft = _quality(jform, xt)
    assert (vt < 1e-2).mean() >= (vj < 1e-2).mean() - 0.1
    if (vj < 1e-2).any():
        assert (vt < 1e-2).any()
        assert ft[vt < 1e-2].min() <= fj[vj < 1e-2].min() + 1e-6 * (
            1 + abs(fj[vj < 1e-2].min()))


def test_batch_restarts_are_independent():
    """A restart's result does not depend on the batch it runs in."""
    _, tform = _both(*_boolean_ls(8, 12, 3))
    xs = torch.from_numpy(np.random.default_rng(1).standard_normal((12, 8)))
    batched = tcd.improve_coord_descent_batch(tform, xs, num_iters=30)
    for i in (0, 5, 11):
        single = tcd.improve_coord_descent(tform, xs[i], num_iters=30)
        np.testing.assert_array_equal(single.numpy(), batched[i].numpy())


def test_boolean_ls_reaches_feasible_signs():
    jform, tform = _both(*_boolean_ls())
    x0 = torch.from_numpy(np.random.default_rng(0).standard_normal(10))
    x = tcd.improve_coord_descent(tform, x0)
    assert float(tcore.max_violation(tform, x)) < 1e-2
    np.testing.assert_allclose(x.abs().numpy(), 1.0, atol=2e-2)
