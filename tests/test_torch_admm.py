"""qcqp_tpu_torch/solvers/admm.py (the unfused ADMM route) against
qcqp_tpu/solvers/admm.py, float64 on the CPU, from the same numpy starts.

Both run the same float64 algorithm; they differ in the order of float64
sums (matmuls, the Cholesky solve).  On convex inequality-only instances the
trajectories cannot diverge in a few iterations, so they are compared
pointwise at 1e-8 (roundoff grows by about 1e-15 per operation; a flipped
bisection step would show as ~1e-6).  On boolean least squares (nonconvex)
roundoff can send a restart on another path, so the comparison there is
statistical, as tests/test_admm_pallas.py:30-55 compares its two paths.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import qcqp_tpu as jqt
from qcqp_tpu import core as jcore
from qcqp_tpu.core import QCQPForm as JForm
from qcqp_tpu.solvers import admm as ja

import qcqp_tpu_torch as tqt
from qcqp_tpu_torch import core as tcore
from qcqp_tpu_torch.convert import form_from_numpy
from qcqp_tpu_torch.expressions import canonicalize as tcanon
from qcqp_tpu_torch.kernels.projection import precompute_eigh
from qcqp_tpu_torch.solvers import admm as ta
from .test_cd import boolean_ls_form

torch.set_num_threads(1)


def _both(jform):
    """The JAX form and the port's form on the same float64 arrays."""
    arrays = [np.asarray(a) for a in jform]
    return jform, form_from_numpy(*arrays, device="cpu")


def _convex_ineq_arrays(n, m, seed):
    """tests/test_admm_pallas.py:58-72 in float64."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((m, n, n)) / np.sqrt(n)
    Pc = np.einsum("mij,mkj->mik", B, B) + 0.1 * np.eye(n)
    A0 = rng.standard_normal((n, n)) / np.sqrt(n)
    P0 = A0 @ A0.T + 0.1 * np.eye(n)
    P = np.concatenate([P0[None], Pc])
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
    r = np.concatenate([rng.standard_normal(1),
                        -np.abs(rng.standard_normal(m)) - 0.5])
    return P, q, r, np.zeros(m, bool)


@pytest.mark.parametrize("seed", [2, 5])
def test_auto_rho_and_min_valid_rho_match_jax(seed):
    jf, tf = _both(boolean_ls_form(n=6, m=9, seed=seed)[0])
    np.testing.assert_allclose(float(ta.auto_rho(tf)), float(ja.auto_rho(jf)),
                               rtol=1e-12)
    np.testing.assert_allclose(float(ta.min_valid_rho(tf)),
                               float(ja.min_valid_rho(jf)),
                               rtol=1e-12, atol=1e-14)
    # a nonconvex objective: auto-rho takes the other branch
    rng = np.random.default_rng(seed)
    arrays = list(np.asarray(a) for a in jf)
    A = rng.standard_normal(arrays[0].shape[1:])
    arrays[0] = arrays[0].copy()
    arrays[0][0] = 0.5 * (A + A.T)
    jf2 = JForm(*(jnp.asarray(a) for a in arrays))
    tf2 = form_from_numpy(*arrays, device="cpu")
    np.testing.assert_allclose(float(ta.auto_rho(tf2)),
                               float(ja.auto_rho(jf2)), rtol=1e-12)
    assert float(ta.min_valid_rho(tf2)) > 0


@pytest.mark.parametrize("n,m,iters,phase1", [
    (8, 6, 1, True), (8, 6, 3, True), (12, 4, 5, False)])
def test_improve_admm_batch_lockstep(n, m, iters, phase1):
    arrays = _convex_ineq_arrays(n, m, seed=n + m)
    jf = JForm(*(jnp.asarray(a) for a in arrays))
    tf = form_from_numpy(*arrays, device="cpu")
    xs = np.random.default_rng(1).standard_normal((4, n))
    xj = np.asarray(ja.improve_admm_batch(jf, jnp.asarray(xs),
                                          num_iters=iters, phase1=phase1))
    xt = ta.improve_admm_batch(tf, torch.from_numpy(xs), num_iters=iters,
                               phase1=phase1).numpy()
    np.testing.assert_allclose(xt, xj, atol=1e-8, rtol=0)
    # the single-restart entry is the batch of one
    one = ta.improve_admm(tf, torch.from_numpy(xs[2]), num_iters=iters,
                          phase1=phase1).numpy()
    np.testing.assert_allclose(one, xt[2], atol=1e-12, rtol=0)


@pytest.mark.parametrize("seed", [4, 8])
def test_improve_admm_batch_boolean_ls_statistics(seed):
    """Nonconvex: equal violation distributions and best-restart quality
    (tests/test_admm_pallas.py:44-47), and never worse than the start."""
    jf, tf = _both(boolean_ls_form(n=8, m=12, seed=seed)[0])
    xs = np.sign(np.random.default_rng(seed).standard_normal((12, 8)))
    xs = xs + 0.3 * np.random.default_rng(seed + 1).standard_normal(xs.shape)
    xj = ja.improve_admm_batch(jf, jnp.asarray(xs), num_iters=60)
    xt = ta.improve_admm_batch(tf, torch.from_numpy(xs), num_iters=60)
    vj = np.asarray([float(jcore.max_violation(jf, x)) for x in xj])
    vt = tcore.max_violation_batch(tf, xt).numpy()
    np.testing.assert_allclose(np.sort(vt), np.sort(vj), atol=3e-2)
    assert np.floor(vt.min() / 1e-2) <= np.floor(vj.min() / 1e-2)
    fj = np.asarray([float(jcore.eval_objective(jf, x)) for x in xj])
    ft = tcore.eval_objective_batch(tf, xt).numpy()
    feas = (vj < 1e-2) & (vt < 1e-2)
    if feas.any():
        assert ft[feas].min() <= fj[feas].min() + 1e-2 * (1 + abs(fj).max())
    x0 = torch.from_numpy(xs)
    torch.testing.assert_close(tcore.better_batch(tf, xt, x0), xt,
                               rtol=0, atol=0)


def test_admm_phase1_reaches_feasibility():
    """tests/test_admm.py:51-67: two overlapping balls from far away."""
    n = 4
    a = np.full(n, 0.5)
    x = tqt.Variable(n)
    prob = tqt.Problem(tqt.Minimize(tqt.sum_squares(x)),
                       [tqt.sum_squares(x) <= 1,
                        tqt.sum_squares(x - a) <= 1])
    form, _, _ = tcanon(prob, np.float64, "cpu")
    x0 = torch.full((2, n), 3.0, dtype=torch.float64)
    x0[1] = -3.0
    z = ta.admm_phase1(form, precompute_eigh(form), x0, 1e-2, 500)
    assert float(tcore.max_violation_batch(form, z).max()) < 1e-2


def test_admm_convex_projection_problem():
    """tests/test_admm.py:23-36: min ||x - c||^2 s.t. ||x||^2 <= 1."""
    n = 5
    c = np.zeros(n)
    c[0] = 2.0
    x = tqt.Variable(n)
    prob = tqt.Problem(tqt.Minimize(tqt.sum_squares(x - c)),
                       [tqt.sum_squares(x) <= 1])
    form, _, _ = tcanon(prob, np.float64, "cpu")
    out = ta.improve_admm(form, torch.zeros(n, dtype=torch.float64))
    assert float(tcore.max_violation(form, out)) < 5e-2
    assert float(tcore.eval_objective(form, out)) <= 1.1   # optimum 1.0


@pytest.mark.parametrize("convex", [True, False])
def test_unconstrained_path_matches_jax(convex):
    """m == 0: the closed-form minimum for a convex objective, else the
    start (qcqp_tpu/solvers/admm.py:98-108)."""
    rng = np.random.default_rng(3)
    n = 5
    A = rng.standard_normal((n, n))
    P0 = A @ A.T + 0.5 * np.eye(n) if convex else 0.5 * (A + A.T)
    P, q, r = P0[None], rng.standard_normal((1, n)), rng.standard_normal(1)
    eq = np.zeros(0, bool)
    jf = JForm(jnp.asarray(P), jnp.asarray(q), jnp.asarray(r),
               jnp.asarray(eq))
    tf = form_from_numpy(P, q, r, eq, device="cpu")
    xs = rng.standard_normal((3, n))
    xj = np.asarray(ja.improve_admm_batch(jf, jnp.asarray(xs)))
    xt = ta.improve_admm_batch(tf, torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(xt, xj, atol=1e-10, rtol=0)
    if not convex:
        np.testing.assert_array_equal(xt, xs)


def test_handler_improve_unfused_matches_jax():
    """QCQP.improve(ADMM) on the CPU (float64, unfused) against the JAX
    handler from the same start: both routes of improve_admm, single
    restart, with the rho check in front."""
    def prob(qt):
        rs = np.random.RandomState(4)
        A, b = rs.randn(12, 8), rs.randn(12)
        x = qt.Variable(8)
        return qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)),
                          [qt.square(x) == 1]), x
    (jp_, jx), (tp_, tx) = prob(jqt), prob(tqt)
    jh, th = jqt.QCQP(jp_), tqt.QCQP(tp_, device="cpu")
    x0 = np.sign(np.random.default_rng(0).standard_normal(8))
    jx.value, tx.value = x0.copy(), x0.copy()
    fj, vj = jh.improve(jqt.ADMM, num_iters=40)
    ft, vt = th.improve(tqt.ADMM, num_iters=40)
    np.testing.assert_allclose(ft, fj, rtol=1e-8)
    np.testing.assert_allclose(vt, vj, atol=1e-8)
    np.testing.assert_allclose(tx.value, jx.value, atol=1e-8)
