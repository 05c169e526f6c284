"""The slice end to end: qcqp_tpu_torch's QCQP handler and restart pipeline
against qcqp_tpu's, on the CPU, from the same numpy starting points, plus
the boolean least-squares golden (brute-force optimum 35.551) through
QCQP.solve, and the methods outside the slice."""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import qcqp_tpu as jqt
from qcqp_tpu.parallel.restarts import best_point as jax_best_point
from qcqp_tpu.solvers.coord_descent import improve_coord_descent_batch

import qcqp_tpu_torch as tqt
from qcqp_tpu_torch.convert import load_jax_state
from qcqp_tpu_torch.parallel import restarts as trestarts

torch.set_num_threads(1)
BRUTE = 35.551


def boolean_ls(qt, n=10, m=15):
    rs = np.random.RandomState(1)        # examples/boolean_least_squares.py
    A = rs.randn(m, n)
    b = rs.randn(m, 1).ravel()
    x = qt.Variable(n)
    prob = qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)),
                      [qt.square(x) == 1])
    return prob, x, A, b


def _brute(A, b):
    n = A.shape[1]
    signs = np.array([[1.0 if k >> i & 1 else -1.0 for i in range(n)]
                      for k in range(1 << n)])
    return float(np.min(np.sum((signs @ A.T - b) ** 2, axis=1)))


def test_brute_force_optimum():
    _, _, A, b = boolean_ls(tqt)
    assert abs(_brute(A, b) - BRUTE) < 1e-3


@pytest.mark.parametrize("phase1", [True, False])
def test_handler_improve_matches_jax(phase1):
    jprob, jx, _, _ = boolean_ls(jqt)
    tprob, tx, _, _ = boolean_ls(tqt)
    jh, th = jqt.QCQP(jprob), tqt.QCQP(tprob, device="cpu")
    x0 = np.random.default_rng(3).standard_normal(10)
    if not phase1:
        x0 = np.sign(x0) * (1.0 + 1e-3 * x0)
    jx.value, tx.value = x0.copy(), x0.copy()
    fj, vj = jh.improve(jqt.COORD_DESCENT, phase1=phase1)
    ft, vt = th.improve(tqt.COORD_DESCENT, phase1=phase1)
    np.testing.assert_allclose(ft, fj, rtol=1e-9)
    np.testing.assert_allclose(vt, vj, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(tx.value, jx.value, rtol=1e-9, atol=1e-9)


def test_handler_maximize_sign_and_list_improve():
    def prob(qt):
        x = qt.Variable(3)
        W = np.array([[2.0, 0.5, 0.0], [0.5, 1.0, 0.3], [0.0, 0.3, 1.5]])
        return qt.Problem(qt.Maximize(qt.quad_form(x, W)),
                          [qt.square(x) <= 1]), x
    (jp, jx), (tp, tx) = prob(jqt), prob(tqt)
    jh, th = jqt.QCQP(jp), tqt.QCQP(tp, device="cpu")
    x0 = np.array([0.3, -0.2, 0.5])
    jx.value, tx.value = x0.copy(), x0.copy()
    steps = [jqt.COORD_DESCENT, jqt.COORD_DESCENT]
    fj, vj = jh.improve(steps)
    ft, vt = th.improve([tqt.COORD_DESCENT, tqt.COORD_DESCENT])
    np.testing.assert_allclose(ft, fj, rtol=1e-9)
    assert ft > 0                                   # un-negated on report
    np.testing.assert_allclose(vt, vj, atol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_restart_chain_matches_jax_from_same_starts(dtype):
    """improve_chain + best_point on the same numpy starts: the JAX batched
    CD (float64) against the port's unfused route (float64) and its K1
    route (float32, the plain version on the CPU)."""
    jprob, _, _, _ = boolean_ls(jqt)
    tprob, _, _, _ = boolean_ls(tqt)
    jform = jqt.QCQP(jprob).qcqp_form
    tform = tqt.QCQP(tprob, dtype=dtype, device="cpu").qcqp_form
    xs = np.random.default_rng(5).standard_normal((64, 10))
    xj = improve_coord_descent_batch(jform, jnp.asarray(xs), num_iters=20)
    _, fj, vj = jax_best_point(jform, xj)
    fused = dtype == torch.float32
    xt = trestarts.improve_chain(tform, torch.from_numpy(xs).to(dtype),
                                 tqt.COORD_DESCENT, num_iters=20,
                                 use_fused=fused)
    _, ft, vt = trestarts.best_point(tform, xt)
    if fused:
        assert abs(float(ft) - float(fj)) < 2e-2 and float(vt) < 1e-2
    else:
        np.testing.assert_allclose(float(ft), float(fj), rtol=1e-9)
        np.testing.assert_allclose(float(vt), float(vj), atol=1e-9)


@pytest.mark.parametrize("use_fused", [False, True])
def test_boolean_ls_golden_through_solve(use_fused):
    prob, x, A, b = boolean_ls(tqt)
    dtype = torch.float32 if use_fused else torch.float64
    h = tqt.QCQP(prob, seed=0, dtype=dtype, device="cpu")
    f, v = h.solve(num_restarts=64, num_iters=6, use_fused=use_fused)
    assert v < 1e-2
    assert BRUTE - 0.1 <= f <= BRUTE + 2e-2
    # the best point is written back to the variables
    assert abs(float(np.sum((A @ x.value - b) ** 2)) - f) < 1e-3


def test_solve_restarts_generator_reproducible():
    prob, _, _, _ = boolean_ls(tqt)
    form = tqt.QCQP(prob, device="cpu").qcqp_form
    runs = [tqt.solve_restarts(form, 16, torch.Generator().manual_seed(7),
                               num_iters=3) for _ in range(2)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    xs = trestarts.suggest_batch(form, 16, torch.Generator().manual_seed(7))
    assert xs.shape == (16, 10) and xs.dtype == torch.float64


def test_methods_outside_the_slice_raise():
    """Every method of the JAX handler runs now: SPECTRAL and IPOPT match
    the JAX package from the same point (the spectral bound and point, and
    the IPOPT improve of the same start, 1e-6 relative), and run through
    QCQP.solve.  A mesh (the distributed module) runs too: a mesh of this
    process alone gives the solve without one; one larger than the
    process world and unknown names raise."""
    jprob, jx, _, _ = boolean_ls(jqt)
    prob, x, _, _ = boolean_ls(tqt)
    jh, h = jqt.QCQP(jprob), tqt.QCQP(prob, device="cpu")
    fj, vj = jh.suggest(jqt.SPECTRAL)
    ft, vt = h.suggest(tqt.SPECTRAL)
    np.testing.assert_allclose(h.spectral_bound, jh.spectral_bound,
                               rtol=1e-6)
    np.testing.assert_allclose([ft, vt], [fj, vj], rtol=1e-6)
    x0 = np.random.default_rng(8).standard_normal(10)
    jx.value, x.value = x0.copy(), x0.copy()
    fj, vj = jh.improve(jqt.IPOPT)
    ft, vt = h.improve(tqt.IPOPT)
    np.testing.assert_allclose(ft, fj, rtol=1e-6)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-9)
    assert vt < 1e-4
    for kw in (dict(improve=tqt.IPOPT), dict(suggest=tqt.SPECTRAL)):
        f, v = h.solve(num_restarts=4, **kw)
        assert np.isfinite(f) and np.isfinite(v)
    from qcqp_tpu_torch.parallel import Mesh, make_mesh
    runs = [tqt.solve_restarts(h.qcqp_form, 4, torch.Generator()
                               .manual_seed(2), num_iters=3, **kw)
            for kw in ({}, {"mesh": make_mesh()})]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    with pytest.raises(ValueError, match="need 2 processes"):
        tqt.solve_restarts(h.qcqp_form, 4, mesh=Mesh([("r", 2)]))
    with pytest.raises(ValueError):
        h.suggest("nope")
    with pytest.raises(ValueError):
        h.improve("nope")
    with pytest.raises(ValueError):
        tqt.solve_restarts(h.qcqp_form, 4, improve="nope")
    with pytest.raises(ValueError):
        tqt.solve_restarts(h.qcqp_form, 4, suggest="nope")


def test_improve_auto_suggests():
    prob, x, _, _ = boolean_ls(tqt)
    h = tqt.QCQP(prob, device="cpu")
    assert x.value is None
    f, v = h.improve(tqt.COORD_DESCENT)
    assert x.value is not None and v < 1e-2


def test_save_and_load_state(tmp_path):
    prob, x, _, _ = boolean_ls(tqt)
    h = tqt.QCQP(prob, seed=3, device="cpu")
    h.suggest()
    path = str(tmp_path / "state")
    h.save_state(path)
    saved = x.value.copy()
    nxt = h.suggest()
    x.value = None
    h.load_state(path)
    np.testing.assert_array_equal(x.value, saved)
    assert h.suggest() == nxt          # the generator resumes where it was


def test_load_jax_state(tmp_path, caplog):
    jprob, jx, _, _ = boolean_ls(jqt)
    jh = jqt.QCQP(jprob)
    jh.suggest()
    path = str(tmp_path / "jax_state")
    jh.save_state(path)
    tprob, tx, _, _ = boolean_ls(tqt)
    th = tqt.QCQP(tprob, device="cpu")
    with caplog.at_level(logging.INFO, logger="qcqp_tpu_torch"):
        load_jax_state(path, th)
    np.testing.assert_array_equal(tx.value, jx.value)
    assert "key" in caplog.text
