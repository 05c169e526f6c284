"""The SDR suggest end to end on the CPU, in float64, through
qcqp_tpu_torch's modeling layer and handler, against qcqp_tpu's: the SDR
goldens of BASELINE.md (boolean least squares 28.750, maxcut 57.207,
circle packing 5.000; beamforming 1.970, realified by hand as in
tests/test_api_examples.py), the handler's
cached relaxation (bound, mu, Sigma = L L^T), its samples, SDR starts
through solve_restarts and QCQP.solve, and the relaxation carried across
by load_jax_state.  Sigma is compared as L L^T: eigenvector signs are each
LAPACK call's own choice, and the port canonicalises nothing the JAX
package does not.  SPECTRAL runs too (tests/test_torch_spectral.py holds
it against the JAX package)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import qcqp_tpu as jqt

import qcqp_tpu_torch as tqt
from qcqp_tpu_torch import settings
from qcqp_tpu_torch.convert import load_jax_state
from qcqp_tpu_torch.parallel import restarts as trestarts
from qcqp_tpu_torch.solvers import sdp as ts

torch.set_num_threads(1)
BRUTE_BLS = 35.550                      # examples/boolean_least_squares.py


def boolean_ls(qt, n=10, m=15):
    rs = np.random.RandomState(1)
    A, b = rs.randn(m, n), rs.randn(m, 1).ravel()
    x = qt.Variable(n)
    return qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)),
                      [qt.square(x) == 1])


def maxcut(qt, n=25, p=0.2):
    np.random.seed(1)
    W = np.random.uniform(0, 1, (n, n))
    for i in range(n):
        W[i, i] = 1
        for j in range(i + 1, n):
            W[j, i] = W[i, j]
    W = (W < p).astype(float)
    x = qt.Variable(n)
    return qt.Problem(qt.Maximize(0.25 * (np.sum(W) - qt.quad_form(x, W))),
                      [qt.square(x) == 1])


def circle(qt, nC=5, B=10.0):
    X, r = qt.Variable(2, nC), qt.Variable()
    cons = [X >= r, X <= B - r, r >= 0]
    for i in range(nC):
        for j in range(i + 1, nC):
            cons.append(qt.square(2 * r) <= qt.sum_squares(X[:, i] - X[:, j]))
    return qt.Problem(qt.Maximize(r), cons)


@pytest.mark.parametrize("make,golden", [
    (boolean_ls, 28.750), (maxcut, 57.207), (circle, 5.000)])
def test_sdr_goldens_match_jax(make, golden):
    """The SDR bound through each package's handler (maximize problems
    report the un-negated bound), within 1e-3 of the golden and 1e-6
    relative of each other."""
    th, jh = tqt.QCQP(make(tqt), device="cpu"), jqt.QCQP(make(jqt))
    assert th.qcqp_form.dtype == torch.float64
    th.suggest(tqt.SDR)
    jh.suggest(jqt.SDR)
    assert abs(th.sdr_bound - golden) < 1e-3
    assert abs(th.sdr_bound - jh.sdr_bound) <= 1e-6 * abs(golden)


def test_sdr_cache_matches_jax():
    """Boolean least squares has one SDR solution: the same X, mu and
    Sigma = L L^T as the JAX handler's."""
    th, jh = tqt.QCQP(boolean_ls(tqt), device="cpu"), jqt.QCQP(
        boolean_ls(jqt))
    th.suggest(tqt.SDR)
    jh.suggest(jqt.SDR)
    np.testing.assert_allclose(th.sdr_sol.numpy(), np.asarray(jh.sdr_sol),
                               atol=1e-8)
    np.testing.assert_allclose(th.mu.numpy(), np.asarray(jh.mu), atol=1e-8)
    Lt, Lj = th._sigma_chol.numpy(), np.asarray(jh._sigma_chol)
    np.testing.assert_allclose(Lt @ Lt.T, Lj @ Lj.T, atol=1e-8)
    X = th.sdr_sol.numpy()
    assert abs(X[-1, -1] - 1.0) < 1e-6
    np.testing.assert_allclose(np.diag(X)[:-1], 1.0, atol=1e-5)


def test_sdr_samples_equal_for_the_same_draws(tmp_path):
    """With the JAX handler's relaxation carried across (load_jax_state),
    the port's SDR suggest is mu + L xi for its generator's next normal
    draws xi, the JAX package's formula on the same xi; the relaxation is
    not solved again."""
    jh = jqt.QCQP(boolean_ls(jqt))
    jh.suggest(jqt.SDR)
    path = str(tmp_path / "jax_state")
    jh.save_state(path)
    prob = boolean_ls(tqt)
    th = tqt.QCQP(prob, device="cpu", seed=4)
    load_jax_state(path, th)
    assert th.sdr_bound == jh.sdr_bound
    xi = torch.randn(10, generator=torch.Generator().manual_seed(4),
                     dtype=torch.float64).numpy()
    th.suggest(tqt.SDR)
    want = np.asarray(jh.mu) + np.asarray(jh._sigma_chol) @ xi
    np.testing.assert_allclose(prob.variables()[0].value.ravel(), want,
                               atol=1e-12)


def test_solve_restarts_from_sdr_starts_reaches_the_optimum(monkeypatch):
    """examples/boolean_least_squares.py's chain: SDR suggest, then
    coordinate descent, best of 256 restarts, reaches the brute-force
    optimum; QCQP.solve takes the handler's relaxation instead of solving
    it again (handler=self)."""
    form = tqt.QCQP(boolean_ls(tqt), device="cpu").qcqp_form
    x, f, v = tqt.solve_restarts(form, 256, torch.Generator().manual_seed(0),
                                 suggest=tqt.SDR, improve=tqt.COORD_DESCENT,
                                 num_iters=50)
    assert float(v) < 1e-2 and abs(float(f) - BRUTE_BLS) < 2e-2

    h = tqt.QCQP(boolean_ls(tqt), device="cpu")
    h.suggest(tqt.SDR)
    calls = []
    orig = trestarts.solve_sdr
    monkeypatch.setattr(trestarts, "solve_sdr",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    f, v = h.solve(256, suggest=tqt.SDR, improve=tqt.COORD_DESCENT,
                   num_iters=50)
    assert not calls
    assert v < 1e-2 and abs(f - BRUTE_BLS) < 2e-2


def test_suggest_batch_sdr():
    form = tqt.QCQP(boolean_ls(tqt), device="cpu").qcqp_form
    X, _ = ts.solve_sdr(form)
    mu, L = trestarts.sdr_sampler(X)
    xs = trestarts.suggest_batch(form, 6, torch.Generator().manual_seed(2),
                                 tqt.SDR, sdr_sampler=(mu, L))
    xi = torch.randn((6, 10), generator=torch.Generator().manual_seed(2),
                     dtype=torch.float64)
    assert torch.allclose(xs, mu + xi @ L.T, atol=1e-14)
    with pytest.raises(ValueError):
        trestarts.suggest_batch(form, 3, None, tqt.SDR)


def test_save_and_load_state_carry_the_relaxation(tmp_path):
    h = tqt.QCQP(boolean_ls(tqt), device="cpu", seed=1)
    h.suggest(tqt.SDR)
    path = str(tmp_path / "state")
    h.save_state(path)
    nxt = h.suggest(tqt.SDR)
    h2 = tqt.QCQP(boolean_ls(tqt), device="cpu")
    h2.load_state(path)
    for name in ("sdr_sol", "mu", "_sigma_chol"):
        assert torch.equal(getattr(h2, name), getattr(h, name))
    assert h2.sdr_bound == h.sdr_bound
    assert h2.suggest(tqt.SDR) == nxt      # the generator resumed too


def test_sdr_is_ported_and_spectral_still_raises():
    """SPECTRAL is ported now (the name is kept): the settings hold no list
    of unported methods, and the handler's spectral suggest and
    solve_restarts from its point match the JAX package's (1e-6)."""
    assert not hasattr(settings, "NOT_PORTED")
    h = tqt.QCQP(boolean_ls(tqt), device="cpu")
    jh = jqt.QCQP(boolean_ls(jqt))
    assert h.suggest(tqt.SPECTRAL) == pytest.approx(
        jh.suggest(jqt.SPECTRAL), rel=1e-6)
    assert h.spectral_bound == pytest.approx(jh.spectral_bound, rel=1e-6)
    assert h.spectral_bound <= BRUTE_BLS
    x, f, v = tqt.solve_restarts(h.qcqp_form, 4, suggest=tqt.SPECTRAL,
                                 handler=h, num_iters=20)
    assert torch.isfinite(x).all() and float(v) < 1e-2


def test_port_imports_no_jax():
    code = ("import sys; import qcqp_tpu_torch, qcqp_tpu_torch.solvers.sdp, "
            "qcqp_tpu_torch.kernels.eigh_kernel, qcqp_tpu_torch.convert, "
            "qcqp_tpu_torch.parallel.restarts, "
            "qcqp_tpu_torch.parallel.scenarios, qcqp_tpu_torch.native, "
            "qcqp_tpu_torch.diagnostics, qcqp_tpu_torch.benchmarks.scaling, "
            "qcqp_tpu_torch.examples.boolean_least_squares, "
            "qcqp_tpu_torch.examples.maxcut, "
            "qcqp_tpu_torch.examples.circle_packing, "
            "qcqp_tpu_torch.examples.secondary_user_beamforming, "
            "qcqp_tpu_torch.examples.scenario_serving; "
            "assert 'jax' not in sys.modules; "
            "assert not any(m == 'qcqp_tpu' or m.startswith('qcqp_tpu.') "
            "for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True)


def beamforming(qt):
    """tests/test_api_examples.py:158-171: the secondary-user beamforming
    model, complex channels realified by hand into x in R^(2n)
    (examples/secondary_user_beamforming.py:37)."""
    n, m, l = 20, 5, 2
    tau, eta = 20.0, 2.0
    np.random.seed(1)
    HR, HI = np.random.randn(m, n), np.random.randn(m, n)
    A, B = np.hstack((HR, HI)), np.hstack((-HI, HR))
    GR, GI = np.random.randn(l, n), np.random.randn(l, n)
    C, D = np.hstack((GR, GI)), np.hstack((-GI, GR))
    x = qt.Variable(2 * n)
    prob = qt.Problem(qt.Minimize(qt.sum_squares(x)),
                      [qt.square(A @ x) + qt.square(B @ x) >= tau,
                       qt.square(C @ x) + qt.square(D @ x) <= eta])
    return prob, x


def test_beamforming_golden_matches_jax():
    """The beamforming SDR golden 1.970 (within 2e-2, and 1e-6 relative of
    the JAX handler's bound), then DCCP from the same point in both
    packages reaches violation < 1e-4 with the same (f, v) to 1e-6."""
    (tp, tx), (jp, jx) = beamforming(tqt), beamforming(jqt)
    th, jh = tqt.QCQP(tp, device="cpu"), jqt.QCQP(jp)
    th.suggest(tqt.SDR)
    jh.suggest(jqt.SDR)
    assert abs(th.sdr_bound - 1.970) < 2e-2
    assert abs(th.sdr_bound - jh.sdr_bound) <= 1e-6 * jh.sdr_bound
    tx.value = jx.value.copy()         # the JAX handler's SDR sample
    ft, vt = th.improve(tqt.DCCP)
    fj, vj = jh.improve(jqt.DCCP)
    assert vt < 1e-4 and ft <= 2.5
    np.testing.assert_allclose([ft, vt], [fj, vj], rtol=1e-6, atol=1e-10)
