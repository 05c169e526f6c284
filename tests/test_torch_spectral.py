"""The SPECTRAL suggest in qcqp_tpu_torch against qcqp_tpu's, on the CPU in
float64: the spectral relaxation's bound and point (up to one global
sign: the top eigenvector's sign is each LAPACK call's own choice, and
neither package fixes it), its order against the SDR bound, the handler's
maximize sign, SPECTRAL starts through suggest_batch and solve_restarts
against the JAX package's chain from the same point, and the spectral
cache through save_state / load_state and load_jax_state."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import qcqp_tpu as jqt
from qcqp_tpu.parallel.restarts import best_point as jax_best_point
from qcqp_tpu.parallel.restarts import improve_chain as jax_improve_chain
from qcqp_tpu.solvers import sdp as jsdp

import qcqp_tpu_torch as tqt
from qcqp_tpu_torch.convert import form_from_numpy, load_jax_state
from qcqp_tpu_torch.parallel import restarts as trestarts
from qcqp_tpu_torch.solvers import sdp as tsdp

from .test_cd import boolean_ls_form
from .test_torch_sdr_slice import boolean_ls, maxcut

torch.set_num_threads(1)


def _port_form(jform):
    return form_from_numpy(*(np.asarray(a) for a in jform), device="cpu",
                           dtype=torch.float64)


def test_solve_spectral_matches_jax():
    """tests/test_sdp.py:61-68's instance (boolean LS, n = 6, m = 9, seed
    5): the bound within 1e-6 relative of the JAX package's, x equal up to
    one sign to 1e-6, and the bound below the SDR bound (the aggregated
    relaxation is the weaker one)."""
    jform, _, _ = boolean_ls_form(n=6, m=9, seed=5)
    form = _port_form(jform)
    xj, bj = jsdp.solve_spectral(jform, max_iters=20000, tol=1e-9)
    xt, bt = tsdp.solve_spectral(form, max_iters=20000, tol=1e-9)
    xj = np.asarray(xj)
    assert xt.shape == (6,) and torch.isfinite(xt).all()
    assert float(bt) == pytest.approx(float(bj), rel=1e-6)
    sign = 1.0 if float(xt.numpy() @ xj) >= 0 else -1.0
    np.testing.assert_allclose(sign * xt.numpy(), xj, rtol=0, atol=1e-6)
    _, sdr_bound = tsdp.solve_sdr(form, max_iters=20000, tol=1e-9)
    assert float(bt) <= float(sdr_bound) + 1e-4


def test_spectral_rel_viol_matches_jax():
    """The acceptance gate's unscaled violation of the aggregated rows, on
    the JAX package's relaxed X and on a perturbed one."""
    jform, _, _ = boolean_ls_form(n=6, m=9, seed=5)
    form = _port_form(jform)
    sol, _ = jsdp._solve_single(jsdp._spectral_data, jform, 2000, 1e-9,
                                "auto", uviol_fn=jsdp._spectral_rel_viol)
    X = np.array(sol.X)
    for Xc in (X, X + 1e-3 * np.eye(7)):
        assert tsdp._spectral_rel_viol(form, torch.from_numpy(Xc)) == \
            pytest.approx(jsdp._spectral_rel_viol(jform, jnp.asarray(Xc)),
                          rel=1e-9, abs=1e-15)


def test_handler_spectral_maximize_sign():
    """maxcut (a Maximize problem): the handler reports the un-negated
    bound, which matches the JAX handler's to 1e-6 and lies above the SDR
    bound 57.207 (a weaker upper bound), and caches the point."""
    th, jh = tqt.QCQP(maxcut(tqt), device="cpu"), jqt.QCQP(maxcut(jqt))
    th.suggest(tqt.SPECTRAL)
    jh.suggest(jqt.SPECTRAL)
    assert th.spectral_bound == pytest.approx(jh.spectral_bound, rel=1e-6)
    assert th.spectral_bound >= 57.207 - 1e-3
    sol = th.spectral_sol
    th.suggest(tqt.SPECTRAL)                 # cached: not solved again
    assert th.spectral_sol is sol


def test_spectral_starts_match_jax_chain(monkeypatch):
    """suggest_batch(SPECTRAL) gives the point in every row as a real
    (R, n) tensor (no stride-0 view for the kernels' raw pointers); CD
    from it equals the JAX package's chain from the same point; and
    solve_restarts takes the handler's cached point instead of solving
    the relaxation again."""
    th = tqt.QCQP(boolean_ls(tqt), device="cpu")
    jh = jqt.QCQP(boolean_ls(jqt))
    jh.suggest(jqt.SPECTRAL)
    x = torch.from_numpy(np.array(jh.spectral_sol))
    xs = trestarts.suggest_batch(th.qcqp_form, 8, None, tqt.SPECTRAL,
                                 spectral_sol=x)
    assert xs.shape == (8, 10) and xs.is_contiguous()
    assert xs.stride() == (10, 1) and torch.equal(xs[5], x)
    with pytest.raises(ValueError):
        trestarts.suggest_batch(th.qcqp_form, 8, None, tqt.SPECTRAL)
    xt = trestarts.improve_chain(th.qcqp_form, xs, tqt.COORD_DESCENT,
                                 num_iters=20)
    _, ft, vt = trestarts.best_point(th.qcqp_form, xt)
    xj = jax_improve_chain(jh.qcqp_form, jnp.broadcast_to(
        jh.spectral_sol, (8, 10)), jqt.COORD_DESCENT, num_iters=20)
    _, fj, vj = jax_best_point(jh.qcqp_form, xj)
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-9)
    np.testing.assert_allclose(float(vt), float(vj), atol=1e-9)

    th.spectral_sol = x
    calls = []
    orig = trestarts.solve_spectral
    monkeypatch.setattr(trestarts, "solve_spectral",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    f, v = th.solve(8, suggest=tqt.SPECTRAL, improve=tqt.COORD_DESCENT,
                    num_iters=20)
    assert not calls
    np.testing.assert_allclose([f, v], [float(fj), float(vj)], rtol=1e-9,
                               atol=1e-9)
    tqt.solve_restarts(th.qcqp_form, 4, suggest=tqt.SPECTRAL, num_iters=2)
    assert calls == [1]                      # no handler: solved here


def test_spectral_cache_through_save_load_and_jax_state(tmp_path):
    """save_state / load_state carry spectral_sol and spectral_bound, and
    load_jax_state carries a JAX handler's spectral cache across."""
    h = tqt.QCQP(maxcut(tqt), device="cpu")
    h.suggest(tqt.SPECTRAL)
    path = str(tmp_path / "state")
    h.save_state(path)
    h2 = tqt.QCQP(maxcut(tqt), device="cpu")
    h2.load_state(path)
    assert torch.equal(h2.spectral_sol, h.spectral_sol)
    assert h2.spectral_bound == h.spectral_bound
    assert h2.suggest(tqt.SPECTRAL) == h.suggest(tqt.SPECTRAL)

    jh = jqt.QCQP(maxcut(jqt))
    jh.suggest(jqt.SPECTRAL)
    jpath = str(tmp_path / "jax_state")
    jh.save_state(jpath)
    h3 = tqt.QCQP(maxcut(tqt), device="cpu")
    load_jax_state(jpath, h3)
    assert h3.spectral_bound == jh.spectral_bound
    np.testing.assert_array_equal(h3.spectral_sol.numpy(),
                                  np.asarray(jh.spectral_sol))
    assert h3.suggest(tqt.SPECTRAL) == pytest.approx(
        jh.suggest(jqt.SPECTRAL), rel=1e-12)
