"""The SDR entry points of qcqp_tpu_torch.solvers.sdp against
qcqp_tpu.solvers.sdp on the CPU: the certificates and their errors,
check_status, the Farkas pre-check, the acceptance gates, solve_sdr and
solve_sdr_batch with its gate and float64 fallback.  The same numpy forms
go to both packages; tolerances as in tests/test_torch_sdp.py, whose form
builders this file shares."""

import functools
import logging
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qcqp_tpu import core as jcore
from qcqp_tpu.kernels import eigh_pallas
from qcqp_tpu.solvers import sdp as js

from qcqp_tpu_torch.convert import form_from_numpy
from qcqp_tpu_torch.core import QCQPForm
from qcqp_tpu_torch.solvers import sdp as ts

from .test_torch_sdp import boolean_ls, dense, forms, rel

torch.set_num_threads(1)


def _certificate_forms():
    n = 3
    P, q, r = np.zeros((3, n, n)), np.zeros((3, n)), np.zeros(3)
    q[1, 0] = q[2, 0] = 1.0
    r[2] = -1.0
    contradictory = (P, q, r, [True, True])
    P2, q2, r2 = np.zeros((2, n, n)), np.zeros((2, n)), np.zeros(2)
    P2[1, 0, 0] = 1.0
    r2[1] = 1.0
    cone = (P2, q2, r2, [True])
    P3, q3, r3 = np.zeros((2, n, n)), np.zeros((2, n)), np.zeros(2)
    P3[0] = -np.eye(n)
    q3[1, 0] = 1.0
    r3[1] = -100.0
    unbounded = (P3, q3, r3, [False])
    return contradictory, cone, unbounded


@pytest.mark.parametrize("case,err", [
    (0, ts.InfeasibleRelaxationError), (1, ts.InfeasibleRelaxationError),
    (2, ts.UnboundedRelaxationError)])
def test_certificates_raise_distinct_errors(case, err):
    """tests/test_sdp.py:183-246: contradictory equalities (Farkas at
    build time), a cone-infeasible row and an unbounded relaxation, with
    the same status and iteration count as the JAX solve."""
    arr = _certificate_forms()[case]
    jf, tf = forms(arr)
    st = ts.solve_sdr(tf, max_iters=20000, check=False, full=True)
    with pytest.raises(err):
        ts.check_status(st, 1e-8)        # as solve_sdr(check=True) does
    sj = js.solve_sdr(jf, max_iters=20000, check=False, full=True)
    assert int(st.status_code) == int(sj.status_code) != ts.STATUS_OK
    if case < 2:
        assert int(st.iterations) == int(sj.iterations) <= 500
    else:
        # the recession direction grows without bound, so which check
        # interval confirms it is up to rounding
        assert int(st.iterations) <= 2000


def test_check_status(caplog):
    one = lambda rp, rd, code=ts.STATUS_OK: ts.SDPSolution(  # noqa: E731
        None, None, torch.tensor(7), torch.tensor(rp), torch.tensor(rd),
        None, torch.tensor(code))
    assert ts.check_status(one(1e-9, 1e-9), 1e-8) == "optimal"
    with caplog.at_level(logging.WARNING, logger="qcqp_tpu_torch"):
        assert ts.check_status(one(5e-5, 1e-9), 1e-8) == \
            "optimal_inaccurate"
    assert "inaccurately" in caplog.text
    with pytest.raises(RuntimeError, match="not converged"):
        ts.check_status(one(1e-3, 1e-9), 1e-8)
    with pytest.raises(ts.InfeasibleRelaxationError):
        ts.check_status(one(1e-9, 1e-9, ts.STATUS_INFEASIBLE), 1e-8)
    with pytest.raises(ts.UnboundedRelaxationError):
        ts.check_status(one(1e-9, 1e-9, ts.STATUS_UNBOUNDED), 1e-8)


def test_affine_farkas_precheck():
    """tests/test_sdp.py:278-301, in float32 forms, with the pseudo-
    inverse's division masked: no divide-by-zero warning."""
    contradictory = _certificate_forms()[0]
    bad = form_from_numpy(*contradictory, device="cpu", dtype=torch.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert ts._affine_farkas_infeasible(bad)
        P, q, r, eq = contradictory
        r_ok = r.copy()
        r_ok[2] = 0.0                 # both rows say x0 == 0
        ok = form_from_numpy(P, q, r_ok, eq, device="cpu",
                             dtype=torch.float32)
        assert not ts._affine_farkas_infeasible(ok)
        assert not ts._affine_farkas_infeasible(
            form_from_numpy(*boolean_ls(8, 12, 3), device="cpu"))


def test_rel_viol_gates_match_jax():
    jf, tf = forms(boolean_ls(8, 12, 3))
    Xt, _ = ts.solve_sdr(tf, max_iters=20000, tol=1e-9)
    assert ts._unscaled_rel_viol(tf, Xt) < 1e-6
    bad = np.eye(9) * 3.0
    bad[-1, -1] = 1.0
    for X in (Xt.numpy(), bad):
        assert abs(ts._unscaled_rel_viol(tf, torch.from_numpy(X))
                   - js._unscaled_rel_viol(jf, jnp.asarray(X))) < 1e-12
    assert ts._unscaled_rel_viol(tf, torch.from_numpy(bad)) > \
        ts._UNSCALED_VIOL_TOL


def test_solve_sdr_matches_jax():
    jf, tf = forms(boolean_ls(6, 9, 5))
    st = ts.solve_sdr(tf, max_iters=20000, tol=1e-9, full=True)
    sj = js.solve_sdr(jf, max_iters=20000, tol=1e-9, full=True)
    assert rel(st.objective, sj.objective) < 1e-8
    assert rel(st.X, sj.X) < 1e-6
    assert int(st.iterations) == int(sj.iterations)


def test_sdr_batch_gate_and_fallback_match_jax(caplog):
    """tests/test_sdp.py:348-370 against the vmapped JAX batch: a
    10-iteration budget converges nothing, so every instance is re-solved
    in float64 (logged and counted) and matches the single solve."""
    arrays = [boolean_ls(6, 8, s) for s in (0, 1, 2)]
    stack = [np.stack([a[i] for a in arrays]) for i in range(4)]
    tstack = QCQPForm(*(torch.from_numpy(a) for a in stack))
    jstack = jcore.QCQPForm(*(jnp.asarray(a) for a in stack))
    before = ts.solve_sdr_batch.fallbacks
    with caplog.at_level(logging.INFO, logger="qcqp_tpu_torch"):
        X, obj, rp, rd, acc = ts.solve_sdr_batch(tstack, max_iters=10,
                                                 return_accept=True)
    assert ts.solve_sdr_batch.fallbacks == before + 3
    assert caplog.text.count("re-solving in float64") == 3
    Xj, objj, rpj, rdj, accj = js.solve_sdr_batch(jstack, max_iters=10,
                                                  return_accept=True)
    assert acc.all() and accj.all()
    assert float(torch.maximum(rp, rd).max()) <= ts._INACC_TOL
    assert rel(obj, objj) < 1e-6
    X2, o2, rp2, rd2 = ts.solve_sdr_batch(tstack, max_iters=10, gate=None)
    assert float(rp2.max()) > ts._INACC_TOL
    _, _, rp2j, _ = js.solve_sdr_batch(jstack, max_iters=10, gate=None)
    assert rel(rp2, rp2j) < 1e-9


def test_sdr_batch_float32_vec_route(monkeypatch):
    """solve_sdr_batch(psd_method="vec") in float32 against the vmapped
    JAX batch at a fixed budget, ungated."""
    monkeypatch.setattr(eigh_pallas, "eigh_jacobi_vec", functools.partial(
        eigh_pallas.eigh_jacobi_vec, interpret=True))
    arrays = [dense(seed=s) for s in (3, 4)]
    stack = [np.stack([a[i] for a in arrays]) for i in range(4)]
    tstack = QCQPForm(*(torch.from_numpy(a.astype(np.float32))
                        if a.dtype != bool else torch.from_numpy(a)
                        for a in stack))
    jstack = jcore.QCQPForm(*(jnp.asarray(a, jnp.float32) for a in
                              stack[:3]), jnp.asarray(stack[3]))
    Xt, ot, rpt, rdt = ts.solve_sdr_batch(tstack, max_iters=10,
                                          psd_method="vec", gate=None)
    Xj, oj, rpj, rdj = js.solve_sdr_batch(jstack, max_iters=10,
                                          psd_method="vec", gate=None)
    Xn = np.abs(np.asarray(Xj)).max()
    assert rel(Xt, Xj) < 1e-4
    assert np.abs(rpt.numpy() - np.asarray(rpj)).max() < 1e-4 * Xn
    assert np.abs(rdt.numpy() - np.asarray(rdj)).max() < 1e-4 * Xn
