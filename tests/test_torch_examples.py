"""qcqp_tpu_torch.examples on the CPU in float64: each example's problem
built by both packages canonicalizes to the same form, and main() meets
the goldens of tests/test_api_examples.py and BASELINE.md; the boolean
least-squares and scenario-serving examples run here, the other three in
tests/test_torch_example_*.py (one each, for time).  Also the port of
the tests of tests/test_api_examples.py that had no counterpart among
the port's tests: the boolean-LS reference pipeline (on main()'s chain,
which is that test's chain), one host read per report, the IPOPT slot,
the infeasible relaxation raising through the handler, and every improve
on an unconstrained problem."""

import importlib
import os

import numpy as np
import pytest
import torch

import qcqp_tpu as jqt

import qcqp_tpu_torch as tqt
from qcqp_tpu_torch.examples import boolean_least_squares, scenario_serving

torch.set_num_threads(1)
EXAMPLES = ["boolean_least_squares", "maxcut", "circle_packing",
            "secondary_user_beamforming", "scenario_serving"]
GOLDEN_TOL = 2e-2


def _example(name):
    return importlib.import_module(f"qcqp_tpu_torch.examples.{name}")


def _pairs(out):
    return {k: v for k, v in out.items()
            if isinstance(v, tuple) and len(v) == 2 and k != "x_shape"}


@pytest.mark.parametrize("name", EXAMPLES)
def test_problem_canonicalizes_as_in_jax(name):
    """problem(qcqp_tpu_torch) and problem(qcqp_tpu) give the same
    (P, q, r, is_eq) to 1e-12 and the same sense."""
    mod = _example(name)
    tp, jp = mod.problem(tqt), mod.problem(jqt)
    if name != "scenario_serving":
        tp, jp = [tp], [jp]
    assert len(tp) == len(jp) >= 1
    for t, j in zip(tp, jp):
        tform, _, tmax = tqt.canonicalize(t, torch.float64, "cpu")
        jform, _, jmax = jqt.canonicalize(j)
        assert tmax == jmax
        for a, b in zip(tform, jform):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                       atol=1e-12)


@pytest.mark.parametrize("name", EXAMPLES)
def test_main_without_a_card_raises(name, monkeypatch):
    """main() defaults to the card and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        _example(name).main()


def test_boolean_ls_main_and_reference_pipeline(capsys):
    """The example's goldens (SDR bound 28.750, the best of 256 restarts
    35.550 at violation < 1e-2, both within 2e-2) and the checks of
    tests/test_api_examples.py::TestBooleanLS::test_full_reference_pipeline,
    whose chain main() runs: CD feasible at f <= 40, the cached SDR bound
    unchanged by the later suggests, DCCP at violation < 1e-4, CD after it
    and CD then ADMM(phase1=False) feasible, f <= 40; the variables hold
    the +-1 point the last report gave."""
    out = boolean_least_squares.main(device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6 and lines[0].startswith("Lower bound")
    h = out["qcqp"]
    assert out["device"] == "cpu" and out["dtype"] == "torch.float64"
    assert abs(out["sdr_bound"] - 28.750) <= GOLDEN_TOL
    assert h.sdr_bound == out["sdr_bound"]
    f, v = out["best_of_256"]
    assert v < 1e-2 and abs(f - 35.550) <= GOLDEN_TOL
    assert all(np.isfinite(x) for p in _pairs(out).values() for x in p)
    f_cd, v_cd = out["cd"]
    assert v_cd < 1e-2 and f_cd <= 40.0
    assert out["dccp"][1] < 1e-4
    assert out["dccp_cd"][1] < 1e-2
    f4, v4 = out["cd_admm"]
    assert v4 < 1e-2 and f4 <= 40.0
    x, = h.prob.variables()
    assert np.allclose(np.abs(np.asarray(x.value).ravel()), 1.0, atol=2e-2)


def test_scenario_serving_main(tmp_path, capsys):
    """The example's asserts (every scenario feasible, each objective at
    least its SDR bound - 1e-3), its printed lines, and the bank written
    into a temporary directory under `workdir` that is gone on return."""
    out = scenario_serving.main(workdir=str(tmp_path), device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("bank: 8 instances (n=12, m=12) -> "
                               + str(tmp_path))
    assert lines[-1].startswith("all scenarios feasible")
    assert out["x_shape"] == (8, 12) and out["dtype"] == "torch.float64"
    assert (out["best_viol"] < 1e-2).all()
    assert (out["best_f"] >= out["sdr_bounds"] - 1e-3).all()
    assert os.listdir(tmp_path) == []


def _boolean_ls_handler(**kw):
    return tqt.QCQP(boolean_least_squares.problem(tqt), device="cpu", **kw)


def test_report_is_one_host_read(monkeypatch):
    """tests/test_api_examples.py::TestBooleanLS::
    test_report_is_one_host_read: suggest and improve each read the
    device once from the api module, one (n + 2,) tensor (x, f and v).
    Here a read is a Tensor.cpu() call made from qcqp_tpu_torch/api.py."""
    import sys
    import qcqp_tpu_torch.api as api_mod
    q = _boolean_ls_handler()
    reads, real_cpu = [], torch.Tensor.cpu

    def spy(self, *a, **kw):
        if sys._getframe(1).f_code.co_filename == api_mod.__file__:
            reads.append(tuple(self.shape))
        return real_cpu(self, *a, **kw)
    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    q.suggest(tqt.RANDOM)
    assert reads == [(q.n + 2,)]
    reads.clear()
    q.improve(tqt.COORD_DESCENT)
    assert reads == [(q.n + 2,)]


def test_ipopt_slot():
    """tests/test_api_examples.py::TestBooleanLS::test_ipopt_slot."""
    q = _boolean_ls_handler()
    q.suggest(tqt.RANDOM)
    f, v = q.improve(tqt.IPOPT)
    assert v < 1e-4


def test_suggest_sdr_raises_infeasible():
    """tests/test_api_examples.py::TestInfeasibleProblems: contradictory
    equalities raise InfeasibleRelaxationError through the handler."""
    x = tqt.Variable(2)
    prob = tqt.Problem(tqt.Minimize(tqt.sum_squares(x)),
                       [tqt.square(x[0]) == 1, tqt.square(x[0]) == 4])
    q = tqt.QCQP(prob, check_dcp=False, device="cpu")
    with pytest.raises(tqt.InfeasibleRelaxationError):
        q.suggest(tqt.SDR)


def test_all_improves_handle_m_equals_zero():
    """tests/test_api_examples.py::TestUnconstrainedProblems: every
    improve on an unconstrained convex problem returns a finite objective
    at violation 0, and all but DCCP reach its minimum 0."""
    x = tqt.Variable(3)
    prob = tqt.Problem(tqt.Minimize(tqt.sum_squares(x - np.ones(3))), [])
    q = tqt.QCQP(prob, check_dcp=False, device="cpu")
    q.suggest(tqt.RANDOM)
    for meth in (tqt.COORD_DESCENT, tqt.ADMM, tqt.DCCP, tqt.IPOPT):
        f, v = q.improve(meth)
        assert np.isfinite(f) and v == 0.0
        assert f <= 1e-3 or meth == tqt.DCCP
